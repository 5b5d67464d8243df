"""CLIP BPE tokenizer (a copy of lavie_tpu.io.tokenizer, which the port must
not import).

The reference uses transformers' CLIPTokenizer with the SD-1.4 vocab files
(reference: base/pipelines/sample.py:31). This is the same byte-pair-encoding
algorithm implemented natively: it loads `vocab.json` + `merges.txt` when a
path is given. Without vocab files (e.g. weight-free testing in this
offline environment) it falls back to a deterministic hash tokenizer that
preserves the (B, 77) int32 contract.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CLIPTokenizer:
    """CLIP BPE with the standard padding contract: [BOS] tokens [EOS] pad-to-77
    (CLIP pads with EOS per the original implementation)."""

    try:
        import regex as _regex

        PAT = _regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            _regex.IGNORECASE,
        )
    except ImportError:  # ASCII approximation
        PAT = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        merges_path: Optional[str] = None,
        max_length: int = 77,
        vocab_size: int = 49408,
    ):
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        self._fallback = vocab_path is None or not os.path.exists(vocab_path)
        if not self._fallback:
            with open(vocab_path) as f:
                self.encoder: Dict[str, int] = json.load(f)
            merges: List[str] = []
            if merges_path and os.path.exists(merges_path):
                opener = gzip.open if merges_path.endswith(".gz") else open
                with opener(merges_path, "rt", encoding="utf-8") as f:
                    merges = f.read().split("\n")
                # first line is a version header in HF merges.txt
                if merges and merges[0].startswith("#"):
                    merges = merges[1:]
                merges = [m for m in merges if m]
            self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
            self.bos_id = self.encoder.get("<|startoftext|>", 49406)
            self.eos_id = self.encoder.get("<|endoftext|>", 49407)
            self.cache: Dict[str, str] = {}
        else:
            # fallback ids scale with the model's vocab (CLIP convention:
            # BOS/EOS are the last two ids)
            self.vocab_size = vocab_size
            self.bos_id = vocab_size - 2
            self.eos_id = vocab_size - 1

    # -- BPE ---------------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _encode_text(self, text: str) -> List[int]:
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in self.PAT.findall(text):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self.bpe(token_bytes).split(" "):
                ids.append(self.encoder.get(bpe_token, self.eos_id))
        return ids

    def _encode_fallback(self, text: str) -> List[int]:
        """Deterministic hash tokenizer: keeps the id range and shape contract
        without vocab files (weight-free environments)."""
        words = whitespace_clean(text).lower().split(" ")
        ids = []
        for w in words:
            if not w:
                continue
            h = int(hashlib.sha256(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 3) + 1)  # avoid 0/BOS/EOS
        return ids

    # -- public API ---------------------------------------------------------

    def __call__(self, texts, padding: str = "max_length") -> np.ndarray:
        """texts: str or list[str] → (B, max_length) int32, BOS ... EOS pads."""
        if isinstance(texts, str):
            texts = [texts]
        batch = np.full((len(texts), self.max_length), self.eos_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self._encode_fallback(t) if self._fallback else self._encode_text(t)
            ids = [self.bos_id] + ids[: self.max_length - 2] + [self.eos_id]
            batch[i, : len(ids)] = np.asarray(ids, dtype=np.int32)
        return batch
