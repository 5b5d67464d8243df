"""MappingNetwork (port of lavie_tpu.nn.mapping): CLIP image tokens → the
CLIP text-embedding space, the fork's image-conditioning head (reference:
base/pipelines/mapping.py:61-97).

The ViT-L vision tower's last_hidden_state (B, 257, 1024) is projected to
768 wide, given learned positions, and read by a 12-layer decoder whose
queries are the text states (B, 77, 768) plus their own learned positions:
(B, 77, 768) states that the pipeline concatenates onto the text
conditioning. The layers are torch.nn.TransformerDecoderLayer's semantics
(post-norm: self-attention, cross-attention, a 2048-wide ReLU FFN, all with
biases), written out so that the parameter names are the JAX package's
(`q_proj`, `k_proj`, `v_proj`, `out_proj`, `norm1..3`, `linear1/2`):
nn.TransformerDecoderLayer packs `in_proj_weight`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.nn.clip import _layer_norm


class _MHA(nn.Module):
    """torch.nn.MultiheadAttention's function with four biased projections;
    the scores are accumulated in fp32 and the probabilities cast back to
    the values' dtype, as the JAX module's einsums do."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        b, sq, c = query.shape
        d = c // self.heads
        q = self.q_proj(query).view(b, sq, self.heads, d).transpose(1, 2)
        k = self.k_proj(key).view(b, -1, self.heads, d).transpose(1, 2)
        v = self.v_proj(value).view(b, -1, self.heads, d).transpose(1, 2)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return self.out_proj(torch.matmul(p, v).transpose(1, 2).reshape(b, sq, c))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = _MHA(dim, heads)
        self.multihead_attn = _MHA(dim, heads)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-5) for _ in range(3))
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(self.norm1, tgt + self.self_attn(tgt, tgt, tgt))
        x = _layer_norm(self.norm2, x + self.multihead_attn(x, memory, memory))
        return _layer_norm(self.norm3, x + self.linear2(F.relu(self.linear1(x))))


class MappingNetwork(nn.Module):
    """(image tokens (B, seq_len_in, input_dim), text states (B, seq_len_out,
    output_dim)) → (B, seq_len_out, output_dim)."""

    def __init__(self, input_dim: int = 1024, output_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, seq_len_in: int = 257, seq_len_out: int = 77,
                 ffn_dim: int = 2048):
        super().__init__()
        self.image_proj = nn.Linear(input_dim, output_dim)
        self.image_pos_embedding = nn.Parameter(torch.randn(1, seq_len_in, output_dim))
        self.text_pos_embedding = nn.Parameter(torch.randn(1, seq_len_out, output_dim))
        self.layers = nn.ModuleList([TransformerDecoderLayer(output_dim, num_heads, ffn_dim)
                                     for _ in range(num_layers)])

    def forward(self, image_embeds: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
        mem = self.image_proj(image_embeds)
        mem = mem + self.image_pos_embedding.to(mem.dtype)
        x = text_embeds + self.text_pos_embedding.to(text_embeds.dtype)
        for layer in self.layers:
            x = layer(x, mem)
        return x
