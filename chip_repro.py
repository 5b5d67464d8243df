"""Where does the base video vary between processes on the card?

    python3 chip_repro.py [PAIR ...]   # on a machine with a card; all pairs by default

Runs the full-width base stage (TextToVideoPipeline.init_random(seed=0),
16x320x512, CFG 7.5, DDPM, seed 400) in fresh processes with the same code
and seeds, in pairs:
  sequential     one process after the other
  concurrent     two processes on the card at once
  deterministic  one after the other, torch.backends.cudnn.deterministic set
  flash          one after the other, PyTorch's attention operator held to
                 its FlashAttention and memory-efficient backends
                 (torch.nn.attention.sdpa_kernel; FlashAttention takes no
                 head dim above 256, the VAE's mid attention has 512)
Each process first runs HASHED_STEPS denoising steps with every module of
the UNet, the VAE and the text encoder hooked (a checksum of each module's
first input and of its output, in call order) and every kernel wrapper and
the attention operator wrapped the same way; then the VAE decode of those
latents, hooked; then, unhooked, a whole STEPS-step video, of which it
reports the md5. The checksum reads a tensor's bits as integers on the
card, so one flipped bit changes it. The parent prints, per pair, the md5s,
the first hooked call whose checksum differs (module path and class,
input or output, step): the first op that varies, and how far the two
whole videos lie apart (largest uint8 difference, share of differing
values). One JSON line per pair, then the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODES = ("default", "deterministic", "flash")
HASHED_STEPS = 3
STEPS = 50
PROMPT = "a teddy bear walking on the street, 2k, high quality"


class Tracer:
    """Checksums of tensors on the card, in call order."""

    def __init__(self):
        self.names, self.sums, self.weights = [], [], {}

    def digest(self, x: torch.Tensor) -> torch.Tensor:
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        v = x.detach().contiguous().view(-1).view(ints).to(torch.int64)
        n = v.numel()
        if n not in self.weights:
            self.weights[n] = torch.arange(n, device=v.device, dtype=torch.int64) % 65521 + 1
        return torch.stack([v.sum(), (v * self.weights[n]).sum()])

    def record(self, name: str, x) -> None:
        if isinstance(x, (tuple, list)):
            x = next((t for t in x if isinstance(t, torch.Tensor)), None)
        if isinstance(x, torch.Tensor) and x.is_cuda:
            self.names.append(name)
            self.sums.append(self.digest(x))

    def flush(self) -> list:
        sums = torch.stack(self.sums).cpu().tolist() if self.sums else []
        out = [[n, s] for n, s in zip(self.names, sums)]
        self.names, self.sums = [], []
        return out


def hook(tracer: Tracer, root: str, module: torch.nn.Module) -> list:
    handles = []
    for name, m in module.named_modules():
        label = f"{root}.{name}" if name else root
        label = f"{label} ({type(m).__name__})"
        handles.append(m.register_forward_pre_hook(
            lambda mod, args, label=label: tracer.record(label + " in", args)))
        handles.append(m.register_forward_hook(
            lambda mod, args, out, label=label: tracer.record(label + " out", out)))
    return handles


def wrap_functions(tracer: Tracer) -> list:
    """Wrap each kernel entry the base path calls, and the attention
    operator, so their outputs are checksummed too; returns the undo list."""
    import lavie_tpu_torch.kernels.attention as dpa_mod
    import lavie_tpu_torch.nn.attention as attn_mod
    import lavie_tpu_torch.nn.transformer as tr_mod

    saved = []
    for mod, name in ((attn_mod, "temporal_attention"), (tr_mod, "geglu"),
                      (dpa_mod.F, "scaled_dot_product_attention")):
        fn = getattr(mod, name)

        def wrapped(*args, fn=fn, name=name, **kwargs):
            out = fn(*args, **kwargs)
            tracer.record(f"{name}() out", out)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    return saved


def worker(out_path: str, mode: str) -> None:
    import contextlib

    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = mode == "deterministic"
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    with sdpa_kernel(backends) if mode == "flash" else contextlib.nullcontext():
        _worker(out_path, mode)


def _worker(out_path: str, mode: str) -> None:
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    pipe = TextToVideoPipeline.init_random(seed=0)
    tracer = Tracer()
    handles = (hook(tracer, "unet", pipe.unet) + hook(tracer, "vae", pipe.vae)
               + hook(tracer, "text_encoder", pipe.text_encoder))
    saved = wrap_functions(tracer)
    steps = []
    # each UNet forward is one step's record: flush after every forward
    step_hook = pipe.unet.register_forward_hook(lambda *a: steps.append(tracer.flush()))
    out = pipe(PROMPT, num_inference_steps=HASHED_STEPS, guidance_scale=7.5, sample_method="ddpm",
               seed=400)
    decode = tracer.flush()  # the VAE decode after the last forward
    step_hook.remove()
    for h in handles:
        h.remove()
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    torch.cuda.synchronize()
    t0 = time.time()
    video = pipe(PROMPT, num_inference_steps=STEPS, guidance_scale=7.5, sample_method="ddpm",
                 seed=400).video
    secs = time.time() - t0
    np.save(out_path + ".npy", video)
    with open(out_path, "w") as f:
        json.dump({"steps": steps, "decode": decode, "seconds": secs,
                   "hashed_md5": hashlib.md5(out.video.tobytes()).hexdigest(),
                   "md5": hashlib.md5(video.tobytes()).hexdigest(),
                   "cudnn": torch.backends.cudnn.version(), "torch": torch.__version__,
                   "mode": mode}, f)


def first_difference(a: dict, b: dict):
    """(where, step, record index, name) of the first record whose checksum
    differs, or None."""
    seqs = [(f"step {i}", x, y) for i, (x, y) in enumerate(zip(a["steps"], b["steps"]))]
    seqs.append(("decode", a["decode"], b["decode"]))
    for where, x, y in seqs:
        if len(x) != len(y):
            return {"where": where, "error": f"{len(x)} records against {len(y)}"}
        for i, ((na, sa), (nb, sb)) in enumerate(zip(x, y)):
            if na != nb:
                return {"where": where, "index": i, "error": f"call order {na} / {nb}"}
            if sa != sb:
                differing = sum(r[1] != s[1] for r, s in zip(x, y))
                return {"where": where, "index": i, "name": na, "previous": x[i - 1][0] if i else None,
                        "differing_records": differing, "records": len(x)}
    return None


def spawn(out_path: str, mode: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", out_path, mode])


def run_pair(label: str, tmp: str, concurrent: bool, mode: str) -> dict:
    paths = [os.path.join(tmp, f"{label}_{i}.json") for i in range(2)]
    if concurrent:
        procs = [spawn(p, mode) for p in paths]
        codes = [p.wait(timeout=900) for p in procs]
    else:
        codes = [spawn(p, mode).wait(timeout=900) for p in paths]
    if any(codes):
        raise RuntimeError(f"{label}: worker exit codes {codes}")
    a, b = (json.load(open(p)) for p in paths)
    va, vb = (np.load(p + ".npy").astype(np.int16) for p in paths)
    diff = np.abs(va - vb)
    row = {"pair": label, "md5": [a["md5"], b["md5"]], "hashed_md5": [a["hashed_md5"], b["hashed_md5"]],
           "video_max_abs_diff": int(diff.max()), "video_differing_share": float((diff > 0).mean()),
           "seconds": [a["seconds"], b["seconds"]], "cudnn": a["cudnn"], "torch": a["torch"],
           "records_per_step": len(a["steps"][0]), "first_difference": first_difference(a, b)}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_repro: no CUDA device", file=sys.stderr)
        return 1
    from lavie_tpu_torch.kernels import _build

    _build.build(["temporal_fused", "geglu"])  # once, before the workers load it
    pairs = {"sequential": (False, "default"), "concurrent": (True, "default"),
             "deterministic": (False, "deterministic"), "flash": (False, "flash")}
    names = sys.argv[1:] or list(pairs)
    with tempfile.TemporaryDirectory() as tmp:
        rows = [run_pair(name, tmp, *pairs[name]) for name in names]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"pairs_equal": [r["first_difference"] is None for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker" and sys.argv[3] in MODES:
        worker(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
