"""Smoke run of the PyTorch port on one NVIDIA card: python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its result line:
  1. device   the card's name and power limit (nvidia-smi)
  2. build    both CUDA kernels from lavie_tpu_torch/csrc, one nvcc each,
              started together
  3. kernels  each kernel at every base-path shape against its plain PyTorch
              version in bf16 (tolerance relative to max|plain|), timed with
              CUDA events beside the plain version and, for the temporal
              attention, F.scaled_dot_product_attention with the bias as a
              float mask (a yardstick only: the port never calls it)
  4. model    one full-width UNet3D forward (2x16x40x64 latents, every
              parameter random, temporal out-projections included) with the
              kernels and with the plain versions; relative error
  5. main     TextToVideoPipeline at full width answers two prompts: 16 frames
              of 320x512, 50 DDPM steps, CFG 7.5; launch counts are zeroed
              just before and read just after
  6. profile  one CFG-batched UNet forward under torch.profiler: device time
              by kernel group and the device's busy share of the wall time
  7. result   a `kernels` JSON line, then the `ok` JSON line last
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core bf16
FP32_FLOPS = 67e12  # fp32 outside the tensor cores

TEMPORAL_SHAPES = [(2560, 40), (640, 80), (160, 160), (40, 160)]  # (S, head_dim), B=2 F=16 H=8
GEGLU_SHAPES = [(81920, 320), (20480, 640), (5120, 1280), (1280, 1280)]  # (N, C)
TEMPORAL_TOL, GEGLU_TOL, MODEL_TOL = 1e-2, 2e-2, 1e-1  # of max|plain|


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(line)
    return line


def phase_build() -> None:
    from lavie_tpu_torch.kernels import _build

    t0 = time.time()
    logs = _build.build(["temporal_fused", "geglu"])
    for name, text in logs.items():
        regs = [ln.split("ptxas info    : ")[-1] for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {'; '.join(regs)}")
    log(f"[build] {time.time() - t0:.1f} s")


def phase_temporal() -> list:
    from lavie_tpu_torch.kernels.temporal_fused import (
        temporal_attention,
        temporal_attention_reference,
    )
    from lavie_tpu_torch.nn.embeddings import apply_rope_half, rope_half_frequencies

    g = torch.Generator(device="cuda").manual_seed(1)
    b, f, h, rope = 2, 16, 8, 32
    rows = []
    for s, d in TEMPORAL_SHAPES:
        c = h * d
        q, k, v = (torch.randn(b, f, s, c, generator=g, device="cuda").bfloat16() for _ in range(3))
        bias = 0.5 * torch.randn(h, f, f, generator=g, device="cuda")
        cos, sin = (torch.from_numpy(a).cuda() for a in rope_half_frequencies(f, rope))
        args = (q, k, v, bias, cos, sin, d**-0.5, rope, h)
        out = temporal_attention(*args)
        ref = temporal_attention_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        # yardstick: one library call on (B·S, H, F, d) tensors, RoPE done beforehand
        cs, sn = cos.bfloat16()[:, None, None, :], sin.bfloat16()[:, None, None, :]
        to_bhsd = lambda x: x.view(b, f, s, h, d).permute(0, 2, 3, 1, 4).reshape(b * s, h, f, d)  # noqa: E731
        qs = to_bhsd(apply_rope_half(q.view(b, f, s, h, d), cs, sn)).contiguous()
        ks = to_bhsd(apply_rope_half(k.view(b, f, s, h, d), cs, sn)).contiguous()
        vs = to_bhsd(v).contiguous()
        mask = bias.bfloat16()
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=mask, scale=d**-0.5)
        n_bytes = 4 * b * f * s * c * 2 + h * f * f * 4 + 2 * f * (rope // 2) * 4
        n_flops = 4 * b * s * h * f * f * d
        bound = max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS) * 1e3
        row = {
            "kernel": "temporal_attention", "shape": {"B": b, "F": f, "S": s, "H": h, "d": d},
            "max_abs_err": err, "max_abs_ref": scale,
            "ms": time_ms(lambda: temporal_attention(*args)),
            "plain_ms": time_ms(lambda: temporal_attention_reference(*args), iters=5),
            "library_ms": time_ms(lib),
            "bound_ms": bound,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_flops / FP32_FLOPS else "operations",
        }
        log(json.dumps(row))
        if not err <= TEMPORAL_TOL * scale:
            raise AssertionError(f"temporal_attention S={s} d={d}: err {err} > {TEMPORAL_TOL}·{scale}")
        rows.append(row)
    return rows


def phase_geglu() -> list:
    from lavie_tpu_torch.kernels.geglu import geglu, geglu_reference

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for n, c in GEGLU_SHAPES:
        inner = 4 * c
        r = lambda *shape, s=1.0: (torch.randn(*shape, generator=g, device="cuda") * s).bfloat16()  # noqa: E731
        x, w0, b0 = r(n, c), r(2 * inner, c, s=c**-0.5), r(2 * inner, s=0.1)
        w2, b2 = r(c, inner, s=inner**-0.5), r(c, s=0.1)
        args = (x, w0, b0, w2, b2)
        out, ref = geglu(*args), geglu_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        n_bytes = (2 * n * c + 3 * inner * c + 2 * inner + c) * 2
        n_flops = 6 * n * c * inner
        bound = max(n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS) * 1e3
        row = {
            "kernel": "geglu", "shape": {"N": n, "C": c, "I": inner},
            "max_abs_err": err, "max_abs_ref": scale,
            "ms": time_ms(lambda: geglu(*args)),
            "plain_ms": time_ms(lambda: geglu_reference(*args)),
            "library_ms": None,
            "bound_ms": bound,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_flops / BF16_FLOPS else "operations",
        }
        log(json.dumps(row))
        if not err <= GEGLU_TOL * scale:
            raise AssertionError(f"geglu N={n} C={c}: err {err} > {GEGLU_TOL}·{scale}")
        rows.append(row)
    return rows


def phase_model() -> None:
    """Full-width UNet3D forward, kernels vs plain versions, same weights."""
    import lavie_tpu_torch.nn.attention as attn_mod
    import lavie_tpu_torch.nn.transformer as tr_mod
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.kernels.geglu import geglu_reference
    from lavie_tpu_torch.kernels.temporal_fused import temporal_attention_reference
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        unet = UNet3D(UNetConfig.base_t2v()).to(torch.bfloat16).eval()
    random_init_(unet, seed=7)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 16, 40, 64, 4, generator=g, device="cuda")
    ts = torch.tensor([981.0, 981.0], device="cuda")
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        got = unet(x, ts, ctx).float()
        torch.cuda.synchronize()
        t_kernels = time.time() - t0
        kernels = (attn_mod.temporal_attention, tr_mod.geglu)
        attn_mod.temporal_attention, tr_mod.geglu = temporal_attention_reference, geglu_reference
        try:
            want = unet(x, ts, ctx).float()
        finally:
            attn_mod.temporal_attention, tr_mod.geglu = kernels
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel_mean = ((got - want).abs().mean() / want.abs().mean()).item()
    log(json.dumps({"phase": "model", "max_abs_err": err, "max_abs_ref": scale,
                    "mean_rel_err": rel_mean, "finite": bool(torch.isfinite(got).all()),
                    "first_forward_s": t_kernels}))
    if not (torch.isfinite(got).all() and err <= MODEL_TOL * scale):
        raise AssertionError(f"UNet3D kernels vs plain: err {err} > {MODEL_TOL}·{scale}")
    del unet
    torch.cuda.empty_cache()


KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names), first match wins
    ("temporal_attention", ("temporal_attention_kernel",)),
    ("geglu", ("geglu_kernel",)),
    ("attention (SDPA)", ("flash", "fmha", "attention", "softmax")),
    ("convolution", ("conv", "implicit", "winograd", "dgrad", "wgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("norm and elementwise", ("",)),
)


def phase_profile(unet) -> None:
    """Device time of one CFG-batched UNet forward, by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 16, 40, 64, 4, generator=g, device="cuda")
    ts = torch.full((2,), 500.0, device="cuda")
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda")
    with torch.no_grad():
        unet(x, ts, ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            unet(x, ts, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    top = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0 or e.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            continue
        top.append((us / 1e3, e.key[:80], e.count))
        name = e.key.lower()
        group = next(g_ for g_, subs in KERNEL_GROUPS if any(s_ in name for s_ in subs))
        groups[group] += us / 1e3
    busy = sum(groups.values())
    top.sort(reverse=True)
    log(json.dumps({
        "phase": "profile", "wall_ms": wall_ms,
        "device_ms": busy if busy > 0 else "not measured",
        "busy_share": busy / wall_ms if busy > 0 else "not measured",
        "groups_ms": groups,
        "top_kernels": [{"ms": ms, "name": k, "calls": n} for ms, k, n in top[:12]],
    }))


def phase_main() -> dict:
    from lavie_tpu_torch.kernels.geglu import geglu
    from lavie_tpu_torch.kernels.temporal_fused import temporal_attention
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    t0 = time.time()
    pipe = TextToVideoPipeline.init_random(seed=0)  # full width, bf16, on the card
    torch.cuda.synchronize()
    log(f"[main] init {time.time() - t0:.1f} s")
    prompts = ["a teddy bear walking on the street, 2k, high quality",
               "a panda playing the guitar by a lake"]
    steps = 50
    temporal_attention.launches = 0
    geglu.launches = 0
    for prompt in prompts:
        torch.cuda.synchronize()
        t0 = time.time()
        out = pipe(prompt, num_inference_steps=steps, guidance_scale=7.5, sample_method="ddpm", seed=400)
        torch.cuda.synchronize()
        secs = time.time() - t0
        video = out.video
        ok = (video.shape == (1, 16, 320, 512, 3) and video.dtype.name == "uint8"
              and bool(torch.isfinite(out.latents).all()))
        log(json.dumps({"phase": "main", "prompt": prompt, "seconds": secs, "s_per_step": secs / steps,
                        "frames_per_s": 16 / secs, "shape": list(video.shape),
                        "dtype": video.dtype.name, "latents_finite": ok,
                        "video_mean": float(video.mean()), "video_std": float(video.std())}))
        if not ok:
            raise AssertionError(f"bad output for {prompt!r}: {video.shape} {video.dtype}")
    launches = {"temporal_attention": temporal_attention.launches, "geglu": geglu.launches}
    log(json.dumps({"phase": "main", "launches": launches,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    phase_profile(pipe.unet)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    phase_device()
    phase_build()
    temporal_rows = phase_temporal()
    geglu_rows = phase_geglu()
    phase_model()
    launches = phase_main()

    def entry(name, source, replaces, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    # the line's per-kernel numbers are those of the base L0 shape (first row)
    log(json.dumps({"kernels": [
        entry("temporal_attention", "lavie_tpu_torch/csrc/temporal_fused.cu",
              "lavie_tpu/kernels/temporal_fused.py:446", temporal_rows[0]),
        entry("geglu", "lavie_tpu_torch/csrc/geglu.cu", "lavie_tpu/kernels/geglu.py:85", geglu_rows[0]),
    ]}))
    log(f"[chip_smoke] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
