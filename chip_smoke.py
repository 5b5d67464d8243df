"""Smoke run of the PyTorch port on one NVIDIA card: python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its result line:
  1. device     the card's name and power limit (nvidia-smi)
  2. build      every CUDA kernel from lavie_tpu_torch/csrc, one nvcc each,
                started together
  3. kernels    each kernel at every base-path and TSR-path shape against its
                plain PyTorch version in bf16 (tolerance relative to
                max|plain|), timed with CUDA events beside the plain version
                and, where one PyTorch call computes the same function,
                F.scaled_dot_product_attention (a yardstick only: the port
                never calls it); the explicit-kv flash entry runs here only
  4. model      one full-width base UNet3D forward (2x16x40x64 latents, every
                parameter random, temporal out-projections included) with the
                kernels and with the plain versions; relative error
  5. model_tsr  the same for the full-width TSR UNet (2x61x40x64x8 inputs)
  6. main       TextToVideoPipeline at full width answers two prompts: 16
                frames of 320x512, 50 DDPM steps, CFG 7.5
  7. profile    one CFG-batched base UNet forward under torch.profiler:
                device time by kernel group and the device's busy share
  8. tsr        VideoInterpolationPipeline at full width interpolates the
                first main-phase video to 61 frames: 50 DDIM steps, CFG 4.0
  9. profile_tsr  the same profile for one CFG-batched TSR UNet forward
 10. result     a `kernels` JSON line, then the `ok` JSON line last
Launch counts are zeroed just before each path (main, tsr) and read just
after it. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core bf16
FP32_FLOPS = 67e12  # fp32 outside the tensor cores

# (S, head_dim) at B=2, H=8; F=16 on the base path, 61 on the TSR path
ATTENTION_LEVELS = [(2560, 40), (640, 80), (160, 160), (40, 160)]
GEGLU_WIDTHS = [320, 640, 1280, 1280]  # C at the same levels
TSR_FRAMES, TSR_ROWS = 61, 2 * 61  # B·F frame rows at CFG batch 2
TEMPORAL_TOL, GEGLU_TOL, FLASH_TOL = 1e-2, 2e-2, 1e-2  # of max|plain|
# whole-UNet kernels vs plain, of max|plain|: base seen at 0.014, TSR at 0.0185
MODEL_TOL = {"model": 1e-1, "model_tsr": 4e-2}
TSR_STEPS = 50


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


def bound(n_bytes: float, ops):
    """(least ms the card could take, what bounds it); ops: (flops, peak
    rate for their operands' type) pairs, whose times add."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, sum(n / rate for n, rate in ops)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_row(kernel: str, shape: dict, out, ref, tol: float, fn, plain, library,
              n_bytes: float, ops, plain_iters: int = 5) -> dict:
    """Compare a kernel's output with its plain version's, time the kernel,
    the plain version and the library yardstick (None: no single call)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    bound_ms, bound_by = bound(n_bytes, ops)
    row = {
        "kernel": kernel, "shape": shape, "max_abs_err": err, "max_abs_ref": scale,
        "ms": time_ms(fn), "plain_ms": time_ms(plain, iters=plain_iters),
        "library_ms": time_ms(library) if library is not None else None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(json.dumps(row))
    if not err <= tol * scale:
        raise AssertionError(f"{kernel} {shape}: err {err} > {tol}·{scale}")
    return row


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
    logs = _build.build(["temporal_fused", "geglu", "flash_attention"])
    for name, text in logs.items():
        regs = [ln.split("ptxas info    : ")[-1] for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {'; '.join(regs)}")
    log(f"[build] {time.time() - t0:.1f} s")


def phase_temporal(f: int, rope: int) -> list:
    """Temporal attention at B=2, H=8: the base path's F=16 with RoPE and a
    bias, the TSR path's F=61 with neither."""
    from lavie_tpu_torch.kernels.temporal_fused import (
        temporal_attention,
        temporal_attention_reference,
    )
    from lavie_tpu_torch.nn.embeddings import apply_rope_half, rope_half_frequencies

    g = torch.Generator(device="cuda").manual_seed(1)
    b, h = 2, 8
    rows = []
    for s, d in ATTENTION_LEVELS:
        c = h * d
        q, k, v = (torch.randn(b, f, s, c, generator=g, device="cuda").bfloat16() for _ in range(3))
        bias = cos = sin = None
        if rope:
            bias = 0.5 * torch.randn(h, f, f, generator=g, device="cuda")
            cos, sin = (torch.from_numpy(a).cuda() for a in rope_half_frequencies(f, rope))
        args = (q, k, v, bias, cos, sin, d**-0.5, rope, h)
        # yardstick: one library call on (B·S, H, F, d) tensors, RoPE done beforehand
        to_bhsd = lambda x: x.view(b, f, s, h, d).permute(0, 2, 3, 1, 4).reshape(b * s, h, f, d)  # noqa: E731
        if rope:
            cs, sn = cos.bfloat16()[:, None, None, :], sin.bfloat16()[:, None, None, :]
            qs = to_bhsd(apply_rope_half(q.view(b, f, s, h, d), cs, sn)).contiguous()
            ks = to_bhsd(apply_rope_half(k.view(b, f, s, h, d), cs, sn)).contiguous()
        else:
            qs, ks = to_bhsd(q).contiguous(), to_bhsd(k).contiguous()
        vs = to_bhsd(v).contiguous()
        mask = bias.bfloat16() if rope else None
        n_bytes = 4 * b * f * s * c * 2 + (h * f * f * 4 + 2 * f * (rope // 2) * 4 if rope else 0)
        # QKᵀ on bf16 operands can run on the tensor cores; P·V takes fp32 P
        half_flops = 2 * b * s * h * f * f * d
        rows.append(check_row(
            "temporal_attention", {"B": b, "F": f, "S": s, "H": h, "d": d},
            temporal_attention(*args), temporal_attention_reference(*args), TEMPORAL_TOL,
            lambda: temporal_attention(*args), lambda: temporal_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=d**-0.5),
            n_bytes, ((half_flops, BF16_FLOPS), (half_flops, FP32_FLOPS))))
    return rows


def phase_geglu(f: int) -> list:
    """GEGLU at N = 2·F·S tokens of width C, the shapes of a path with F frames."""
    from lavie_tpu_torch.kernels.geglu import geglu, geglu_reference

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (s, _), c in zip(ATTENTION_LEVELS, GEGLU_WIDTHS):
        n, inner = 2 * f * s, 4 * c
        r = lambda *shape, sd=1.0: (  # noqa: E731
            torch.randn(*shape, generator=g, device="cuda") * sd).bfloat16()
        x, w0, b0 = r(n, c), r(2 * inner, c, sd=c**-0.5), r(2 * inner, sd=0.1)
        w2, b2 = r(c, inner, sd=inner**-0.5), r(c, sd=0.1)
        args = (x, w0, b0, w2, b2)
        rows.append(check_row(
            "geglu", {"N": n, "C": c, "I": inner}, geglu(*args), geglu_reference(*args), GEGLU_TOL,
            lambda: geglu(*args), lambda: geglu_reference(*args), None,
            (2 * n * c + 3 * inner * c + 2 * inner + c) * 2, ((6 * n * c * inner, BF16_FLOPS),),
            plain_iters=20))
    return rows


def phase_flash() -> tuple:
    """flash_sparse_causal at the four TSR levels (B·F = 122, H = 8), then
    flash_attention_kv at L0 over the materialised (122, 5120, 320) kv."""
    from lavie_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    rf, h = TSR_ROWS, 8
    sparse_rows, kv_row = [], None
    for s, d in ATTENTION_LEVELS:
        c = h * d
        q, k, v = (torch.randn(rf, s, c, generator=g, device="cuda").bfloat16() for _ in range(3))
        args = (q, k, v, TSR_FRAMES, h, d**-0.5)
        kf, vf = fa.sparse_causal_kv(k, TSR_FRAMES), fa.sparse_causal_kv(v, TSR_FRAMES)
        # yardstick: one library call on (B·F, H, S|2S, d) tensors built here
        heads_first = lambda x: x.view(rf, -1, h, d).transpose(1, 2).contiguous()  # noqa: E731
        ql, kl, vl = heads_first(q), heads_first(kf), heads_first(vf)
        library = lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=d**-0.5)  # noqa: E731
        n_flops = 4 * rf * h * s * (2 * s) * d
        sparse_rows.append(check_row(
            "flash_sparse_causal", {"BF": rf, "F": TSR_FRAMES, "S": s, "H": h, "d": d},
            fa.flash_sparse_causal(*args), fa.flash_sparse_causal_reference(*args), FLASH_TOL,
            lambda: fa.flash_sparse_causal(*args), lambda: fa.flash_sparse_causal_reference(*args),
            library, 4 * rf * s * c * 2, ((n_flops, BF16_FLOPS),)))
        if kv_row is None:  # L0: the explicit-kv entry over the same kv, materialised
            kv_args = (q, kf, vf, h, d**-0.5)
            kv_row = check_row(
                "flash_attention_kv", {"B": rf, "Sq": s, "Sk": 2 * s, "H": h, "d": d},
                fa.flash_attention_kv(*kv_args), fa.flash_attention_kv_reference(*kv_args),
                FLASH_TOL, lambda: fa.flash_attention_kv(*kv_args),
                lambda: fa.flash_attention_kv_reference(*kv_args), library,
                (2 * rf * s * c + 2 * rf * 2 * s * c) * 2, ((n_flops, BF16_FLOPS),))
        del q, k, v, kf, vf, ql, kl, vl
    return sparse_rows, kv_row


class plain_kernels:
    """Within the block the UNet modules call the plain versions of all
    three kernels instead of the kernels."""

    def __enter__(self):
        import lavie_tpu_torch.nn.attention as attn_mod
        import lavie_tpu_torch.nn.transformer as tr_mod
        from lavie_tpu_torch.kernels.flash_attention import flash_sparse_causal_reference
        from lavie_tpu_torch.kernels.geglu import geglu_reference
        from lavie_tpu_torch.kernels.temporal_fused import temporal_attention_reference

        self.saved = (attn_mod.temporal_attention, attn_mod.flash_sparse_causal, tr_mod.geglu)
        attn_mod.temporal_attention = temporal_attention_reference
        attn_mod.flash_sparse_causal = flash_sparse_causal_reference
        tr_mod.geglu = geglu_reference

    def __exit__(self, *exc):
        import lavie_tpu_torch.nn.attention as attn_mod
        import lavie_tpu_torch.nn.transformer as tr_mod

        attn_mod.temporal_attention, attn_mod.flash_sparse_causal, tr_mod.geglu = self.saved


def phase_model(phase: str, cfg, frames: int) -> None:
    """Full-width UNet3D forward, kernels vs plain versions, same weights."""
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        unet = UNet3D(cfg).to(torch.bfloat16).eval()
    random_init_(unet, seed=7)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, frames, 40, 64, cfg.in_channels, generator=g, device="cuda")
    ts = torch.tensor([981.0, 981.0], device="cuda")
    ctx = torch.randn(2, 77, 768, generator=g, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        got = unet(x, ts, ctx).float()
        torch.cuda.synchronize()
        t_kernels = time.time() - t0
        with plain_kernels():
            want = unet(x, ts, ctx).float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel_mean = ((got - want).abs().mean() / want.abs().mean()).item()
    finite = bool(torch.isfinite(got).all())
    log(json.dumps({"phase": phase, "shape": list(x.shape), "max_abs_err": err, "max_abs_ref": scale,
                    "mean_rel_err": rel_mean, "finite": finite, "first_forward_s": t_kernels}))
    if not (finite and err <= MODEL_TOL[phase] * scale):
        raise AssertionError(f"{phase}: UNet3D kernels vs plain: err {err} > {MODEL_TOL[phase]}·{scale}")
    del unet
    torch.cuda.empty_cache()


KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names), first match wins
    ("temporal_attention", ("temporal_attention_kernel",)),
    ("geglu", ("geglu_kernel",)),
    ("flash_sparse_causal", ("flash_kernel<",)),
    ("attention (SDPA)", ("flash", "fmha", "attention", "softmax")),
    ("convolution", ("conv", "implicit", "winograd", "dgrad", "wgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("norm and elementwise", ("",)),
)


def phase_profile(phase: str, unet, frames: int) -> None:
    """Device time of one CFG-batched UNet forward, by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, frames, 40, 64, unet.config.in_channels, generator=g, device="cuda")
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
        # "Command Buffer Full" is the profiler's record of a stalled launch
        # queue, not device work: counting it put the busy share above 1
        if us <= 0 or e.key.startswith(("aten::", "cuda", "Memcpy", "Memset", "Command Buffer Full")):
            continue
        top.append((us / 1e3, e.key[:80], e.count))
        name = e.key.lower()
        group = next(g_ for g_, subs in KERNEL_GROUPS if any(s_ in name for s_ in subs))
        groups[group] += us / 1e3
    busy = sum(groups.values())
    top.sort(reverse=True)
    log(json.dumps({
        "phase": phase, "shape": list(x.shape), "wall_ms": wall_ms,
        "device_ms": busy if busy > 0 else "not measured",
        "busy_share": busy / wall_ms if busy > 0 else "not measured",
        "groups_ms": groups,
        "top_kernels": [{"ms": ms, "name": k, "calls": n} for ms, k, n in top[:12]],
    }))


def launch_counters() -> dict:
    from lavie_tpu_torch.kernels.flash_attention import flash_attention_kv, flash_sparse_causal
    from lavie_tpu_torch.kernels.geglu import geglu
    from lavie_tpu_torch.kernels.temporal_fused import temporal_attention

    return {"temporal_attention": temporal_attention, "geglu": geglu,
            "flash_sparse_causal": flash_sparse_causal, "flash_attention_kv": flash_attention_kv}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def phase_main() -> tuple:
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    t0 = time.time()
    pipe = TextToVideoPipeline.init_random(seed=0)  # full width, bf16, on the card
    torch.cuda.synchronize()
    log(f"[main] init {time.time() - t0:.1f} s")
    prompts = ["a teddy bear walking on the street, 2k, high quality",
               "a panda playing the guitar by a lake"]
    steps = 50
    videos = []
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
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
        videos.append(video[0])
    launches = read_launches()
    log(json.dumps({"phase": "main", "launches": launches,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    for name in ("temporal_attention", "geglu"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    phase_profile("profile", pipe.unet, 16)
    del pipe
    torch.cuda.empty_cache()
    return launches, videos[0]


def phase_tsr(base_video) -> dict:
    """Option 2 of the cascade: the first base video, 16 → 61 frames."""
    from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline

    t0 = time.time()
    pipe = VideoInterpolationPipeline.init_random(seed=0)  # full width, bf16, on the card
    torch.cuda.synchronize()
    log(f"[tsr] init {time.time() - t0:.1f} s")
    prompt = "a teddy bear walking on the street, 2k, high quality, 4k."
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = pipe(base_video, prompt, num_inference_steps=TSR_STEPS, guidance_scale=4.0, seed=0)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read_launches()
    video = out.video
    ok = (video.shape == (1, TSR_FRAMES, 320, 512, 3) and video.dtype.name == "uint8"
          and bool(torch.isfinite(out.latents).all()))
    log(json.dumps({"phase": "tsr", "input_shape": list(base_video.shape), "seconds": secs,
                    "s_per_step": secs / TSR_STEPS, "frames_per_s": TSR_FRAMES / secs,
                    "shape": list(video.shape), "dtype": video.dtype.name, "latents_finite": ok,
                    "video_mean": float(video.mean()), "video_std": float(video.std()),
                    "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    if not ok:
        raise AssertionError(f"bad TSR output: {video.shape} {video.dtype}")
    per_forward = 16  # transformer blocks in the UNet, each one call of each kernel
    if launches["flash_sparse_causal"] != per_forward * TSR_STEPS:
        raise AssertionError(f"flash_sparse_causal launched {launches['flash_sparse_causal']} "
                             f"times on the TSR path, expected {per_forward * TSR_STEPS}")
    for name in ("temporal_attention", "geglu"):
        if launches[name] < per_forward * TSR_STEPS:
            raise AssertionError(f"{name} launched {launches[name]} times on the TSR path")
    phase_profile("profile_tsr", pipe.unet, TSR_FRAMES)
    del pipe
    torch.cuda.empty_cache()
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
    temporal_rows = phase_temporal(16, rope=32)
    phase_temporal(TSR_FRAMES, rope=0)
    geglu_rows = phase_geglu(16)
    phase_geglu(TSR_FRAMES)
    sparse_rows, kv_row = phase_flash()
    from lavie_tpu_torch.core.config import UNetConfig

    phase_model("model", UNetConfig.base_t2v(), 16)
    phase_model("model_tsr", UNetConfig.interpolation(), TSR_FRAMES)
    main_launches, base_video = phase_main()
    tsr_launches = phase_tsr(base_video)

    def entry(name, source, replaces, row, note=None):
        by_path = {"main": main_launches[name], "tsr": tsr_launches[name]}
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"], "shape": row["shape"]}
        if note:
            e["note"] = note
        return e

    # per-kernel numbers are those of each kernel's L0 shape on its first path
    log(json.dumps({"kernels": [
        entry("temporal_attention", "lavie_tpu_torch/csrc/temporal_fused.cu",
              "lavie_tpu/kernels/temporal_fused.py:446", temporal_rows[0]),
        entry("geglu", "lavie_tpu_torch/csrc/geglu.cu", "lavie_tpu/kernels/geglu.py:85", geglu_rows[0]),
        entry("flash_sparse_causal", "lavie_tpu_torch/csrc/flash_attention.cu",
              "lavie_tpu/kernels/flash_attention.py:407", sparse_rows[0]),
        entry("flash_attention_kv", "lavie_tpu_torch/csrc/flash_attention.cu",
              "lavie_tpu/kernels/flash_attention.py:302", kv_row,
              note="kernels phase only: no path of the port materialises the sparse kv"),
    ]}))
    log(f"[chip_smoke] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
