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
 10. vsr_kernels  the VSR slice's kernels at every VSR shape against their
                plain versions (gn_silu_tconv, cross_attention_head,
                transformer_tail, flash_attention at d=128 and d=512, and
                temporal attention and GEGLU at the VSR widths)
 11. model_vsr  one full-width VSR UNet half-forward (1x8x320x512x7, text and
                noise level) with the kernels and with the plain versions
 12. vsr        VideoSuperResolutionPipeline at full width upscales the first
                8 frames of the first main-phase video to 8x1280x2048: 50
                v-prediction DDIM steps, CFG 5.0, noise level 50
 13. profile_vsr  the profile of one VSR UNet half-forward
 14. result     a `kernels` JSON line, then the `ok` JSON line last
Launch counts are zeroed just before each path (main, tsr, vsr) and read
just after it. Imports nothing of JAX or of the JAX package.
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
# whole-UNet kernels vs plain, of max|plain|: base seen at 0.014, TSR at 0.0185,
# VSR at 0.0246 (H100 80GB HBM3, 700 W)
MODEL_TOL = {"model": 1e-1, "model_tsr": 4e-2, "model_vsr": 5e-2}
TSR_STEPS = 50
VSR_STEPS, VSR_FRAMES = 50, 8
# VSR levels at one CFG half and one 8-frame window of 320x512 latents:
# (positions per frame, channels)
VSR_LEVELS = [(163840, 256), (40960, 512), (10240, 512), (2560, 1024)]
CROSS_TOL, TCONV_TOL = 2e-2, 1e-2  # of max|plain|


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    if iters == 0:
        return None
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
              n_bytes: float, ops, plain_iters: int = 5, iters: int = 20, plain_ms=None,
              **extra) -> dict:
    """Compare a kernel's output with its plain version's, time the kernel,
    the plain version (or take `plain_ms` measured by the caller) and the
    library yardstick (None: no single call)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    finite = bool(torch.isfinite(out).all())
    bound_ms, bound_by = bound(n_bytes, ops)
    warm = min(3, iters)
    row = {
        "kernel": kernel, "shape": shape, "max_abs_err": err, "max_abs_ref": scale,
        "ms": time_ms(fn, iters, warm),
        "plain_ms": plain_ms if plain_ms is not None else time_ms(plain, plain_iters, min(3, plain_iters)),
        "library_ms": time_ms(library, iters, warm) if library is not None else None,
        "bound_ms": bound_ms, "bound_by": bound_by, **extra,
    }
    log(json.dumps(row))
    if not (finite and err <= tol * scale):
        raise AssertionError(f"{kernel} {shape}: err {err} > {tol}·{scale} or not finite")
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
    logs = _build.build(["temporal_fused", "geglu", "flash_attention", "temporal_resblock",
                         "cross_block"])
    for name, text in logs.items():
        regs = [ln.split("ptxas info    : ")[-1] for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {'; '.join(regs)}")
    log(f"[build] {time.time() - t0:.1f} s")


def phase_temporal(f: int, rope: int, levels=ATTENTION_LEVELS, b: int = 2) -> list:
    """Temporal attention at H=8: the base path's F=16 with RoPE and a bias
    (B=2), the TSR path's F=61 with neither (B=2), the VSR path's F=8 with
    both (B=1, one CFG half)."""
    from lavie_tpu_torch.kernels.temporal_fused import (
        temporal_attention,
        temporal_attention_reference,
    )
    from lavie_tpu_torch.nn.embeddings import apply_rope_half, rope_half_frequencies

    g = torch.Generator(device="cuda").manual_seed(1)
    h = 8
    rows = []
    for s, d in levels:
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


def phase_geglu(f: int, shapes=None) -> list:
    """GEGLU at N = 2·F·S tokens of width C, the shapes of a path with F
    frames, or at the given (N, C) shapes."""
    from lavie_tpu_torch.kernels.geglu import geglu, geglu_reference

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    shapes = shapes or [(2 * f * s, c) for (s, _), c in zip(ATTENTION_LEVELS, GEGLU_WIDTHS)]
    for n, c in shapes:
        inner = 4 * c
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
    """Within the block the UNet and VAE modules call the plain versions of
    every kernel instead of the kernels."""

    def _swaps(self):
        import lavie_tpu_torch.nn.attention as attn_mod
        import lavie_tpu_torch.nn.resnet as res_mod
        import lavie_tpu_torch.nn.transformer as tr_mod
        import lavie_tpu_torch.nn.vae as vae_mod
        from lavie_tpu_torch.kernels import cross_block as cb
        from lavie_tpu_torch.kernels import flash_attention as fa
        from lavie_tpu_torch.kernels import geglu as gg
        from lavie_tpu_torch.kernels import temporal_fused as tf
        from lavie_tpu_torch.kernels import temporal_resblock as tr

        return [
            (attn_mod, "temporal_attention", tf.temporal_attention_reference),
            (attn_mod, "flash_sparse_causal", fa.flash_sparse_causal_reference),
            (attn_mod, "flash_attention", fa.flash_attention_reference),
            (vae_mod, "flash_attention", fa.flash_attention_reference),
            (tr_mod, "geglu", gg.geglu_reference),
            (tr_mod, "cross_attention_head", cb.cross_attention_head_reference),
            (tr_mod, "transformer_tail", cb.transformer_tail_reference),
            (res_mod, "gn_silu_tconv", tr.gn_silu_tconv_reference),
        ]

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self._swaps()]
        for mod, name, plain in self._swaps():
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def unet_inputs(cfg, batch: int, frames: int, h: int, w: int, ctx_dim: int, seed: int, t: float):
    """Random full-width UNet inputs on the card: (x, timesteps, text, class labels)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, frames, h, w, cfg.in_channels, generator=g, device="cuda")
    ts = torch.full((batch,), t, device="cuda")
    ctx = torch.randn(batch, 77, ctx_dim, generator=g, device="cuda")
    labels = torch.full((batch,), 50, device="cuda", dtype=torch.long) if cfg.class_embed_type else None
    return x, ts, ctx, labels


def phase_model(phase: str, cfg, frames: int, batch: int = 2, h: int = 40, w: int = 64,
                ctx_dim: int = 768) -> None:
    """Full-width UNet3D forward, kernels vs plain versions, same weights."""
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        unet = UNet3D(cfg).to(torch.bfloat16).eval()
    random_init_(unet, seed=7)
    x, ts, ctx, labels = unet_inputs(cfg, batch, frames, h, w, ctx_dim, seed=3, t=981.0)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        got = unet(x, ts, ctx, labels).float()
        torch.cuda.synchronize()
        t_kernels = time.time() - t0
        with plain_kernels():
            want = unet(x, ts, ctx, labels).float()
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
    ("gn_silu_tconv", ("tconv_kernel",)),
    ("cross_attention_head", ("head_kernel<",)),
    ("transformer_tail", ("tail_kernel<",)),
    ("flash d=512", ("flash_wide_kernel",)),
    ("flash d<=160 (sparse-causal, explicit kv, VSR L3)", ("flash_kernel<",)),
    ("attention (SDPA)", ("flash", "fmha", "attention", "softmax")),
    ("convolution", ("conv", "implicit", "winograd", "dgrad", "wgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("norm and elementwise", ("",)),
)


def phase_profile(phase: str, unet, frames: int, batch: int = 2, h: int = 40, w: int = 64,
                  ctx_dim: int = 768) -> None:
    """Device time of one UNet forward (CFG-batched, or one VSR half), by
    kernel group; then a second forward, traced with shapes, attributes the
    dtype/layout copies (recording shapes slows the host: on an H100 80GB
    HBM3 at 700 W it stretched the base forward's wall from 123 to 172 ms)."""
    from torch.profiler import ProfilerActivity, profile

    x, ts, ctx, labels = unet_inputs(unet.config, batch, frames, h, w, ctx_dim, seed=4, t=500.0)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        unet(x, ts, ctx, labels)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.time()
            unet(x, ts, ctx, labels)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        with profile(activities=activities, record_shapes=True) as shaped:
            unet(x, ts, ctx, labels)
            torch.cuda.synchronize()
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
    # dtype/layout copies (aten::copy_: .float(), .to(), .contiguous()) by
    # (destination, source) shape, with the device time of their kernels
    copies = []
    for e in shaped.key_averages(group_by_input_shape=True):
        if e.key == "aten::copy_":
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            copies.append((us / 1e3, e.count, str(e.input_shapes[:2])))
    copies.sort(reverse=True)
    log(json.dumps({
        "phase": phase, "shape": list(x.shape), "wall_ms": wall_ms,
        "device_ms": busy if busy > 0 else "not measured",
        "busy_share": busy / wall_ms if busy > 0 else "not measured",
        "groups_ms": groups,
        "top_kernels": [{"ms": ms, "name": k, "calls": n} for ms, k, n in top[:12]],
        "copies": {"calls": sum(n for _, n, _ in copies), "ms": sum(ms for ms, _, _ in copies),
                   "by_shape": [{"ms": ms, "calls": n, "shapes": sh} for ms, n, sh in copies[:12]]},
    }))


def launch_counters() -> dict:
    from lavie_tpu_torch.kernels.cross_block import cross_attention_head, transformer_tail
    from lavie_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_kv,
        flash_sparse_causal,
    )
    from lavie_tpu_torch.kernels.geglu import geglu
    from lavie_tpu_torch.kernels.temporal_fused import temporal_attention
    from lavie_tpu_torch.kernels.temporal_resblock import gn_silu_tconv

    return {"temporal_attention": temporal_attention, "geglu": geglu,
            "flash_sparse_causal": flash_sparse_causal, "flash_attention_kv": flash_attention_kv,
            "flash_attention": flash_attention, "cross_attention_head": cross_attention_head,
            "transformer_tail": transformer_tail, "gn_silu_tconv": gn_silu_tconv}


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


def _valid_taps(frames: int, k: int) -> int:
    """(output frame, tap) pairs whose source frame lies inside the window."""
    p = k // 2
    return sum(min(k, frames + p - f) - max(0, p - f) for f in range(frames))


def phase_vsr_kernels() -> dict:
    """The VSR slice's kernels at every VSR shape (one CFG half, one
    8-frame window), each against its plain version. Returns the rows."""
    from lavie_tpu_torch.kernels import cross_block as cb
    from lavie_tpu_torch.kernels import flash_attention as fa
    from lavie_tpu_torch.kernels import temporal_resblock as tr

    g = torch.Generator(device="cuda").manual_seed(9)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    f = VSR_FRAMES
    rows = {"gn_silu_tconv": [], "cross_attention_head": [], "transformer_tail": [],
            "flash_attention": []}

    # gn_silu_tconv: conv1 (k=5, time embedding in the bias) of every temporal
    # module's resblock and conv2 (k=3, + residual) of every resblock
    for s, c in VSR_LEVELS:
        for k, with_res in ((5, False), (3, True)):
            x = bf(1, f, s, c)
            w, u, bias = f32(1, c, m=1.0), f32(1, c), f32(1, c)
            taps = bf(k, c, c, sd=c ** -0.5)
            res = bf(1, f, s, c) if with_res else None
            args = (x, w, u, taps, bias, res)
            act = torch.nn.functional.silu((x * w.bfloat16()[:, None, None] + u.bfloat16()[:, None, None])
                                           .float()).bfloat16().permute(0, 3, 1, 2).contiguous()
            conv_w = taps.permute(1, 2, 0)[..., None].contiguous()  # (O, C, k, 1)
            conv_only = time_ms(lambda: F.conv2d(act, conv_w, padding=(k // 2, 0)))
            del act
            n_bytes = (2 + with_res) * f * s * c * 2 + k * c * c * 2 + 3 * c * 4
            rows["gn_silu_tconv"].append(check_row(
                "gn_silu_tconv", {"B": 1, "F": f, "S": s, "C": c, "O": c, "k": k, "residual": with_res},
                tr.gn_silu_tconv(*args), tr.gn_silu_tconv_reference(*args), TCONV_TOL,
                lambda: tr.gn_silu_tconv(*args), lambda: tr.gn_silu_tconv_reference(*args), None,
                n_bytes, ((2 * _valid_taps(f, k) * s * c * c, BF16_FLOPS),),
                conv_of_activated_input_ms=conv_only))
            del x, res, args

    # the only-cross block's head and tail at L1 and L2 (C=512, 8 heads x 64, 77 keys)
    for s, c in VSR_LEVELS[1:3]:
        n, lkv = f * s, 77
        x, r = bf(1, n, c), bf(1, n, c)
        attn = lambda: (f32(c, m=1.0), f32(c), bf(c, c, sd=c ** -0.5), bf(c, c, sd=c ** -0.5),  # noqa: E731
                        f32(c), bf(1, lkv, c), bf(1, lkv, c))
        hargs = (x, bf(c, c, sd=c ** -0.5), f32(c), attn(), attn(), c // 64, 0.125)
        rows["cross_attention_head"].append(check_row(
            "cross_attention_head", {"B": 1, "N": n, "C": c, "heads": c // 64, "L": lkv},
            cb.cross_attention_head(*hargs), cb.cross_attention_head_reference(*hargs), CROSS_TOL,
            lambda: cb.cross_attention_head(*hargs), lambda: cb.cross_attention_head_reference(*hargs),
            None, 2 * n * c * 2 + 5 * c * c * 2 + 4 * lkv * c * 2,
            ((2 * 5 * n * c * c + 2 * 2 * 2 * n * lkv * c, BF16_FLOPS),)))
        targs = (x, r, f32(c, m=1.0), f32(c), bf(8 * c, c, sd=c ** -0.5), f32(8 * c),
                 bf(c, 4 * c, sd=(4 * c) ** -0.5), f32(c), bf(c, c, sd=c ** -0.5), f32(c))
        rows["transformer_tail"].append(check_row(
            "transformer_tail", {"N": n, "C": c, "I": 4 * c},
            cb.transformer_tail(*targs), cb.transformer_tail_reference(*targs), CROSS_TOL,
            lambda: cb.transformer_tail(*targs), lambda: cb.transformer_tail_reference(*targs),
            None, 3 * n * c * 2 + 13 * c * c * 2, ((26 * n * c * c, BF16_FLOPS),)))
        del x, r, hargs, targs

    # flash_attention: the UNet's L3 self-attention (8 heads x 128) and the f4
    # VAE's mid attention over 320x512 positions (one head of 512)
    s3, c3 = VSR_LEVELS[3]
    q, k, v = (bf(f, s3, 8, 128) for _ in range(3))
    rows["flash_attention"].append(check_row(
        "flash_attention", {"B": f, "S": s3, "H": 8, "d": 128},
        fa.flash_attention(q, k, v, 128 ** -0.5), fa.flash_attention_reference(q, k, v, 128 ** -0.5),
        FLASH_TOL, lambda: fa.flash_attention(q, k, v, 128 ** -0.5),
        lambda: fa.flash_attention_reference(q, k, v, 128 ** -0.5),
        lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v))),
        4 * q.numel() * 2, ((4 * f * 8 * s3 * s3 * 128, BF16_FLOPS),)))
    s0 = VSR_LEVELS[0][0]
    q, k, v = (bf(f, s0, 1, 512) for _ in range(3))
    torch.cuda.synchronize()
    t0 = time.time()
    want = fa.flash_attention_reference(q, k, v, 512 ** -0.5)  # ~4 GB of scores at a time
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))

    def efficient_sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(ql, kl, vl)

    library, library_note = efficient_sdpa, "SDPA memory-efficient backend"
    try:  # the only backend that could take d = 512 without the 107 GB scores
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            F.scaled_dot_product_attention(ql[:1, :, :64], kl[:1], vl[:1])
    except RuntimeError as e:
        library, library_note = None, f"SDPA memory-efficient backend refuses d=512: {str(e)[:160]}"
    # one timed call after one warm-up: each takes seconds
    rows["flash_attention"].append(check_row(
        "flash_attention", {"B": f, "S": s0, "H": 1, "d": 512},
        fa.flash_attention(q, k, v, 512 ** -0.5), want, FLASH_TOL,
        lambda: fa.flash_attention(q, k, v, 512 ** -0.5), None, library,
        4 * q.numel() * 2, ((4 * f * s0 * s0 * 512, BF16_FLOPS),), iters=1, plain_ms=plain_ms,
        plain_iters=0, library_note=library_note))
    del q, k, v, want, ql, kl, vl
    torch.cuda.empty_cache()
    return rows


def phase_vsr(base_video) -> dict:
    """Option 3 of the cascade: the first 8 frames of the first base video,
    320x512 -> 1280x2048."""
    from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline

    t0 = time.time()
    pipe = VideoSuperResolutionPipeline.init_random(seed=0)  # full width, bf16, on the card
    torch.cuda.synchronize()
    log(f"[vsr] init {time.time() - t0:.1f} s")
    frames = base_video[:VSR_FRAMES]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = pipe(frames, "a teddy bear walking on the street, 2k, high quality, 4k.",
               num_inference_steps=VSR_STEPS, guidance_scale=5.0, noise_level=50, seed=10)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read_launches()
    video = out.video
    ok = video.shape == (VSR_FRAMES, 1280, 2048, 3) and video.dtype.name == "uint8"
    log(json.dumps({"phase": "vsr", "input_shape": list(frames.shape), "seconds": secs,
                    "s_per_step": secs / VSR_STEPS, "frames_per_s": VSR_FRAMES / secs,
                    "shape": list(video.shape), "dtype": video.dtype.name,
                    "video_mean": float(video.mean()), "video_std": float(video.std()),
                    "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    if not ok:
        raise AssertionError(f"bad VSR output: {video.shape} {video.dtype}")
    # per CFG half: 16 transformers (temporal attention, a 2-launch resblock),
    # 10 of them only-cross (head + tail), 6 with L3-width self-attention and
    # GEGLU, 8 temporal modules (2 resblock launches); the shared prefix adds
    # the L0 temporal module; the VAE's mid attention runs once per window
    expected = {"gn_silu_tconv": (2 * 48 + 2) * VSR_STEPS, "cross_attention_head": 20 * VSR_STEPS,
                "transformer_tail": 20 * VSR_STEPS, "flash_attention": 12 * VSR_STEPS + 1,
                "temporal_attention": 32 * VSR_STEPS, "geglu": 12 * VSR_STEPS}
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times on the VSR path, expected {n}")
    phase_profile("profile_vsr", pipe.unet, VSR_FRAMES, batch=1, h=320, w=512, ctx_dim=1024)
    del pipe, out
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
    phase_temporal(VSR_FRAMES, rope=32, b=1,
                   levels=[(s, 64) for s, _ in VSR_LEVELS[1:3]] + [(VSR_LEVELS[3][0], 128)])
    phase_geglu(VSR_FRAMES, shapes=[(VSR_FRAMES * 10240, 512), (VSR_FRAMES * 2560, 1024)])
    vsr_rows = phase_vsr_kernels()
    phase_model("model_vsr", UNetConfig.vsr(), VSR_FRAMES, batch=1, h=320, w=512, ctx_dim=1024)
    vsr_launches = phase_vsr(base_video)

    def entry(name, source, replaces, row, note=None):
        by_path = {"main": main_launches[name], "tsr": tsr_launches[name],
                   "vsr": vsr_launches[name]}
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
        entry("flash_attention", "lavie_tpu_torch/csrc/flash_attention.cu",
              "lavie_tpu/kernels/flash_attention.py:453", vsr_rows["flash_attention"][1],
              note="the VAE's d=512 shape; the L3 d=128 row is in the vsr_kernels phase"),
        entry("cross_attention_head", "lavie_tpu_torch/csrc/cross_block.cu",
              "lavie_tpu/kernels/cross_block.py:383", vsr_rows["cross_attention_head"][0]),
        entry("transformer_tail", "lavie_tpu_torch/csrc/cross_block.cu",
              "lavie_tpu/kernels/cross_block.py:441", vsr_rows["transformer_tail"][0]),
        entry("gn_silu_tconv", "lavie_tpu_torch/csrc/temporal_resblock.cu",
              "lavie_tpu/kernels/temporal_resblock.py:398", vsr_rows["gn_silu_tconv"][0],
              note="also replaces gn_silu_tconv_sfc, lavie_tpu/kernels/temporal_resblock.py:306: "
                   "the port keeps video frame-major at that call site too"),
    ]}))
    log(f"[chip_smoke] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
