"""Smoke run of the PyTorch port on one NVIDIA card: python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its result line:
  1. device     the card's name and power limit (nvidia-smi)
  2. build      every CUDA kernel from lavie_tpu_torch/csrc, one nvcc each,
                started together; registers and spills of every kernel, read
                from ptxas's report (kept beside each library, so a cached
                build is checked too); a kernel the report does not cover, a
                spill, or ptxas's C7514 (wgmma serialised) fails the phase;
                so does a flash, geglu, cross-attention, head GEMM or
                attention, transformer-tail GEMM, temporal-conv GEMM (float
                or int8) or ln_qkv GEMM instance whose SASS lacks an op of
                SASS_REQUIRED (wgmma or mma, and TMA loads; multicast TMA
                loads in the d=512 flash kernel)
  3. kernels    each kernel at every base-path and TSR-path shape against its
                plain PyTorch version in bf16 (tolerance relative to
                max|plain|), timed with CUDA events beside the plain version
                and, where one PyTorch call computes the same function,
                F.scaled_dot_product_attention (a yardstick only: the port
                never calls it); the explicit-kv flash entry runs here only.
                Rows of the redesigned bodies also print the time of the
                bodies they replaced (prev_ms)
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
                temporal attention and GEGLU at the VSR widths); the head
                and tail rows also time the eager path (head: F.linear, then
                twice F.layer_norm, F.linear, SDPA, F.linear and the add;
                tail: F.layer_norm, three cuBLAS F.linear, F.gelu, the adds)
                as a yardstick the port never calls
 11. model_vsr  one full-width VSR UNet half-forward (1x8x320x512x7, text and
                noise level) with the kernels and with the plain versions
 12. vsr        VideoSuperResolutionPipeline at full width upscales the first
                8 frames of the first main-phase video to 8x1280x2048: 10
                v-prediction DDIM steps (the one cut; 50 in a user's run),
                CFG 5.0, noise level 50
 13. profile_vsr  the profile of one VSR UNet half-forward
 14. optin      the JAX package's opt-in float routes: temporal_attention_folded
                (the temporal kernel on q/k rotated beforehand, with a bias)
                at the base and VSR shapes; gn_silu_tconv with emit_stats at
                the four VSR levels in the 8- and the 5-frame window, timed
                beside the same call without
                statistics and beside the GroupNorm.affine it replaces, and
                with activation "none" at one shape
 15. ab_vsr, ab_base  one full-width VSR UNet half-forward with
                LAVIE_TRESBLOCK_STATS unset and set, one base UNet forward
                with LAVIE_TEMPORAL_KERNEL unset and set: device ms of each,
                outputs compared
 16. cross_kernels  the text cross-attention at the base levels, TSR L0
                and VSR L3:
                cross_attention (timed beside SDPA) and
                fused_ln_cross_attention (timed beside the LayerNorm,
                cuBLAS and SDPA path it replaces), each against its plain
                version
 17. temporal_proj_kernels  ln_qkv and out_proj_residual at the base, TSR
                and VSR levels with temporal attention, each against its
                plain version, timed beside the eager LayerNorm and cuBLAS
                projections they replace; ln_qkv's device ms by kernel
                (torch.profiler)
 18. ab_attn2, ab_temporal_proj  one base UNet forward with LAVIE_ATTN2
                unset, "cross" and "fused", and with LAVIE_TEMPORAL_PROJ unset
                and set: device ms, launches of each route, outputs compared
 19. turbo_kernels  the int8 turbo mode's pieces: the int8 gn_silu_tconv at
                every VSR shape where the JAX package's gate admits it (k=5,
                and k=3 + residual; F=8 and the 5-frame tail, the tail with
                emit_stats on conv1) against its plain version, timed beside
                the float kernel and its bound, with its device ms by kernel
                (torch.profiler); int8_conv2d at the base L0,
                VSR L0 and one f4-VAE full-resolution frame, its int32
                product checked exactly on bands of rows, timed beside
                cuDNN's bf16 conv (a yardstick only)
 20. ab_turbo_vsr, ab_turbo_base  one full-width VSR UNet half-forward and
                one base UNet forward with conv_quant "none", "int8" (and
                LAVIE_TRESBLOCK_INT8=1), "int8" excluding samplers and
                up_blocks: device ms and the relative error against bf16
 21. cascade    the serving entry point at full width: Predictor().setup(),
                predict() for option 2 (61x320x512, written to
                build/cascade/ as .avi where a C compiler and libjpeg are
                found, else as a GIF); then a second predictor in turbo,
                Predictor().setup(conv_quant="int8"), runs the cascade for
                option 4 (61x1280x2048, not written) with the five opt-in
                switches set and one cut, 10 VSR steps; stage seconds,
                shapes, peak memory and exact launch counts per stage
 22. result     a `kernels` JSON line, then the `ok` JSON line last
Launch counts are zeroed just before each path (main, tsr, vsr, cascade) and
read just after it; the paths before the cascade run the default routes and
launch no opt-in entry. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core bf16
INT8_OPS = 1979e12  # dense tensor-core int8
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
# the vsr phase's one cut: 10 steps (50 in a user's run), as the cascade's
# option 4, to keep the script under half its time limit
VSR_STEPS, VSR_FRAMES = 10, 8
# VSR levels at one CFG half and one 8-frame window of 320x512 latents:
# (positions per frame, channels)
VSR_LEVELS = [(163840, 256), (40960, 512), (10240, 512), (2560, 1024)]
CROSS_TOL, TCONV_TOL = 2e-2, 1e-2  # of max|plain|
ATTN_TOL, PROJ_TOL = 1e-2, 2e-2  # cross_attention; ln_qkv and out_proj_residual
STATS_TOL = 1e-2  # gn_silu_tconv's Σ, Σ², of max|plain|
# the cascade phase's option 4: the one cut (50 VSR steps in a user's run)
CASCADE_VSR_STEPS = 10
# int8 turbo against bf16, relative L2 error of a random-init UNet's output:
# the JAX package's own bound (tests/test_quant.py)
TURBO_REL_TOL = 0.35
TURBO_EXCLUDE = ("samplers", "up_blocks")


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


# the times of the redesigned kernels before their redesign (chip_smoke.py on
# an NVIDIA H100 80GB HBM3 at 700 W), printed beside each new time as prev_ms
PREV_MS = {
    ("temporal_attention", 2, 16, 2560, 40): 0.262, ("temporal_attention", 2, 16, 640, 80): 0.194,
    ("temporal_attention", 2, 16, 160, 160): 0.163, ("temporal_attention", 2, 16, 40, 160): 0.070,
    ("temporal_attention", 2, 61, 2560, 40): 2.655, ("temporal_attention", 2, 61, 640, 80): 1.410,
    ("temporal_attention", 2, 61, 160, 160): 1.221, ("temporal_attention", 2, 61, 40, 160): 0.359,
    ("temporal_attention", 1, 8, 40960, 64): 1.334, ("temporal_attention", 1, 8, 10240, 64): 0.354,
    ("temporal_attention", 1, 8, 2560, 128): 0.292,
    ("temporal_attention_folded", 2, 16, 2560, 40): 0.223,
    ("temporal_attention_folded", 2, 16, 640, 80): 0.177,
    ("temporal_attention_folded", 2, 16, 160, 160): 0.156,
    ("temporal_attention_folded", 2, 16, 40, 160): 0.066,
    ("temporal_attention_folded", 1, 8, 40960, 64): 1.118,
    ("temporal_attention_folded", 1, 8, 10240, 64): 0.317,
    ("temporal_attention_folded", 1, 8, 2560, 128): 0.276,
    ("flash_sparse_causal", 122, 61, 2560, 40): 12.232, ("flash_sparse_causal", 122, 61, 640, 80): 1.189,
    ("flash_sparse_causal", 122, 61, 160, 160): 0.241, ("flash_sparse_causal", 122, 61, 40, 160): 0.040,
    ("flash_attention_kv", 122, 2560, 5120, 40): 12.420, ("flash_attention", 8, 2560, 128): 0.928,
    # GEGLU (one wmma kernel) and the short-kv cross attention before their
    # redesign to wgmma GEMMs and a persistent TMA-fed kernel
    ("geglu", 81920, 320, 1280): 3.610, ("geglu", 20480, 640, 2560): 3.475,
    ("geglu", 5120, 1280, 5120): 4.666, ("geglu", 1280, 1280, 5120): 1.563,
    ("geglu", 312320, 320, 1280): 13.026, ("geglu", 78080, 640, 2560): 13.081,
    ("geglu", 19520, 1280, 5120): 15.401, ("geglu", 4880, 1280, 5120): 4.748,
    ("geglu", 81920, 512, 2048): 9.858, ("geglu", 20480, 1024, 4096): 11.440,
    # the short-kv cross attention before its probabilities were divided by
    # their sum instead of multiplied by its reciprocal (PERF.md, row 13)
    ("cross_attention", "base", 2, 40960, 40, 77): 0.087,
    ("cross_attention", "base", 2, 10240, 80, 77): 0.046,
    ("cross_attention", "base", 2, 2560, 160, 77): 0.047,
    ("cross_attention", "base", 2, 640, 160, 77): 0.033,
    ("cross_attention", "VSR L3", 1, 20480, 128, 77): 0.036,
    # the VSR transformer tail (mma.sync, weights streamed per 32 rows) and
    # the float GN·SiLU·temporal conv (mma.sync, the activation recomputed
    # per tap and output tile) before their redesign to wgmma GEMMs fed by TMA
    ("transformer_tail", 327680, 512, 2048): 27.418, ("transformer_tail", 81920, 512, 2048): 7.080,
    ("gn_silu_tconv", 1, 8, 163840, 256, 256, 5, False): 7.381,
    ("gn_silu_tconv", 1, 8, 163840, 256, 256, 3, True): 5.070,
    ("gn_silu_tconv", 1, 8, 40960, 512, 512, 5, False): 7.324,
    ("gn_silu_tconv", 1, 8, 40960, 512, 512, 3, True): 4.883,
    ("gn_silu_tconv", 1, 8, 10240, 512, 512, 5, False): 1.825,
    ("gn_silu_tconv", 1, 8, 10240, 512, 512, 3, True): 1.221,
    ("gn_silu_tconv", 1, 8, 2560, 1024, 1024, 5, False): 1.828,
    ("gn_silu_tconv", 1, 8, 2560, 1024, 1024, 3, True): 1.232,
    ("gn_silu_tconv (emit_stats)", 1, 8, 163840, 256, 256, 5): 7.517,
    ("gn_silu_tconv (emit_stats)", 1, 8, 40960, 512, 512, 5): 7.359,
    ("gn_silu_tconv (emit_stats)", 1, 8, 10240, 512, 512, 5): 1.861,
    ("gn_silu_tconv (emit_stats)", 1, 8, 2560, 1024, 1024, 5): 1.876,
    ("gn_silu_tconv (activation none)", 1, 8, 10240, 512, 512, 3, True): 0.552,
    # the VSR only-cross head (mma.sync, the five weights streamed per 64
    # rows through a cp.async ring) and the d=512 flash body (mma.sync, two
    # warps a 16-query band, K and V re-read by every 64-query block) before
    # their redesign to wgmma fed by TMA
    ("cross_attention_head", 1, 327680, 512, 8, 77): 8.327,
    ("cross_attention_head", 1, 81920, 512, 8, 77): 2.194,
    ("flash_attention", 8, 163840, 512): 2631.6,
    # ln_qkv (mma.sync, all 3·E·C weights streamed through a cp.async ring
    # per 64-token block, stored from registers) before its redesign to a
    # LayerNorm pass and a staged wgmma GEMM fed by TMA
    ("ln_qkv", "base", 2, 16, 2560, 320, 320): 0.856, ("ln_qkv", "base", 2, 16, 640, 640, 640): 0.672,
    ("ln_qkv", "base", 2, 16, 160, 1280, 1280): 0.777, ("ln_qkv", "base", 2, 16, 40, 1280, 1280): 0.762,
    ("ln_qkv", "TSR L0", 2, 61, 2560, 320, 320): 2.874,
}
# the int8 GN·SiLU·temporal conv (mma.sync, its input activated and quantised
# on the fly per tap and output tile) before its redesign to s8 wgmma fed by
# TMA, at each turbo site (S, C): F=8 k=5, F=8 k=3 + residual, F=5 k=5 with
# statistics; the scale block is the JAX package's choice there
PREV_MS.update({
    ("gn_silu_tconv (int8)", 1, f, s, c, c, k, res, stats, 512 if c == 256 else 256): ms
    for (s, c), times in {(163840, 512): (26.688, 18.334, 15.434), (163840, 256): (7.506, 5.385, 4.376),
                          (40960, 512): (7.204, 5.037, 4.217), (40960, 256): (2.340, 1.845, 1.430),
                          (10240, 512): (2.348, 1.777, 1.430), (2560, 512): (1.128, 0.971, 0.728)}.items()
    for (f, k, res, stats), ms in zip(((8, 5, False, False), (8, 3, True, False), (5, 5, False, True)),
                                      times)})


def prev_ms(kernel: str, shape: dict):
    key = (kernel, *(v for k, v in shape.items() if k != "H"))
    return PREV_MS.get(key)


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
    if prev_ms(kernel, shape) is not None:
        row["prev_ms"] = prev_ms(kernel, shape)
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


# kernels that must run their products on wgmma fed by TMA: (source, kernel
# name substring, SASS opcode prefixes each instance must hold)
SASS_REQUIRED = (("flash_attention", "flash_kernel", ("HGMMA.64", "UTMALDG.4D")),
                 ("flash_attention", "flash_d512_kernel", ("HGMMA.64", "UTMALDG.4D.MULTICAST")),
                 ("geglu", "geglu_", ("HGMMA", "UTMALDG")),
                 ("cross_attention", "cross_kernel", ("HGMMA", "UTMALDG.4D")),
                 ("cross_attention", "cross_long_kernel", ("HMMA", "UTMALDG.4D")),
                 ("cross_head", "head_gemm_kernel", ("HGMMA", "UTMALDG.2D", "UTMASTG.2D")),
                 ("cross_head", "head_attn_kernel", ("HGMMA", "UTMALDG.4D")),
                 ("transformer_tail", "tail_gemm_", ("HGMMA", "UTMALDG")),
                 ("temporal_resblock", "tconv_gemm_kernel", ("HGMMA", "UTMALDG")),
                 ("temporal_resblock", "tconv_int8_gemm_kernel", ("IGMMA", "UTMALDG.4D")),
                 ("temporal_proj", "ln_qkv_gemm_kernel", ("HGMMA", "UTMALDG")))


def sass_summary(path, kernel: str, prefixes) -> dict:
    """{kernel instance: {opcode prefix: count}} in a built library's SASS,
    for the instances whose name holds `kernel`."""
    from lavie_tpu_torch.kernels import _build

    return {name: {p: sum(n for op, n in ops.items() if op.startswith(p)) for p in prefixes}
            for name, ops in _build.sass_op_counts(path).items() if kernel in name}


def ptxas_report(text: str) -> list:
    """(function, registers, spill store bytes, spill load bytes) per kernel
    from nvcc's -Xptxas -v log."""
    rows, fn, spill = [], None, (0, 0)
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln:
            parts = ln.replace(",", "").split()
            spill = (int(parts[parts.index("spill") - 2]), int(parts[parts.index("loads") - 3]))
        elif "Used" in ln and "registers" in ln and fn is not None:
            rows.append((fn, int(ln.split("Used")[1].split()[0]), *spill))
            fn, spill = None, (0, 0)
    return rows


def phase_build() -> None:
    from lavie_tpu_torch.kernels import _build

    t0 = time.time()
    logs = _build.build(["temporal_fused", "geglu", "flash_attention", "temporal_resblock",
                         "cross_block", "cross_head", "transformer_tail", "cross_attention",
                         "temporal_proj"])
    for name, text in logs.items():
        report = ptxas_report(text)
        entries, spill_lines = text.count("Compiling entry function"), text.count("spill stores")
        if not report or len(report) != entries or spill_lines < entries:
            raise AssertionError(f"{name}: ptxas reports {entries} kernels and {spill_lines} "
                                 f"spill counts, of which {len(report)} were read")
        regs = sorted({r for _, r, _, _ in report})
        log(f"[build] {name}: {len(report)} kernels, registers {regs}, spill bytes "
            f"{sum(st + ld for _, _, st, ld in report)}")
        for fn, r, st, ld in report:
            log(f"[build]   {fn}: {r} registers, spill stores {st} B, loads {ld} B")
            if st or ld:
                raise AssertionError(f"{fn} spills: {st} B stored, {ld} B loaded")
        if "C7514" in text:  # ptxas serialised a wgmma batch
            raise AssertionError(f"{name}: ptxas warns that wgmma is serialised (C7514)")
    for name, kernel, prefixes in SASS_REQUIRED:
        summary = sass_summary(_build.library_path(name), kernel, prefixes)
        log(json.dumps({"sass": name, "instances": len(summary), "counts": summary}))
        if not summary or any(not all(ops.values()) for ops in summary.values()):
            raise AssertionError(f"{name}: an instance of {kernel} lacks one of {prefixes}")
    log(f"[build] {time.time() - t0:.1f} s")


def phase_temporal(f: int, rope: int, levels=ATTENTION_LEVELS, b: int = 2,
                   folded: bool = False) -> list:
    """Temporal attention at H=8: the base path's F=16 with RoPE and a bias
    (B=2), the TSR path's F=61 with neither (B=2), the VSR path's F=8 with
    both (B=1, one CFG half). `folded`: the opt-in route's entry,
    temporal_attention_folded, on q and k rotated beforehand, with the bias."""
    from lavie_tpu_torch.kernels.temporal_fused import (
        temporal_attention,
        temporal_attention_folded,
        temporal_attention_folded_reference,
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
        # yardstick: one library call on (B·S, H, F, d) tensors, RoPE done beforehand
        to_bhsd = lambda x: x.view(b, f, s, h, d).permute(0, 2, 3, 1, 4).reshape(b * s, h, f, d)  # noqa: E731
        if rope:
            cs, sn = cos.bfloat16()[:, None, None, :], sin.bfloat16()[:, None, None, :]
            qr = apply_rope_half(q.view(b, f, s, h, d), cs, sn)
            kr = apply_rope_half(k.view(b, f, s, h, d), cs, sn)
            qs, ks = to_bhsd(qr).contiguous(), to_bhsd(kr).contiguous()
        else:
            qs, ks = to_bhsd(q).contiguous(), to_bhsd(k).contiguous()
        vs = to_bhsd(v).contiguous()
        mask = bias.bfloat16() if rope else None
        if folded:
            name, fn, plain = "temporal_attention_folded", temporal_attention_folded, \
                temporal_attention_folded_reference
            args = (qr.reshape(q.shape), kr.reshape(k.shape), v, bias, d**-0.5, h)
            n_bytes = 4 * b * f * s * c * 2 + h * f * f * 4
        else:
            name, fn, plain = "temporal_attention", temporal_attention, temporal_attention_reference
            args = (q, k, v, bias, cos, sin, d**-0.5, rope, h)
            n_bytes = 4 * b * f * s * c * 2 + (h * f * f * 4 + 2 * f * (rope // 2) * 4 if rope else 0)
        # QKᵀ on bf16 operands can run on the tensor cores; P·V takes fp32 P
        half_flops = 2 * b * s * h * f * f * d
        rows.append(check_row(
            name, {"B": b, "F": f, "S": s, "H": h, "d": d},
            fn(*args), plain(*args), TEMPORAL_TOL, lambda: fn(*args), lambda: plain(*args),
            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=d**-0.5),
            n_bytes, ((half_flops, BF16_FLOPS), (half_flops, FP32_FLOPS))))
    return rows


def phase_geglu(f: int, shapes=None) -> list:
    """GEGLU at N = 2·F·S tokens of width C, the shapes of a path with F
    frames, or at the given (N, C) shapes."""
    from lavie_tpu_torch.kernels import geglu as gg

    g = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
            "geglu", {"N": n, "C": c, "I": inner}, gg.geglu(*args), gg.geglu_reference(*args),
            GEGLU_TOL, lambda: gg.geglu(*args), lambda: gg.geglu_reference(*args), None,
            (2 * n * c + 3 * inner * c + 2 * inner + c) * 2, ((6 * n * c * inner, BF16_FLOPS),),
            plain_iters=20, out_width=gg.launch_plan(n, c, sms).out.width))
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
        import lavie_tpu_torch.kernels.attention as dpa_mod
        import lavie_tpu_torch.nn.attention as attn_mod
        import lavie_tpu_torch.nn.resnet as res_mod
        import lavie_tpu_torch.nn.transformer as tr_mod
        import lavie_tpu_torch.nn.vae as vae_mod
        from lavie_tpu_torch.kernels import cross_attention as ca
        from lavie_tpu_torch.kernels import cross_block as cb
        from lavie_tpu_torch.kernels import flash_attention as fa
        from lavie_tpu_torch.kernels import geglu as gg
        from lavie_tpu_torch.kernels import temporal_fused as tf
        from lavie_tpu_torch.kernels import temporal_proj as tp
        from lavie_tpu_torch.kernels import temporal_resblock as tr

        return [
            (dpa_mod, "cross_attention", ca.cross_attention_reference),
            (tr_mod, "fused_ln_cross_attention", cb.fused_ln_cross_attention_reference),
            (tr_mod, "ln_qkv", tp.ln_qkv_reference),
            (tr_mod, "out_proj_residual", tp.out_proj_residual_reference),
            (attn_mod, "temporal_attention", tf.temporal_attention_reference),
            (attn_mod, "temporal_attention_folded", tf.temporal_attention_folded_reference),
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
    ("geglu", ("geglu_pingpong_kernel<", "geglu_coop_kernel<")),
    ("cross_attention (attn2=cross)", ("cross_kernel<", "cross_long_kernel<")),
    ("gn_silu_tconv", ("tconv_", "colsum_kernel", "act_absmax_kernel", "act_scale_kernel",
                       "act_quant_kernel")),
    ("temporal_proj", ("ln_qkv_", "out_proj_kernel<")),
    ("cross_attention_head", ("head_ln_kernel<", "head_gemm_kernel<", "head_attn_kernel")),
    ("transformer_tail", ("tail_gemm_", "tail_ln_kernel<")),
    ("flash d=512", ("flash_d512_kernel",)),
    ("flash d<=160 (sparse-causal, explicit kv, VSR L3)", ("flash_kernel<",)),
    ("attention (SDPA)", ("flash", "fmha", "attention", "softmax")),
    ("convolution", ("conv", "implicit", "winograd", "dgrad", "wgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("norm and elementwise", ("",)),
)


def device_kernels(prof):
    """(event, device µs) of every device kernel a torch.profiler run
    recorded, by name."""
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        # "Command Buffer Full" is the profiler's record of a stalled launch
        # queue, not device work: counting it put the busy share above 1;
        # "Activity Buffer Request" is the tracer's own
        if us <= 0 or e.key.startswith(("aten::", "cuda", "Memcpy", "Memset", "Command Buffer Full",
                                        "Activity Buffer Request")):
            continue
        yield e, us


def kernel_ms(fn, calls: int = 3):
    """Device ms of one call of fn by CUDA kernel (torch.profiler, the mean
    over `calls` calls), the kernels' names cut to their own (the template
    arguments dropped); "not measured" where the profiler recorded no
    kernel in three tries (a CPU and CUDA trace once came back without
    kernels for every row of a phase)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e, us in device_kernels(prof):
            key = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(")[0].split("<")[0].split("::")[-1] or e.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
        if out:
            return out
    return "not measured"


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
    for e, us in device_kernels(prof):
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
    """name → (wrapper, attribute holding its count); the stats and int8
    variants of gn_silu_tconv are counted on their own besides."""
    from lavie_tpu_torch.kernels.cross_attention import cross_attention
    from lavie_tpu_torch.kernels.cross_block import (
        cross_attention_head,
        fused_ln_cross_attention,
        transformer_tail,
    )
    from lavie_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_kv,
        flash_sparse_causal,
    )
    from lavie_tpu_torch.kernels.geglu import geglu
    from lavie_tpu_torch.kernels.temporal_fused import temporal_attention, temporal_attention_folded
    from lavie_tpu_torch.kernels.temporal_proj import ln_qkv, out_proj_residual
    from lavie_tpu_torch.kernels.temporal_resblock import gn_silu_tconv

    fns = {"temporal_attention": temporal_attention, "geglu": geglu,
           "flash_sparse_causal": flash_sparse_causal, "flash_attention_kv": flash_attention_kv,
           "flash_attention": flash_attention, "cross_attention_head": cross_attention_head,
           "transformer_tail": transformer_tail, "gn_silu_tconv": gn_silu_tconv,
           "temporal_attention_folded": temporal_attention_folded,
           "cross_attention": cross_attention, "fused_ln_cross_attention": fused_ln_cross_attention,
           "ln_qkv": ln_qkv, "out_proj_residual": out_proj_residual}
    counters = {name: (fn, "launches") for name, fn in fns.items()}
    counters["gn_silu_tconv_stats"] = (gn_silu_tconv, "stats_launches")
    counters["gn_silu_tconv_int8"] = (gn_silu_tconv, "int8_launches")
    return counters


def zero_launches() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


OPT_IN = ("temporal_attention_folded", "gn_silu_tconv_stats", "gn_silu_tconv_int8",
          "cross_attention", "fused_ln_cross_attention", "ln_qkv", "out_proj_residual")


def assert_default_routes(path: str, launches: dict) -> None:
    """A path run without the opt-in switches launches no opt-in entry."""
    for name in OPT_IN:
        if launches[name]:
            raise AssertionError(f"{name} launched {launches[name]} times on the {path} path")


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
    assert_default_routes("main", launches)
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
    assert_default_routes("tsr", launches)
    phase_profile("profile_tsr", pipe.unet, TSR_FRAMES)
    del pipe
    torch.cuda.empty_cache()
    return launches


def _valid_taps(frames: int, k: int) -> int:
    """(output frame, tap) pairs whose source frame lies inside the window."""
    from lavie_tpu_torch.kernels.temporal_resblock import valid_taps

    return sum(len(valid_taps(f, frames, k)) for f in range(frames))


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
        heads = c // 64
        # yardstick: the eager path on the module's own bf16 parameters
        wpi_b, bpi_b = hargs[1], hargs[2].bfloat16()
        layers_b = [tuple(t.bfloat16() for t in a) for a in hargs[3:5]]

        def head_eager():
            h = F.linear(x, wpi_b, bpi_b)
            for g1, b1, wq, wo, bo, kt, vt in layers_b:
                split = lambda t: t.view(1, -1, heads, 64).transpose(1, 2)  # noqa: E731
                o = F.scaled_dot_product_attention(
                    split(F.linear(F.layer_norm(h, (c,), g1, b1), wq)), split(kt), split(vt))
                h = F.linear(o.transpose(1, 2).reshape(1, n, c), wo, bo) + h
            return h

        rows["cross_attention_head"].append(check_row(
            "cross_attention_head", {"B": 1, "N": n, "C": c, "heads": heads, "L": lkv},
            cb.cross_attention_head(*hargs), cb.cross_attention_head_reference(*hargs), CROSS_TOL,
            lambda: cb.cross_attention_head(*hargs), lambda: cb.cross_attention_head_reference(*hargs),
            None, 2 * n * c * 2 + 5 * c * c * 2 + 4 * lkv * c * 2,
            ((2 * 5 * n * c * c + 2 * 2 * 2 * n * lkv * c, BF16_FLOPS),), eager_ms=time_ms(head_eager)))
        targs = (x, r, f32(c, m=1.0), f32(c), bf(8 * c, c, sd=c ** -0.5), f32(8 * c),
                 bf(c, 4 * c, sd=(4 * c) ** -0.5), f32(c), bf(c, c, sd=c ** -0.5), f32(c))
        # yardstick: the eager path on the module's own bf16 parameters
        g3, b3, w0, b0, w2, b2, wpo, bpo = (t.bfloat16() for t in targs[2:])

        def eager():
            hidden, gate = F.linear(F.layer_norm(x, (c,), g3, b3), w0, b0).chunk(2, dim=-1)
            return F.linear(F.linear(hidden * F.gelu(gate), w2, b2) + x, wpo, bpo) + r

        rows["transformer_tail"].append(check_row(
            "transformer_tail", {"N": n, "C": c, "I": 4 * c},
            cb.transformer_tail(*targs), cb.transformer_tail_reference(*targs), CROSS_TOL,
            lambda: cb.transformer_tail(*targs), lambda: cb.transformer_tail_reference(*targs),
            None, 3 * n * c * 2 + 13 * c * c * 2, ((26 * n * c * c, BF16_FLOPS),),
            eager_ms=time_ms(eager)))
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
    assert_default_routes("vsr", launches)
    phase_profile("profile_vsr", pipe.unet, VSR_FRAMES, batch=1, h=320, w=512, ctx_dim=1024)
    del pipe, out
    torch.cuda.empty_cache()
    return launches


class env:
    """Within the block the named environment variables hold the given
    values (None: unset); afterwards they are as they were."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        self._set(self.values)

    def __exit__(self, *exc):
        self._set(self.saved)

    @staticmethod
    def _set(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_optin_tconv() -> dict:
    """gn_silu_tconv's opt-in options at the VSR shapes (one CFG half of an
    8-frame window, then of the cascade's 5-frame tail window): emit_stats at
    the four levels (k=5, conv1 of the temporal modules' resblocks, the call
    that feeds norm2), timed beside the same call without statistics and
    beside the GroupNorm.affine(h) that the statistics replace; activation
    "none" at one shape."""
    from lavie_tpu_torch.kernels import temporal_resblock as tr
    from lavie_tpu_torch.nn.layers import GroupNorm

    g = torch.Generator(device="cuda").manual_seed(19)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    k = 5
    rows = {"stats": [], "none": []}
    for f, (s, c) in [(f_, level) for f_ in (VSR_FRAMES, 5) for level in VSR_LEVELS]:
        x, taps = bf(1, f, s, c), bf(k, c, c, sd=c ** -0.5)
        args = (x, f32(1, c, m=1.0), f32(1, c), taps, f32(1, c))
        got = tr.gn_silu_tconv(*args, emit_stats=True)
        want = tr.gn_silu_tconv_reference(*args, emit_stats=True)
        torch.cuda.synchronize()
        sum_errs = [(a - b_).abs().max().item() / b_.abs().max().item() for a, b_ in zip(got[1:], want[1:])]
        norm = GroupNorm(32, c, eps=1e-6).cuda()
        h = got[0]
        n_bytes = 2 * f * s * c * 2 + k * c * c * 2 + 3 * c * 4 + 2 * c * 4
        row = check_row(
            "gn_silu_tconv (emit_stats)", {"B": 1, "F": f, "S": s, "C": c, "O": c, "k": k},
            got[0], want[0], TCONV_TOL, lambda: tr.gn_silu_tconv(*args, emit_stats=True),
            lambda: tr.gn_silu_tconv_reference(*args, emit_stats=True), None, n_bytes,
            ((2 * _valid_taps(f, k) * s * c * c, BF16_FLOPS),),
            ms_without_stats=time_ms(lambda: tr.gn_silu_tconv(*args)),
            groupnorm_affine_ms=time_ms(lambda: norm.affine(h)),
            sums_err_of_max=sum_errs)
        if max(sum_errs) > STATS_TOL:
            raise AssertionError(f"gn_silu_tconv sums at S={s} C={c}: {sum_errs} > {STATS_TOL} of max|plain|")
        rows["stats"].append(row)
        del x, got, want, h, args
    # activation "none" (a plain temporal conv + residual) at the L2 width
    f, (s, c) = VSR_FRAMES, VSR_LEVELS[2]
    args = (bf(1, f, s, c), None, None, bf(3, c, c, sd=c ** -0.5), f32(1, c), bf(1, f, s, c))
    rows["none"].append(check_row(
        "gn_silu_tconv (activation none)", {"B": 1, "F": f, "S": s, "C": c, "O": c, "k": 3,
                                            "residual": True},
        tr.gn_silu_tconv(*args, activation="none"),
        tr.gn_silu_tconv_reference(*args, activation="none"), TCONV_TOL,
        lambda: tr.gn_silu_tconv(*args, activation="none"),
        lambda: tr.gn_silu_tconv_reference(*args, activation="none"), None,
        3 * f * s * c * 2 + 3 * c * c * 2 + c * 4, ((2 * _valid_taps(f, 3) * s * c * c, BF16_FLOPS),)))
    torch.cuda.empty_cache()
    return rows


def phase_ab(phase: str, cfg, frames: int, switch: str, routes: dict, tol: float, batch: int,
             h: int, w: int, ctx_dim: int) -> dict:
    """One full-width UNet forward with the opt-in `switch` unset and set to
    each value of `routes` (value → the counters its route launches), same
    weights and inputs: ms of each (one warm-up each, then unset, each value,
    each value in reverse, unset) between CUDA events, which a host-bound
    forward fills with launch overhead, and the device time of its kernels
    under torch.profiler (device_ms), each route's launches (its own
    counters, and no other route's), and each output against the unset
    one."""
    from torch.profiler import ProfilerActivity, profile

    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        unet = UNet3D(cfg).to(torch.bfloat16).eval()
    random_init_(unet, seed=7)
    x, ts, ctx, labels = unet_inputs(cfg, batch, frames, h, w, ctx_dim, seed=3, t=981.0)
    values = [None, *routes]
    watched = sorted({n for names in routes.values() for n in names})
    outs, times, device, counts = {}, {v: [] for v in values}, {v: [] for v in values}, {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        for value in values + values[:1] + values[1:] + values[1:][::-1] + values[:1]:
            with env(**{switch: value}):
                zero_launches()
                torch.cuda.synchronize()
                start.record()
                out = unet(x, ts, ctx, labels)
                end.record()
                torch.cuda.synchronize()
                launches = read_launches()
                if value in outs:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        unet(x, ts, ctx, labels)
                        torch.cuda.synchronize()
                    device[value].append(sum(us for _, us in device_kernels(prof)) / 1e3)
            if value not in outs:  # the first run of each setting is its warm-up
                outs[value] = out.float()
                counts[value] = {name: launches[name] for name in watched}
                for name in watched:
                    if (launches[name] > 0) != (name in routes.get(value, ())):
                        raise AssertionError(f"{phase}: {name} launched {launches[name]} times with "
                                             f"{switch}={value}")
            else:
                times[value].append(start.elapsed_time(end))
    label = lambda v: "unset" if v is None else v  # noqa: E731
    scale = outs[None].abs().max().item()
    diffs = {label(v): (outs[v] - outs[None]).abs().max().item() for v in routes}
    row = {"phase": phase, "switch": switch, "shape": list(x.shape),
           "ms": {label(v): times[v] for v in values},
           "mean_ms": {label(v): sum(times[v]) / len(times[v]) for v in values},
           "device_ms": {label(v): device[v] for v in values},
           "mean_device_ms": {label(v): sum(device[v]) / len(device[v]) for v in values},
           "max_abs_diff": diffs, "max_abs_ref": scale,
           "launches": {label(v): counts[v] for v in values}}
    log(json.dumps(row))
    for v in routes:
        if not (bool(torch.isfinite(outs[v]).all()) and diffs[v] <= tol * scale):
            raise AssertionError(f"{phase}: {switch}={v} vs unset: {diffs[v]} > {tol}·{scale}")
    del unet, outs
    torch.cuda.empty_cache()
    return row


def phase_cross_kernels() -> dict:
    """The text cross-attention at every base level (B=2, the 16 frames
    folded into the queries), at TSR L0 (B=2, 61 frames) and at VSR L3 (one
    CFG half of one window),
    77 text keys: cross_attention (LAVIE_ATTN2=cross) against its plain
    version and SDPA on tensors transposed beforehand (and the kernel
    launched under a plan computed once, launch_ms); then
    fused_ln_cross_attention (LAVIE_ATTN2=fused) against its plain version,
    timed beside the default path it replaces (LayerNorm, q projection, SDPA,
    out-projection, residual: eager, cuBLAS and SDPA)."""
    from lavie_tpu_torch.kernels import cross_attention as ca
    from lavie_tpu_torch.kernels import cross_block as cb

    g = torch.Generator(device="cuda").manual_seed(31)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    levels = ([("base", 2, 16 * s, d) for s, d in ATTENTION_LEVELS]
              + [("TSR L0", 2, TSR_FRAMES * ATTENTION_LEVELS[0][0], ATTENTION_LEVELS[0][1]),
                 ("VSR L3", 1, VSR_FRAMES * 2560, 128)])
    rows = {"cross_attention": [], "fused_ln_cross_attention": []}
    h, lkv = 8, 77
    for where, b, n, d in levels:
        c, scale = h * d, d ** -0.5
        q, k, v = bf(b, n, h, d), bf(b, lkv, h, d), bf(b, lkv, h, d)
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        args = (q, k, v, scale)
        # the kernel alone, its plan computed once: the wrapper's checks and
        # plan lookup cost host time a call, which the small levels expose
        plan = ca.launch_plan(b, n, h, d, lkv, torch.cuda.get_device_properties(0).multi_processor_count)
        rows["cross_attention"].append(check_row(
            "cross_attention", {"where": where, "B": b, "S": n, "H": h, "d": d, "L": lkv},
            ca.cross_attention(*args), ca.cross_attention_reference(*args), ATTN_TOL,
            lambda: ca.cross_attention(*args), lambda: ca.cross_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale),
            (2 * b * n * c + 2 * b * lkv * c) * 2, ((4 * b * h * n * lkv * d, BF16_FLOPS),),
            launch_ms=time_ms(lambda: ca._launch(*args, plan))))
        del q, ql, kl, vl, args
        x = bf(b, n, c)
        p = (f32(c, m=1.0), f32(c), bf(c, c, sd=c ** -0.5), bf(c, c, sd=c ** -0.5), f32(c),
             k.view(b, lkv, c), v.view(b, lkv, c))
        fargs = (x, p, h, scale)
        gamma, beta, wq, wo, bo = (t.bfloat16() for t in p[:5])  # the module's own bf16 parameters
        kt, vt = (t.transpose(1, 2) for t in (k, v))

        def unfused():
            qq = F.linear(F.layer_norm(x, (c,), gamma, beta), wq).view(b, n, h, d).transpose(1, 2)
            o = F.scaled_dot_product_attention(qq, kt, vt, scale=scale)
            return F.linear(o.transpose(1, 2).reshape(b, n, c), wo, bo) + x

        rows["fused_ln_cross_attention"].append(check_row(
            "fused_ln_cross_attention", {"where": where, "B": b, "N": n, "C": c, "heads": h, "L": lkv},
            cb.fused_ln_cross_attention(*fargs), cb.fused_ln_cross_attention_reference(*fargs),
            CROSS_TOL, lambda: cb.fused_ln_cross_attention(*fargs),
            lambda: cb.fused_ln_cross_attention_reference(*fargs), None,
            (2 * b * n * c + 2 * c * c + 2 * b * lkv * c) * 2 + 3 * c * 4,
            ((4 * b * n * c * c + 4 * b * n * lkv * c, BF16_FLOPS),), unfused_ms=time_ms(unfused)))
        del x, p, fargs, k, v, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_temporal_proj_kernels() -> dict:
    """The temporal attention's boundaries at every base level (B=2, F=16),
    every TSR level (B=2, F=61) and every VSR level with temporal attention
    (B=1, one CFG half, F=8), E = C: ln_qkv (LAVIE_TEMPORAL_PROJ=1) against
    its plain version, timed beside the default path's LayerNorm and three
    projections (eager and cuBLAS), its bound given with and without the
    LayerNorm's xn round trip through device memory; out_proj_residual
    against its plain version, timed beside F.linear and the residual add."""
    from lavie_tpu_torch.kernels import temporal_proj as tp

    g = torch.Generator(device="cuda").manual_seed(32)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    levels = [("base", 2, 16, s, c) for (s, _), c in zip(ATTENTION_LEVELS, GEGLU_WIDTHS)]
    levels += [(f"TSR L{i}", 2, TSR_FRAMES, s, c)
               for i, ((s, _), c) in enumerate(zip(ATTENTION_LEVELS, GEGLU_WIDTHS))]
    levels += [(f"VSR L{i + 1}", 1, VSR_FRAMES, s, c) for i, (s, c) in enumerate(VSR_LEVELS[1:])]
    rows = {"ln_qkv": [], "out_proj_residual": []}
    for where, b, f, s, c in levels:
        n = b * f * s
        x, o = bf(b, f, s, c), bf(b, f, s, c)
        gamma, beta, bo = f32(c, m=1.0), f32(c), f32(c)
        wq, wk, wv, wo = (bf(c, c, sd=c ** -0.5) for _ in range(4))
        args = (x, gamma, beta, wq, wk, wv)
        gb, bb, bob = gamma.bfloat16(), beta.bfloat16(), bo.bfloat16()
        shape = {"where": where, "B": b, "F": f, "S": s, "C": c, "E": c}
        rows["ln_qkv"].append(check_row(
            "ln_qkv", shape, torch.stack(tp.ln_qkv(*args)), torch.stack(tp.ln_qkv_reference(*args)),
            PROJ_TOL, lambda: tp.ln_qkv(*args), lambda: tp.ln_qkv_reference(*args), None,
            (n * c + 3 * n * c + 3 * c * c) * 2 + 2 * c * 4, ((6 * n * c * c, BF16_FLOPS),),
            eager_ms=time_ms(lambda: [F.linear(xn, w) for xn in (F.layer_norm(x, (c,), gb, bb),)
                                      for w in (wq, wk, wv)]),
            bound_with_xn_ms=bound((3 * n * c + 3 * n * c + 3 * c * c) * 2 + 2 * c * 4,
                                   ((6 * n * c * c, BF16_FLOPS),))[0],
            kernels_ms=kernel_ms(lambda: tp.ln_qkv(*args))))
        oargs = (o, x, wo, bo)
        rows["out_proj_residual"].append(check_row(
            "out_proj_residual", {**shape, "O": c}, tp.out_proj_residual(*oargs),
            tp.out_proj_residual_reference(*oargs), PROJ_TOL, lambda: tp.out_proj_residual(*oargs),
            lambda: tp.out_proj_residual_reference(*oargs), None, 3 * n * c * 2 + c * c * 2 + c * 4,
            ((2 * n * c * c, BF16_FLOPS),), eager_ms=time_ms(lambda: F.linear(o, wo, bob) + x)))
        del x, o, args, oargs
    torch.cuda.empty_cache()
    return rows


def turbo_tconv_sites(cfg, h: int, w: int, frames: int) -> tuple:
    """(S, C) of each temporal module whose ResnetBlock3DCNN takes the int8
    kernel in turbo, from the UNet's structure at h x w latents: (those in the
    shared prefix, those in one CFG half). Down block i's module runs after
    its downsampler, up block i's after its upsampler; the gate is the port's
    (the JAX package's): equal widths of at least MIN_CHANNELS and the fused
    gate for both convs."""
    from lavie_tpu_torch.kernels.temporal_resblock import resblock_conv_supported
    from lavie_tpu_torch.nn import quant

    boc, n = cfg.block_out_channels, len(cfg.block_out_channels)
    size = lambda lvl: (h >> lvl) * (w >> lvl)  # noqa: E731
    down = [(size(min(i + 1, n - 1)), c) for i, c in enumerate(boc)]
    rest = [(size(n - 1), boc[-1])] + [(size(max(n - 2 - i, 0)), c) for i, c in enumerate(reversed(boc))]
    n_prefix = next(i for i, t in enumerate(cfg.down_block_types + ("",)) if t != "DownBlock3D")
    ok = lambda s_, c: (c >= quant.MIN_CHANNELS  # noqa: E731
                        and resblock_conv_supported(frames, s_, c, c, 5)
                        and resblock_conv_supported(frames, s_, c, c, 3, with_res=True))
    return ([x for x in down[:n_prefix] if ok(*x)],
            [x for x in down[n_prefix:] + rest if ok(*x)])


def phase_turbo_kernels() -> dict:
    """The int8 variant of gn_silu_tconv at the VSR shapes where turbo runs
    it (one CFG half, one window), against its plain version (exact integer
    products), timed beside the float kernel at the same inputs; then
    int8_conv2d at three shapes, its int32 product checked exactly on bands
    of rows, timed beside cuDNN's bf16 conv."""
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.kernels import temporal_resblock as tr
    from lavie_tpu_torch.nn import quant

    g = torch.Generator(device="cuda").manual_seed(29)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    prefix, half = turbo_tconv_sites(UNetConfig.vsr(), 320, 512, VSR_FRAMES)
    shapes = sorted(set(prefix + half), reverse=True)
    rows = {"gn_silu_tconv_int8": [], "int8_conv2d": []}
    for s, c in shapes:
        for f in (VSR_FRAMES, 5):
            for k, with_res in ((5, False), (3, True)):
                stats = f == 5 and k == 5  # the tail's conv1 with its statistics
                x = bf(1, f, s, c)
                args = (x, f32(1, c, m=1.0), f32(1, c), bf(k, c, c, sd=c ** -0.5), f32(1, c),
                        bf(1, f, s, c) if with_res else None)
                kw = dict(quant="int8", emit_stats=stats)
                got, want = tr.gn_silu_tconv(*args, **kw), tr.gn_silu_tconv_reference(*args, **kw)
                if stats:
                    torch.cuda.synchronize()
                    sums_err = [(a - b_).abs().max().item() / b_.abs().max().item()
                                for a, b_ in zip(got[1:], want[1:])]
                    if max(sums_err) > STATS_TOL:
                        raise AssertionError(f"int8 gn_silu_tconv sums at S={s} C={c}: {sums_err}")
                    got, want = got[0], want[0]
                n_bytes = (2 + with_res) * f * s * c * 2 + k * c * c + 3 * c * 4
                blk = tr._pick_block(s, f, c, c, k, with_res, 2, "int8")
                rows["gn_silu_tconv_int8"].append(check_row(
                    "gn_silu_tconv (int8)",
                    {"B": 1, "F": f, "S": s, "C": c, "O": c, "k": k, "residual": with_res,
                     "emit_stats": stats, "scale_block": blk},
                    got, want, TCONV_TOL, lambda: tr.gn_silu_tconv(*args, **kw),
                    lambda: tr.gn_silu_tconv_reference(*args, **kw), None, n_bytes,
                    ((2 * _valid_taps(f, k) * s * c * c, INT8_OPS),), plain_iters=1, iters=10,
                    float_ms=time_ms(lambda: tr.gn_silu_tconv(*args, emit_stats=stats), 10),
                    kernels_ms=kernel_ms(lambda: tr.gn_silu_tconv(*args, **kw))))
                del x, args, got, want
    torch.cuda.empty_cache()

    # int8_conv2d: base L0 (2 CFG x 16 frames), VSR L0 (one 8-frame window),
    # one f4-VAE frame at full resolution (decode_up's last level)
    for name, (n, h, w, c) in (("base L0", (32, 40, 64, 320)), ("VSR L0", (8, 320, 512, 256)),
                               ("VAE frame", (1, 1280, 2048, 128))):
        x = bf(n, h, w, c)
        weight, bias = bf(c, c, 3, 3, sd=(9 * c) ** -0.5), f32(c).bfloat16()
        pad = ((1, 1), (1, 1))
        xq, _ = quant.quantize(x)
        wq, _ = quant.quantize(weight)
        prod = quant.int_conv(xq, wq, (1, 1), pad)
        # exact on 8 output rows at the top of the first sample and at the
        # bottom of the last, each from its input rows and the zero padding
        band = 8
        top = quant.int_conv_reference(xq[:1, :band + 1], wq, (1, 1), ((1, 0), (1, 1)))
        bottom = quant.int_conv_reference(xq[-1:, h - band - 1:], wq, (1, 1), ((0, 1), (1, 1)))
        exact = (torch.equal(prod[:1, :band].double(), top)
                 and torch.equal(prod[-1:, h - band:].double(), bottom))
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory, as InflatedConv hands cuDNN
        run = lambda: quant.int8_conv2d(x, weight, bias, (1, 1), pad)  # noqa: E731
        out = run()
        ref = F.conv2d(x_nchw, weight, bias, padding=1).permute(0, 2, 3, 1)
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        bound_ms, bound_by = bound(2 * n * h * w * c * 2 + 9 * c * c * 2,
                                   ((2 * n * h * w * 9 * c * c, INT8_OPS),))
        row = {"kernel": "int8_conv2d", "shape": {"where": name, "N": n, "H": h, "W": w, "C": c, "O": c},
               "product_exact": exact, "rel_err_vs_bf16": rel,
               "ms": time_ms(run, 5, 2), "product_ms": time_ms(lambda: quant.int_conv(xq, wq, (1, 1), pad), 5, 2),
               "library_ms": time_ms(lambda: F.conv2d(x_nchw, weight, bias, padding=1), 10),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "im2col_bytes": n * h * w * 9 * c}
        log(json.dumps(row))
        rows["int8_conv2d"].append(row)
        if not (exact and bool(torch.isfinite(out).all()) and rel < 0.05):
            raise AssertionError(f"int8_conv2d at {name}: exact {exact}, rel err {rel}")
        del x, xq, prod, out, ref, x_nchw
        torch.cuda.empty_cache()
    return rows


def phase_ab_turbo(phase: str, cfg, frames: int, batch: int, h: int, w: int, ctx_dim: int) -> dict:
    """One full-width UNet forward, same weights and inputs, with conv_quant
    "none", "int8" with LAVIE_TRESBLOCK_INT8=1, and "int8" excluding
    TURBO_EXCLUDE (switch set): device ms (CUDA events, after one warm-up
    each) and the relative L2 error of each turbo output against bf16."""
    from lavie_tpu_torch.nn import quant
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        unet = UNet3D(cfg).to(torch.bfloat16).eval()
    random_init_(unet, seed=7)
    x, ts, ctx, labels = unet_inputs(cfg, batch, frames, h, w, ctx_dim, seed=3, t=981.0)
    prefix, half = turbo_tconv_sites(cfg, h, w, frames) if cfg.use_temporal_modules else ([], [])
    want_int8 = 2 * (len(prefix) + len(half))  # one whole forward
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    row = {"phase": phase, "shape": list(x.shape), "runs": []}
    outs = {}
    with torch.no_grad():
        for name, mode, exclude in (("bf16", "none", ()), ("int8", "int8", ()),
                                    ("int8_excluding", "int8", TURBO_EXCLUDE)):
            quant.configure(unet, mode, exclude)
            with env(LAVIE_TRESBLOCK_INT8="1" if mode == "int8" else None):
                unet(x, ts, ctx, labels)
                zero_launches()
                torch.cuda.synchronize()
                start.record()
                out = unet(x, ts, ctx, labels)
                end.record()
                torch.cuda.synchronize()
                launches = read_launches()
            outs[name] = out.float()
            run = {"conv_quant": mode, "exclude": list(exclude), "device_ms": start.elapsed_time(end),
                   "gn_silu_tconv_int8": launches["gn_silu_tconv_int8"]}
            if name != "bf16":
                run["rel_err_vs_bf16"] = ((outs[name] - outs["bf16"]).norm() / outs["bf16"].norm()).item()
            row["runs"].append(run)
            if launches["gn_silu_tconv_int8"] != (want_int8 if mode == "int8" else 0):
                raise AssertionError(f"{phase} {name}: {launches['gn_silu_tconv_int8']} int8 tconv "
                                     f"launches, expected {want_int8 if mode == 'int8' else 0}")
    log(json.dumps(row))
    for run in row["runs"][1:]:
        if not 0.0 < run["rel_err_vs_bf16"] < TURBO_REL_TOL:
            raise AssertionError(f"{phase}: turbo vs bf16 {run['rel_err_vs_bf16']} not in (0, {TURBO_REL_TOL})")
    if not all(bool(torch.isfinite(o).all()) for o in outs.values()):
        raise AssertionError(f"{phase}: non-finite output")
    del unet, outs
    torch.cuda.empty_cache()
    return row


class TimedStage:
    """Wraps one stage pipeline of the cascade: times each call (host clock,
    synchronised) and records the launches made within it and the shape of
    its video; every other attribute is the stage's."""

    def __init__(self, name: str, stage):
        self.name, self.stage, self.calls = name, stage, []

    def __getattr__(self, attr):
        return getattr(self.stage, attr)

    def __call__(self, *args, **kw):
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = self.stage(*args, **kw)
        torch.cuda.synchronize()
        secs = time.time() - t0
        after = read_launches()
        self.calls.append({"stage": self.name, "seconds": secs, "shape": list(out.video.shape),
                           "dtype": out.video.dtype.name,
                           "launches": {n: after[n] - before[n] for n in after}})
        return out


def expected_stage_launches(stage: str, steps: int, folded: bool, stats: bool, windows: int = 1,
                            int8_per_step: int = 0, attn2_fused: bool = False,
                            temporal_proj: bool = False) -> dict:
    """Exact launches of one cascade stage (per forward counts as the main,
    tsr and vsr phases hold them); `int8_per_step`: the int8 temporal convs
    of one VSR step over all windows (turbo_tconv_sites). Every transformer
    block has one temporal attention and, but for VSR's only-cross blocks,
    one attn2 (fused under LAVIE_ATTN2=fused)."""
    n = dict.fromkeys(launch_counters(), 0)
    temporal = "temporal_attention_folded" if folded else "temporal_attention"
    if stage == "base":  # 16 transformer blocks per CFG-batched forward
        n.update({temporal: 16 * steps, "geglu": 16 * steps})
        blocks, attn2 = 16 * steps, 16 * steps
    elif stage == "interpolation":
        n.update({"temporal_attention": 16 * steps, "geglu": 16 * steps,
                  "flash_sparse_causal": 16 * steps})
        blocks, attn2 = 16 * steps, 16 * steps
    else:  # per window: the vsr phase's counts
        n.update({"gn_silu_tconv": 98 * steps * windows, "cross_attention_head": 20 * steps * windows,
                  "transformer_tail": 20 * steps * windows,
                  "flash_attention": (12 * steps + 1) * windows, temporal: 32 * steps * windows,
                  "geglu": 12 * steps * windows})
        if stats:
            n["gn_silu_tconv_stats"] = 49 * steps * windows
        n["gn_silu_tconv_int8"] = int8_per_step * steps
        blocks, attn2 = 32 * steps * windows, 12 * steps * windows
    if attn2_fused:
        n["fused_ln_cross_attention"] = attn2
    if temporal_proj:
        n["ln_qkv"] = n["out_proj_residual"] = blocks
    return n


def phase_cascade() -> dict:
    """The serving entry point at full width: Predictor().setup() once and
    predict(...) for option 2 (16 → 61 frames at 320x512, 50 DDPM base
    steps, 50 DDIM TSR steps), which writes its file; then, that predictor
    freed, a second one in turbo, Predictor().setup(conv_quant="int8"), and
    its cascade pipeline for option 4 (16x320x512 → 61x320x512 →
    61x1280x2048: seven VSR windows of 8 and a tail of 5) with
    LAVIE_TRESBLOCK_STATS=1, LAVIE_TEMPORAL_KERNEL=1, LAVIE_TRESBLOCK_INT8=1,
    LAVIE_ATTN2=fused and LAVIE_TEMPORAL_PROJ=1, its video not written. Stage seconds come from
    wrapping each stage here (TimedStage)."""
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.serve import Predictor

    prompt = "a teddy bear walking on the street, 2k, high quality"
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cascade")
    os.makedirs(out_dir, exist_ok=True)
    launches = dict.fromkeys(launch_counters(), 0)
    switches = {"LAVIE_TRESBLOCK_STATS": "1", "LAVIE_TEMPORAL_KERNEL": "1", "LAVIE_TRESBLOCK_INT8": "1",
                "LAVIE_ATTN2": "fused", "LAVIE_TEMPORAL_PROJ": "1"}
    for option, conv_quant, on in ((2, "none", {}), (4, "int8", switches)):
        t0 = time.time()
        predictor = Predictor()
        predictor.setup(conv_quant=conv_quant)  # full width, bf16, on the card, seeded random weights
        torch.cuda.synchronize()
        log(f"[cascade] setup (conv_quant {conv_quant}) {time.time() - t0:.1f} s")
        cascade = predictor.pipeline
        stages = [TimedStage("base", cascade.base), TimedStage("interpolation", cascade.interpolation),
                  TimedStage("vsr", cascade.vsr)]
        cascade.base, cascade.interpolation, cascade.vsr = stages
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with env(**on):
            if option == 2:
                path = predictor.predict(prompt, output_path=os.path.join(out_dir, "option2.mp4"),
                                         seed=0, interpolation=True, super_resolution=False)
                ok = os.path.getsize(path) > 0
                video_shape = stages[1].calls[0]["shape"][1:]
            else:
                out = cascade(prompt, interpolation=True, super_resolution=True,
                              vsr_steps=CASCADE_VSR_STEPS, seed=0, keep_intermediates=True)
                path = None
                video_shape = list(out.video.shape)
                ok = (out.video.dtype.name == "uint8" and out.base_video.shape == (16, 320, 512, 3)
                      and out.interpolated_video.shape == (TSR_FRAMES, 320, 512, 3))
                del out
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = read_launches()
        calls = [c for st in stages for c in st.calls]
        want_shape = [TSR_FRAMES, 320, 512, 3] if option == 2 else [TSR_FRAMES, 1280, 2048, 3]
        row = {"phase": "cascade", "option": option, "conv_quant": conv_quant, "switches": on,
               "seconds": secs, "stages": calls, "shape": video_shape, "dtype": "uint8",
               "written": path, "writer": path and os.path.splitext(path)[1],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": got}
        if option == 4:
            row["cut"] = {"vsr_steps": CASCADE_VSR_STEPS}
        log(json.dumps(row))
        if not ok or video_shape != want_shape:
            raise AssertionError(f"cascade option {option}: bad output {video_shape} (ok={ok})")
        folded = stats = option == 4
        frames = [VSR_FRAMES] * (TSR_FRAMES // VSR_FRAMES) + [TSR_FRAMES % VSR_FRAMES]
        int8_per_step = 0
        if conv_quant == "int8":  # the shared prefix once and both CFG halves, every window
            for f in frames:
                prefix, half = turbo_tconv_sites(UNetConfig.vsr(), 320, 512, f)
                int8_per_step += 2 * len(prefix) + 2 * 2 * len(half)
        routes = dict(attn2_fused=option == 4, temporal_proj=option == 4)
        want = {"base": expected_stage_launches("base", 50, folded, stats, **routes),
                "interpolation": expected_stage_launches("interpolation", TSR_STEPS, folded, stats,
                                                         **routes)}
        if option == 4:
            want["vsr"] = expected_stage_launches("vsr", CASCADE_VSR_STEPS, folded, stats, len(frames),
                                                  int8_per_step, **routes)
        if [c["stage"] for c in calls] != list(want):
            raise AssertionError(f"cascade option {option} ran stages {[c['stage'] for c in calls]}")
        for c in calls:
            if c["launches"] != want[c["stage"]]:
                raise AssertionError(f"cascade option {option}, {c['stage']}: launches {c['launches']}, "
                                     f"expected {want[c['stage']]}")
        for name in got:
            launches[name] += got[name]
        del predictor, cascade, stages
        torch.cuda.empty_cache()
    missing = [name for name in OPT_IN if name != "cross_attention" and not launches[name]]
    if missing:  # LAVIE_ATTN2 takes one of its two routes: fused
        raise AssertionError(f"opt-in entries not launched on the cascade path: {missing}")
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
    # the opt-in routes: kernels, then each route in the model against the default
    folded_rows = phase_temporal(16, rope=32, folded=True)
    phase_temporal(VSR_FRAMES, rope=32, b=1, folded=True,
                   levels=[(s, 64) for s, _ in VSR_LEVELS[1:3]] + [(VSR_LEVELS[3][0], 128)])
    optin_rows = phase_optin_tconv()
    phase_ab("ab_vsr", UNetConfig.vsr(), VSR_FRAMES, "LAVIE_TRESBLOCK_STATS",
             {"1": ("gn_silu_tconv_stats",)}, MODEL_TOL["model_vsr"], batch=1, h=320, w=512,
             ctx_dim=1024)
    phase_ab("ab_base", UNetConfig.base_t2v(), 16, "LAVIE_TEMPORAL_KERNEL",
             {"1": ("temporal_attention_folded",)}, MODEL_TOL["model"], batch=2, h=40, w=64,
             ctx_dim=768)
    # the text cross-attention and the temporal projection boundaries: kernels,
    # then each route in the base model against the default
    cross_rows = phase_cross_kernels()
    proj_rows = phase_temporal_proj_kernels()
    ab_attn2_launches = phase_ab("ab_attn2", UNetConfig.base_t2v(), 16, "LAVIE_ATTN2",
             {"cross": ("cross_attention",), "fused": ("fused_ln_cross_attention",)},
             MODEL_TOL["model"], batch=2, h=40, w=64, ctx_dim=768)["launches"]
    ab_proj_launches = phase_ab("ab_temporal_proj", UNetConfig.base_t2v(), 16, "LAVIE_TEMPORAL_PROJ",
                                {"1": ("ln_qkv", "out_proj_residual")}, MODEL_TOL["model"], batch=2,
                                h=40, w=64, ctx_dim=768)["launches"]
    # the int8 turbo mode: its pieces, then each UNet in the three settings
    turbo_rows = phase_turbo_kernels()
    phase_ab_turbo("ab_turbo_vsr", UNetConfig.vsr(), VSR_FRAMES, batch=1, h=320, w=512, ctx_dim=1024)
    phase_ab_turbo("ab_turbo_base", UNetConfig.base_t2v(), 16, batch=2, h=40, w=64, ctx_dim=768)
    cascade_launches = phase_cascade()

    def entry(name, source, replaces, row, note=None, counter=None, ab=None):
        counter = counter or name
        by_path = {"main": main_launches[counter], "tsr": tsr_launches[counter],
                   "vsr": vsr_launches[counter], "cascade": cascade_launches[counter]}
        if ab is not None:  # the launches of one A/B forward with the route set
            by_path["ab"] = ab[counter]
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"], "shape": row["shape"]}
        if note:
            e["note"] = note
        return e

    tconv = entry("gn_silu_tconv", "lavie_tpu_torch/csrc/temporal_resblock.cu",
                  "lavie_tpu/kernels/temporal_resblock.py:398", vsr_rows["gn_silu_tconv"][0],
                  note="also replaces gn_silu_tconv_sfc, lavie_tpu/kernels/temporal_resblock.py:306: "
                       "the port keeps video frame-major at that call site too")
    stats_row = optin_rows["stats"][0]
    tconv["stats_variant"] = {
        **entry("gn_silu_tconv (emit_stats)", tconv["source"], tconv["replaces"], stats_row,
                counter="gn_silu_tconv_stats"),
        "ms_without_stats": stats_row["ms_without_stats"],
        "groupnorm_affine_ms": stats_row["groupnorm_affine_ms"],
        "sums_err_of_max": stats_row["sums_err_of_max"]}
    int8_row = turbo_rows["gn_silu_tconv_int8"][0]  # the largest shape, F=8, k=5
    tconv["int8_variant"] = {
        **entry("gn_silu_tconv (int8)", tconv["source"], "lavie_tpu/kernels/temporal_resblock.py:306",
                int8_row, counter="gn_silu_tconv_int8",
                note="quant=\"int8\" of gn_silu_tconv_sfc (_kernel_sfc :182-209), entry "
                     "gn_silu_tconv_int8_bf16; turbo (LAVIE_TRESBLOCK_INT8=1 with conv_quant int8): "
                     "launched on the cascade path only"),
        "float_ms": int8_row["float_ms"]}
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
        entry("cross_attention_head", "lavie_tpu_torch/csrc/cross_head.cu",
              "lavie_tpu/kernels/cross_block.py:383", vsr_rows["cross_attention_head"][0]),
        entry("transformer_tail", "lavie_tpu_torch/csrc/transformer_tail.cu",
              "lavie_tpu/kernels/cross_block.py:441", vsr_rows["transformer_tail"][0]),
        tconv,
        entry("temporal_attention_folded", "lavie_tpu_torch/csrc/temporal_fused.cu",
              "lavie_tpu/kernels/temporal_attention.py:120", folded_rows[0],
              note="the temporal kernel without its RoPE, on q/k rotated by the caller; "
                   "opt-in (LAVIE_TEMPORAL_KERNEL=1): launched on the cascade path only"),
        entry("cross_attention", "lavie_tpu_torch/csrc/cross_attention.cu",
              "lavie_tpu/kernels/cross_attention.py:75", cross_rows["cross_attention"][0],
              note="opt-in (LAVIE_ATTN2=cross); the cascade path takes LAVIE_ATTN2=fused, so its "
                   "in-model launches are those of the ab_attn2 phase",
              ab=ab_attn2_launches["cross"]),
        entry("fused_ln_cross_attention", "lavie_tpu_torch/csrc/cross_block.cu",
              "lavie_tpu/kernels/cross_block.py:293", cross_rows["fused_ln_cross_attention"][0],
              note="opt-in (LAVIE_ATTN2=fused): launched on the cascade path and in ab_attn2",
              ab=ab_attn2_launches["fused"]),
        entry("ln_qkv", "lavie_tpu_torch/csrc/temporal_proj.cu", "lavie_tpu/kernels/temporal_proj.py:69",
              proj_rows["ln_qkv"][0],
              note="opt-in (LAVIE_TEMPORAL_PROJ=1): launched on the cascade path and in ab_temporal_proj",
              ab=ab_proj_launches["1"]),
        entry("out_proj_residual", "lavie_tpu_torch/csrc/temporal_proj.cu",
              "lavie_tpu/kernels/temporal_proj.py:141", proj_rows["out_proj_residual"][0],
              note="opt-in (LAVIE_TEMPORAL_PROJ=1): launched on the cascade path and in ab_temporal_proj",
              ab=ab_proj_launches["1"]),
    ]}))
    log(f"[chip_smoke] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
