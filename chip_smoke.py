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
                or int8), ln_qkv or out-projection GEMM, or fused attn2
                GEMM or attention instance whose SASS lacks an op of
                SASS_REQUIRED (wgmma or mma, and TMA loads; multicast TMA
                loads in the d=512 flash kernel; TMA stores where the
                staged GEMM stores its tiles)
  2b. group_norm  GroupNorm's two kernels (csrc/group_norm.cu) at the base,
                TSR and VAE shapes of GROUP_NORM_SHAPES against their plain
                version, timed beside it, the eager ops they replaced and
                F.group_norm (a yardstick only), with their bound and device
                ms by kernel; the profile phases count their calls a forward
  2c. bias_residual  the residual kernel with the convs' biases
                (csrc/bias_residual.cu) at the largest residual of each UNet
                (BIAS_RESIDUAL_SHAPES) against its plain version bit for
                bit, timed beside it and the parent's add_ + add, with its
                bound and the device ms of both; the main and profile phases
                count its launches
  3. kernels    each kernel at every base-path and TSR-path shape against its
                plain PyTorch version in bf16 (tolerance relative to
                max|plain|), timed with CUDA events beside the plain version
                and, where one PyTorch call computes the same function,
                F.scaled_dot_product_attention (a yardstick only: the port
                never calls it); the explicit-kv flash entry runs here only.
                Then what a frame shard calls anew (phase_mesh_kernels):
                flash_sparse_causal with its anchor and halo operands on
                frames [31, 61) of two 61-frame videos (against its plain
                version, and its rows bit for bit the whole video call's),
                and the temporal attention at half the positions (sp = 2),
                base and TSR; and what a tp = 2 rank of the training step
                calls: the temporal attention at H = 4 and GEGLU at I = 2C
                with its fp32 partial (no b2), at the base levels for batch 1
  4. model      one full-width base UNet3D forward (2x16x40x64 latents, every
                parameter random, temporal out-projections included) with the
                kernels and with the plain versions; relative error
  5. model_tsr  the same for the full-width TSR UNet (2x61x40x64x8 inputs)
  6. main       TextToVideoPipeline at full width answers two prompts: 16
                frames of 320x512, 50 DDPM steps, CFG 7.5
  6b. eval      the fork's evaluation harness on those two videos: CLIPSIM
                through a seeded random ViT-L/14 dual encoder (fp32) against
                their prompts; FVD through a seeded random R3D-18 (fp32, 16
                frames, crop 270 -> 224) between the two videos plus two
                synthetic clips (write_train_clips) and four other synthetic
                clips; the card's CLIPSIM and features against the same
                modules on the CPU, FVD of a set against itself ~ 0; seconds
                and peak memory; no kernel of the port launched
  7. profile    one CFG-batched base UNet forward under torch.profiler:
                device time by kernel group and the device's busy share
  7b. image     the fork's image-conditioned base path at full width: the
                pipeline with the ViT-L/14 vision tower and the 12-layer
                MappingNetwork answers one prompt twice with a seeded
                synthetic uint8 320x512 image (50 DDPM steps, CFG 7.5; every
                attn2 over 77 + 77 keys); the conditioning's ms; then one UNet forward
                on those 154-key states with LAVIE_ATTN2 unset and "cross"
                (16 launches of cross_attention, its 160-key wgmma body;
                outputs compared), and "fused" refused before any launch; the
                profile of one base UNet forward over 154 keys
  7c. train     the fork's training path at full width on the image phase's
                modules (909M UNet, SD VAE, ViT-L/14 text and vision towers,
                12-layer mapper; LoRA rank 16 on all 384 adapters): seeded
                synthetic MSVD-shaped clips written to build/train/ (the
                native .avi codec where it builds, else .npy);
                cli.finetune's loop (method 1) at batch 1, 16x320x512, two
                steps with a checkpoint each, then one more resumed from the
                latest (checkpoint-1 rotated out); cli.train_mapping for two
                steps; then one fixed batch with fixed draws and B drawn
                nonzero: the LoRA and mapper gradients through the kernels
                against the plain route's (relative norm error within
                TRAIN_GRAD_TOL, cosine), launches per step (temporal_attention
                and geglu > 0, no opt-in entry), the step's forward/backward
                split (CUDA events, and each one's device ms under
                torch.profiler) and the plain recompute's device span; the
                files deleted
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
                8 frames of the first main-phase video to 8x1280x2048: 5
                v-prediction DDIM steps (the one cut; 50 in a user's run),
                CFG 5.0, noise level 50
 13. profile_vsr  the profile of one VSR UNet half-forward
 13b. branch_kernels  geglu at the versatile feed-forward's widths (N = 8
                frames x 163840, 40960, 2560 positions at C = 128, 256, 512)
                and the d=512 flash attention at a tiled_decode tile's
                (8, 4096, 1, 512), each against its plain version, timed
                beside the library call where there is one and the bound
 13c. vsr_branches  one full-width VSR UNet half-forward (1x8x320x512x7)
                with the temporal modules' versatile attention
                ("SpatialTemporalShift", "CrossFrame") in all nine, every
                parameter random: kernels vs plain, ms, peak memory, exact
                launches (geglu 6 + 9); WarpModule, both paths, at 64x64
                tokens of width 128 and 256 on the card against the CPU
 13d. tiled_decode  the f4 VAE's tiled codec on one frame: a 320x512
                latent to 1280x2048 (60 tiles' mid attention on the flash
                kernel) against the plain route, and tiled_encode back
 13e. mesh      two ranks sharing the card over gloo (NCCL takes one rank a
                card), every stage at full width: the CFG-doubled base UNet
                forward frames over sp = 2 (collective calls and bytes), a
                base video (MESH_STEPS), TSR 16 -> 61 over sp = 2 (31/30
                frames), VSR's two windows of that video over dp = 2, one
                LoRA + mapper gradient at dp = 2 (per-rank batch 1); each
                against rank 0's one-process run of the same seed (VSR at
                window_batch 2, the gradient at batch 2), within MESH_TOL;
                seconds, peak memory and launches per rank
 13f. nccl      NCCL at world size 1: make_mesh(backend="nccl"), the base
                UNet forward over the one-rank sp axis bit for bit the
                meshless one, each collective exact over NCCL; then what
                NCCL says to two ranks on the one card
 13g. tp        tensor-parallel training: two ranks share the card over
                gloo on a (1, 1, 2) mesh, each running one full-parameter
                make_train_step of the full-width base UNet (909M, bf16
                parameters, fp32 moments, AdamW with clipping, min-SNR 5;
                batch 1, 16x40x64 latents, fixed draws) with the attention
                and feed-forward projections split over tp (heads 8 -> 4,
                GEGLU's I = 4C -> 2C), and a second step, timed; rank 0 then
                runs the same two steps in one process: loss within
                MESH_TOL, gradients (gathered whole) within MESH_TOL's
                relative norm and cosine, every parameter after the step
                within both updates' reach of the other's; seconds per step
                and peak memory per rank against one process's (a rank's
                below); the tp collectives' calls and bytes a step equal to
                the computed figure; geglu and temporal_attention launched
                once a block
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
                cross_attention (timed beside SDPA; at the base levels also
                over the image path's 154 keys, and at 256 keys on both of
                its kernels) and
                fused_ln_cross_attention (timed beside the LayerNorm,
                cuBLAS and SDPA path it replaces, and under a plan computed
                once; its device ms by kernel; its bound also with the xn,
                q and o round trips), each against its plain version
 17. temporal_proj_kernels  ln_qkv and out_proj_residual at the base, TSR
                and VSR levels with temporal attention, each against its
                plain version, timed beside the eager LayerNorm and cuBLAS
                projections they replace; the device ms by kernel of both
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
 21. ckpt       checkpoint loading at full width: the base stage of
                Predictor().setup(seed=CKPT_SEED) (UNet, SD VAE, ViT-L text
                tower) written in the reference layout, fp32, to build/ckpt/
                as lavie_base.pt and stable-diffusion-v1-4/{vae,text_encoder}/
                (the disk's free space checked first); a second
                Predictor().setup(ckpt_dir=...) with another seed; its base
                weights equal to the exporter's bit for bit; option 1 from
                both at one request seed, the videos within one uint8 level;
                file bytes, write and setup seconds with and without the
                directory; the files deleted
 22. cascade    the serving entry point at full width: Predictor().setup(),
                predict() for option 2 (61x320x512, written to
                build/cascade/ as .avi where a C compiler and libjpeg are
                found, else as a GIF); then a second predictor in turbo,
                Predictor().setup(conv_quant="int8"), runs the cascade for
                option 4 (61x1280x2048, not written) with the five opt-in
                switches set, cut to 10 base, 10 TSR and 1 VSR step; stage seconds,
                shapes, peak memory and exact launch counts per stage
 23. result     a `kernels` JSON line, a `kernels_new` line (GroupNorm,
                which replaces no Pallas kernel), then the `ok` JSON line last
Launch counts are zeroed just before each path (main, eval, image, train,
tsr, vsr, vsr_branches, tiled_decode, each sharded run of mesh, the first
tp step, ckpt, cascade) and read just after it; the paths before the cascade run the default routes and
launch no opt-in entry. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from port_bench.yardstick import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, KERNEL_GROUPS,
                                  NOT_DEVICE_WORK, bound_s, group_of)

INT8_OPS = 1979e12  # dense tensor-core int8

# (S, head_dim) at B=2, H=8; F=16 on the base path, 61 on the TSR path
ATTENTION_LEVELS = [(2560, 40), (640, 80), (160, 160), (40, 160)]
GEGLU_WIDTHS = [320, 640, 1280, 1280]  # C at the same levels
TSR_FRAMES, TSR_ROWS = 61, 2 * 61  # B·F frame rows at CFG batch 2
TEMPORAL_TOL, GEGLU_TOL, FLASH_TOL = 1e-2, 2e-2, 1e-2  # of max|plain|
# whole-UNet kernels vs plain, of max|plain|: base seen at 0.014, TSR at 0.0185,
# VSR at 0.0246 (H100 80GB HBM3, 700 W)
MODEL_TOL = {"model": 1e-1, "model_tsr": 4e-2, "model_vsr": 5e-2}
TSR_STEPS = 50
# the vsr phase's one cut: 5 steps (50 in a user's run; 10 until the tp
# phase came), as the cascade's option 4, to keep the script near half its
# time limit
VSR_STEPS, VSR_FRAMES = 5, 8
# VSR levels at one CFG half and one 8-frame window of 320x512 latents:
# (positions per frame, channels)
VSR_LEVELS = [(163840, 256), (40960, 512), (10240, 512), (2560, 1024)]
CROSS_TOL, TCONV_TOL = 2e-2, 1e-2  # of max|plain|
ATTN_TOL, PROJ_TOL = 1e-2, 2e-2  # cross_attention; ln_qkv and out_proj_residual
STATS_TOL = 1e-2  # gn_silu_tconv's Σ, Σ², of max|plain|
# the cascade phase's option 4: its cuts (50 steps a stage in a user's run),
# to keep the script within half its time limit on a slow host: VSR 2 steps
# since the mesh phase came (5 before: 111 s of VSR in turbo, 8 windows),
# base and TSR 10 and VSR 1 since the run read 638.4 and 649.3 s on a host
# whose gloo phases ran slow (at base and TSR 50 and VSR 2 the stages took
# 7.0, 20.4 and 64.3 s); option 2 keeps every step
CASCADE_VSR_STEPS = 1
CASCADE_BASE_STEPS = CASCADE_TSR_STEPS = 10
# the image path: 77 text keys and the MappingNetwork's 77 for every attn2
IMAGE_KEYS = 154
# the ckpt phase's exporter seed (the loading predictor takes CKPT_SEED + 1)
CKPT_SEED = 5
# the train phase: frames of a training clip (16 fit: 16.8 GB at peak on an
# H100 80GB), and the relative norm error allowed between the kernel route's
# and the plain route's LoRA and mapper gradients: the two forwards differ by
# the kernels' bf16 roundings (each within 1-2% of max|plain|); the first
# full-width runs read 0.0037 (LoRA) and 0.0080 (mapper)
TRAIN_FRAMES = 16
TRAIN_GRAD_TOL = 3e-2
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
    """(yardstick.bound_s in ms, what bounds it: "bytes" or "operations")."""
    t = bound_s(n_bytes, ops)
    return t * 1e3, "bytes" if n_bytes / HBM_BYTES_PER_S == t else "operations"


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


# kernels that must run their products on wgmma fed by TMA: (source, kernel
# name substring, SASS opcode prefixes each instance must hold)
SASS_REQUIRED = (("flash_attention", "flash_kernel", ("HGMMA.64", "UTMALDG.4D")),
                 ("flash_attention", "flash_d512_kernel", ("HGMMA.64", "UTMALDG.4D.MULTICAST")),
                 ("geglu", "geglu_", ("HGMMA", "UTMALDG")),
                 ("cross_attention", "cross_kernel", ("HGMMA", "UTMALDG.4D", "UTMASTG.4D")),
                 ("cross_attention", "cross_long_kernel", ("HMMA", "UTMALDG.4D")),
                 ("cross_head", "head_gemm_kernel", ("HGMMA", "UTMALDG.2D", "UTMASTG.2D")),
                 ("cross_head", "head_attn_kernel", ("HGMMA", "UTMALDG.4D")),
                 ("transformer_tail", "tail_gemm_", ("HGMMA", "UTMALDG")),
                 ("temporal_resblock", "tconv_gemm_kernel", ("HGMMA", "UTMALDG")),
                 ("temporal_resblock", "tconv_int8_gemm_kernel", ("IGMMA", "UTMALDG.4D")),
                 ("temporal_proj", "ln_qkv_gemm_kernel", ("HGMMA", "UTMALDG")),
                 ("temporal_proj", "out_proj_gemm_kernel", ("HGMMA", "UTMALDG.2D", "UTMASTG.2D")),
                 ("cross_block", "fused_gemm_kernel", ("HGMMA", "UTMALDG.2D", "UTMASTG.2D")),
                 ("cross_block", "fused_attn_kernel", ("HGMMA", "UTMALDG.4D", "UTMASTG.4D")))


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
                         "temporal_proj", "group_norm", "bias_residual"])
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
    # the cross attention's wgmma body at each score width (mangled
    # cross_kernel<DP, NK>: ten head dims at 80 and 160 keys, eight at 256)
    # and cross_long_kernel, kept for d > 128 past 160 keys only
    names = list(_build.sass_op_counts(_build.library_path("cross_attention")))
    widths = {str(nk): sum("cross_kernelILi" in k and f"ELi{nk}EE" in k for k in names)
              for nk in (80, 160, 256)}
    widths["long"] = sum("cross_long_kernel" in k for k in names)
    log(json.dumps({"sass": "cross_attention", "instances_by_width": widths}))
    if widths != {"80": 10, "160": 10, "256": 8, "long": 2}:
        raise AssertionError(f"cross_attention instances by score width: {widths}")
    log(f"[build] {time.time() - t0:.1f} s")


def phase_temporal(f: int, rope: int, levels=ATTENTION_LEVELS, b: int = 2,
                   folded: bool = False, h: int = 8) -> list:
    """Temporal attention at H=8: the base path's F=16 with RoPE and a bias
    (B=2), the TSR path's F=61 with neither (B=2), the VSR path's F=8 with
    both (B=1, one CFG half); at H=4 a tp = 2 rank's heads of the base
    training step (B=1). `folded`: the opt-in route's entry,
    temporal_attention_folded, on q and k rotated beforehand, with the bias."""
    from lavie_tpu_torch.kernels.temporal_fused import (
        temporal_attention,
        temporal_attention_folded,
        temporal_attention_folded_reference,
        temporal_attention_reference,
    )
    from lavie_tpu_torch.nn.embeddings import apply_rope_half, rope_half_frequencies

    g = torch.Generator(device="cuda").manual_seed(1)
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


def phase_geglu(f: int, shapes=None, b: int = 2, tp: int = 1) -> list:
    """GEGLU at N = B·F·S tokens of width C, the shapes of a path with F
    frames, or at the given (N, C) shapes; at tp > 1 a tensor-parallel
    shard's call, I = 4C/tp with no b2, whose output is the fp32 partial."""
    from lavie_tpu_torch.kernels import geglu as gg

    g = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    shapes = shapes or [(b * f * s, c) for (s, _), c in zip(ATTENTION_LEVELS, GEGLU_WIDTHS)]
    for n, c in shapes:
        inner = 4 * c // tp
        r = lambda *shape, sd=1.0: (  # noqa: E731
            torch.randn(*shape, generator=g, device="cuda") * sd).bfloat16()
        x, w0, b0 = r(n, c), r(2 * inner, c, sd=c**-0.5), r(2 * inner, sd=0.1)
        w2, b2 = r(c, inner, sd=inner**-0.5), r(c, sd=0.1)
        if tp > 1:
            b2 = None
        args = (x, w0, b0, w2, b2)
        out_bytes = n * c * (4 if b2 is None else 2)
        rows.append(check_row(
            "geglu", {"N": n, "C": c, "I": inner}, gg.geglu(*args), gg.geglu_reference(*args),
            GEGLU_TOL, lambda: gg.geglu(*args), lambda: gg.geglu_reference(*args), None,
            n * c * 2 + out_bytes + (3 * inner * c + 2 * inner + (0 if b2 is None else c)) * 2,
            ((6 * n * c * inner, BF16_FLOPS),),
            plain_iters=20, out_width=gg.launch_plan(n, c, inner, sms).out.width,
            fp32_partial=b2 is None))
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


# GroupNorm at the main path's shapes: (where, N, P, C, silu, shift); the
# base UNet's resnets (N = 2 videos) and transformers (N = 32 frames), the
# TSR UNet's L0 (61 frames) and the VAE decoder over 8 frames of 320x512
GROUP_NORM_SHAPES = [
    ("base resnet L0 norm1", 2, 40960, 320, True, False),
    ("base resnet L0 norm2", 2, 40960, 320, True, True),
    ("base up resnet L0 norm1", 2, 40960, 960, True, False),
    ("base up resnet L1 norm1", 2, 10240, 1920, True, False),
    ("base up resnet L2 norm1", 2, 2560, 2560, True, False),
    ("base up resnet L3 norm1", 2, 640, 2560, True, False),
    ("base transformer L0", 32, 2560, 320, False, False),
    ("base transformer L1", 32, 640, 640, False, False),
    ("base transformer L2", 32, 160, 1280, False, False),
    ("base transformer L3", 32, 40, 1280, False, False),
    ("TSR resnet L0 norm2", 2, 156160, 320, True, True),
    ("TSR transformer L0", 122, 2560, 320, False, False),
    ("VAE decoder up3", 8, 163840, 128, True, False),
    ("VAE decoder up2", 8, 40960, 256, True, False),
    ("VAE decoder mid", 8, 2560, 512, True, False),
]
GROUP_NORM_TOL = 1e-2  # of max|plain|: the statistics summed in another order


def eager_group_norm(x, weight, bias, groups, eps, silu, shift):
    """The ops GroupNorm ran before its kernels (nn/layers.py's route for a
    CPU or frame-sharded call): x + shift, a fp32 copy, var_mean over a (N,
    P, G, C/G) view, the (N, C) affine, two broadcast bf16 ops, F.silu."""
    n, c = x.shape[0], x.shape[-1]
    shape = (n,) + (1,) * (x.ndim - 2) + (c,)
    if shift is not None:
        x = x + shift.view(shape)
    var, mean = torch.var_mean(x.reshape(n, -1, groups, c // groups).float(), dim=(1, 3),
                               unbiased=False)
    inv_c = torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)
    w = inv_c * weight.float()
    u = bias.float() - mean.repeat_interleave(c // groups, dim=1) * w
    y = x * w.to(x.dtype).view(shape) + u.to(x.dtype).view(shape)
    return F.silu(y) if silu else y


def phase_group_norm() -> list:
    """GroupNorm's two kernels (row 16) at the main path's shapes against
    their plain version (group_norm_reference), timed beside the plain
    version, the eager ops they replaced (eager_ms) and F.group_norm (with
    F.silu and the shift's add where the call has them; a yardstick the port
    never calls), with their bound (x read twice, y written once: 6 bytes an
    element) and the device ms by kernel (torch.profiler)."""
    from lavie_tpu_torch.kernels import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for where, n, p, c, silu, with_shift in GROUP_NORM_SHAPES:
        x = (torch.randn(n, p, c, generator=g, device="cuda") + 0.3).bfloat16()
        weight = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).bfloat16()
        bias = (0.1 * torch.randn(c, generator=g, device="cuda")).bfloat16()
        shift = torch.randn(n, c, generator=g, device="cuda").bfloat16() if with_shift else None
        args = (x, weight, bias, 32, 1e-6)
        kw = {"silu": silu, "shift": shift}
        out = gn.group_norm(*args, **kw)
        ref = gn.group_norm_reference(*args, **kw)
        xv = x.permute(0, 2, 1)

        def library(xv=xv, weight=weight, bias=bias, shift=shift, silu=silu):
            h = xv if shift is None else xv + shift[:, :, None]
            y = F.group_norm(h, 32, weight, bias, 1e-6)
            return F.silu(y) if silu else y

        fn = lambda args=args, kw=kw: gn.group_norm(*args, **kw)  # noqa: E731
        rows.append(check_row(
            "group_norm", {"where": where, "N": n, "P": p, "C": c, "silu": silu,
                           "shift": with_shift},
            out, ref, GROUP_NORM_TOL, fn,
            lambda args=args, kw=kw: gn.group_norm_reference(*args, **kw),
            library, 6 * n * p * c, (),
            eager_ms=time_ms(lambda: eager_group_norm(*args, silu, shift), 5, 3),
            device_ms=kernel_ms(fn), plan=str(gn._plan(x, 32))))
        del x, out, ref, xv
    return rows


# (where, frames, H, W, C): the largest residual of each UNet, x + h after
# conv2 (and a 1x1 shortcut): the base L0 resnets (2 videos of 16 frames of
# 40x64 latents), the TSR's L0 (2 videos of 61 frames) and the VSR temporal
# module after up block 2 (8 frames of 320x512 at 512 channels)
BIAS_RESIDUAL_SHAPES = [("base L0", 32, 40, 64, 320), ("TSR L0", 122, 40, 64, 320),
                        ("VSR up 2", 8, 320, 512, 512)]


def phase_bias_residual() -> list:
    """The residual kernel (row 17) at the main path's largest residuals,
    with conv2's bias and with and without the shortcut's, against its
    plain version bit for bit, timed beside it and the parent's ops it
    replaced (library_ms: ATen's add of each bias onto the conv's
    channels-last output, then x + h; the same ops the plain version
    runs, on other strides; out of place, so that every timed call reads
    the same inputs, where the parent's add_ wrote the conv's output in
    place: the same bytes), with its bound (x and h read, out written: 6
    bytes an element) and the device ms of both (torch.profiler)."""
    from lavie_tpu_torch.kernels import _build
    from lavie_tpu_torch.kernels import bias_residual as br

    g = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for where, f, hh, ww, c in BIAS_RESIDUAL_SHAPES:
        x = torch.randn(f, hh, ww, c, generator=g, device="cuda").bfloat16()
        h = (3 * torch.randn(f, hh, ww, c, generator=g, device="cuda")).bfloat16()
        b_h = (0.5 * torch.randn(c, generator=g, device="cuda")).bfloat16()
        b_x = (0.5 * torch.randn(c, generator=g, device="cuda")).bfloat16()
        for shortcut in (False, True):  # the biases in bf16, as the UNet hands them
            args = (x, h, b_x if shortcut else None, b_h)
            out = br.bias_residual(*args)
            ref = br.bias_residual_reference(*args)
            # the parent's ops on NCHW views of channels-last copies
            xc, hc = (t.clone().permute(0, 3, 1, 2) for t in (x, h))

            def parent(xc=xc, hc=hc, shortcut=shortcut):
                hb = hc + b_h.reshape(1, -1, 1, 1)
                return (xc + b_x.reshape(1, -1, 1, 1) if shortcut else xc) + hb

            fn = lambda args=args: br.bias_residual(*args)  # noqa: E731
            rows.append(check_row(
                "bias_residual", {"where": where, "rows": f * hh * ww, "C": c,
                                  "shortcut": shortcut},
                out, ref, 0.0, fn, lambda args=args: br.bias_residual_reference(*args), parent,
                6 * f * hh * ww * c, (), device_ms=kernel_ms(fn), library_device_ms=kernel_ms(parent),
                blocks=br.launch_plan(f * hh * ww, c, _build.sm_count(0))))
            del xc, hc, out, ref
        del x, h
    return rows


class plain_kernels:
    """Within the block the UNet and VAE modules call the plain versions of
    every kernel instead of the kernels."""

    def _swaps(self):
        import lavie_tpu_torch.kernels.attention as dpa_mod
        import lavie_tpu_torch.nn.attention as attn_mod
        import lavie_tpu_torch.nn.layers as layers_mod
        import lavie_tpu_torch.nn.resnet as res_mod
        import lavie_tpu_torch.nn.temporal_module as tm_mod
        import lavie_tpu_torch.nn.transformer as tr_mod
        import lavie_tpu_torch.nn.vae as vae_mod
        from lavie_tpu_torch.kernels import bias_residual as br
        from lavie_tpu_torch.kernels import cross_attention as ca
        from lavie_tpu_torch.kernels import cross_block as cb
        from lavie_tpu_torch.kernels import flash_attention as fa
        from lavie_tpu_torch.kernels import geglu as gg
        from lavie_tpu_torch.kernels import group_norm as gn
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
            (layers_mod, "group_norm", gn.group_norm_reference),
            (layers_mod, "group_norm_affine", gn.affine_reference),
            (res_mod, "bias_residual", br.bias_residual_reference),
            (tm_mod, "bias_residual", br.bias_residual_reference),
        ]

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self._swaps()]
        for mod, name, plain in self._swaps():
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def unet_inputs(cfg, batch: int, frames: int, h: int, w: int, ctx_dim: int, seed: int, t: float,
                keys: int = 77):
    """Random full-width UNet inputs on the card: (x, timesteps, text, class labels)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, frames, h, w, cfg.in_channels, generator=g, device="cuda")
    ts = torch.full((batch,), t, device="cuda")
    ctx = torch.randn(batch, keys, ctx_dim, generator=g, device="cuda")
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


def device_kernels(prof):
    """(event, device µs) of every device kernel a torch.profiler run
    recorded, by name."""
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0 or e.key.startswith(("aten::", "cuda", "Memcpy", "Memset") + NOT_DEVICE_WORK):
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
                  ctx_dim: int = 768, keys: int = 77) -> None:
    """Device time of one UNet forward (CFG-batched, or one VSR half), by
    kernel group, and the host ops with the most self time (host_top; the
    SDPA backend ops each attention call went through, sdpa_ops); then a
    second forward, traced with shapes, attributes the
    dtype/layout copies (recording shapes slows the host: on an H100 80GB
    HBM3 at 700 W it stretched the base forward's wall from 123 to 172 ms)."""
    from torch.profiler import ProfilerActivity, profile

    x, ts, ctx, labels = unet_inputs(unet.config, batch, frames, h, w, ctx_dim, seed=4, t=500.0,
                                     keys=keys)
    from lavie_tpu_torch.kernels.bias_residual import bias_residual
    from lavie_tpu_torch.kernels.group_norm import group_norm

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gn_counts = lambda: (group_norm.launches, group_norm.silu_launches,  # noqa: E731
                         group_norm.shift_launches, group_norm.bias_in_launches)
    with torch.no_grad():
        unet(x, ts, ctx, labels)
        torch.cuda.synchronize()
        gn_before, br_before = gn_counts(), bias_residual.launches
        with profile(activities=activities) as prof:
            t0 = time.time()
            unet(x, ts, ctx, labels)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        gn_forward = dict(zip(("launches", "silu_launches", "shift_launches", "bias_in_launches"),
                              (a - b for a, b in zip(gn_counts(), gn_before))))
        br_forward = bias_residual.launches - br_before
        with profile(activities=activities, record_shapes=True) as shaped:
            unet(x, ts, ctx, labels)
            torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    top = []
    for e, us in device_kernels(prof):
        top.append((us / 1e3, e.key[:80], e.count))
        groups[group_of(e.key)] += us / 1e3
    busy = sum(groups.values())
    top.sort(reverse=True)
    # the host side of the same forward: the ops with the most self time, and
    # which SDPA backend each attention call took
    averages = prof.key_averages()
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count) for e in averages
                   if e.self_cpu_time_total > 0), reverse=True)
    sdpa = {e.key: {"calls": e.count, "cpu_ms": e.cpu_time_total / 1e3} for e in averages
            if "scaled_dot_product" in e.key}
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
        "device_launches": sum(n for _, _, n in top), "group_norm_calls": gn_forward,
        "bias_residual_launches": br_forward,
        "groups_ms": groups,
        "top_kernels": [{"ms": ms, "name": k, "calls": n} for ms, k, n in top[:12]],
        "host_top": [{"ms": ms, "name": k, "calls": n} for ms, k, n in host[:10]],
        "sdpa_ops": sdpa,
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


MAIN_PROMPTS = ["a teddy bear walking on the street, 2k, high quality",
                "a panda playing the guitar by a lake"]


def phase_main() -> tuple:
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    t0 = time.time()
    pipe = TextToVideoPipeline.init_random(seed=0)  # full width, bf16, on the card
    torch.cuda.synchronize()
    log(f"[main] init {time.time() - t0:.1f} s")
    prompts = MAIN_PROMPTS
    steps = 50
    videos = []
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    from lavie_tpu_torch.kernels.bias_residual import bias_residual
    from lavie_tpu_torch.kernels.group_norm import group_norm

    gn_before, br_before = group_norm.launches, bias_residual.launches
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
    launches["group_norm"] = group_norm.launches - gn_before  # UNet and VAE, both prompts
    launches["bias_residual"] = bias_residual.launches - br_before  # the UNet's 22 a forward
    log(json.dumps({"phase": "main", "launches": launches,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    for name in ("temporal_attention", "geglu"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    assert_default_routes("main", launches)
    phase_profile("profile", pipe.unet, 16)
    del pipe
    torch.cuda.empty_cache()
    return launches, videos


def phase_image() -> dict:
    """The fork's image-conditioned base path at full width: the ViT-L/14
    vision tower and the 12-layer MappingNetwork (random weights of their own
    seeds) condition one prompt on a seeded synthetic uint8 320x512 image;
    16x320x512, 50 DDPM steps, CFG 7.5, twice (the first video is also the
    process's first use of the 154-key shapes). Then one CFG-batched UNet forward
    on the conditioned 154-key states with LAVIE_ATTN2 unset and "cross"
    (cross_attention.cu's 160-key wgmma body), outputs compared, and
    LAVIE_ATTN2=fused refused before any launch."""
    import numpy as np

    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    t0 = time.time()
    pipe = TextToVideoPipeline.init_random(seed=0, with_image_conditioning=True)
    torch.cuda.synchronize()
    log(f"[image] init {time.time() - t0:.1f} s")
    rng = np.random.RandomState(21)
    ramp = np.linspace(0, 255, 512)[None, :, None] * np.ones((320, 1, 3))
    image = np.clip(ramp + rng.normal(0, 40, (320, 512, 3)), 0, 255).astype(np.uint8)
    prompt, steps = "a teddy bear walking on the street, 2k, high quality", 50
    with torch.no_grad():
        text = pipe.encode_prompts([prompt])
        pipe.condition_on_image(text, image)  # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        states = pipe.condition_on_image(text, image)
        torch.cuda.synchronize()
        condition_ms = (time.time() - t0) * 1e3
    if tuple(states.shape) != (2, IMAGE_KEYS, 768) or not bool(torch.isfinite(states).all()):
        raise AssertionError(f"image: conditioned states {tuple(states.shape)}, finite "
                             f"{bool(torch.isfinite(states).all())}")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    secs = []  # the first video is also the first use of the 154-key shapes
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        out = pipe(prompt, num_inference_steps=steps, guidance_scale=7.5, sample_method="ddpm",
                   seed=400, image=image)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    launches = read_launches()
    video = out.video
    ok = (video.shape == (1, 16, 320, 512, 3) and video.dtype.name == "uint8"
          and bool(torch.isfinite(out.latents).all()))
    log(json.dumps({"phase": "image", "seconds": secs[1], "first_seconds": secs[0],
                    "s_per_step": secs[1] / steps, "frames_per_s": 16 / secs[1],
                    "condition_ms": condition_ms,
                    "states_shape": list(states.shape), "shape": list(video.shape),
                    "dtype": video.dtype.name, "latents_finite": ok,
                    "video_mean": float(video.mean()), "video_std": float(video.std()),
                    "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    if not ok:
        raise AssertionError(f"bad image-conditioned output: {video.shape} {video.dtype}")
    for name in ("temporal_attention", "geglu"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the image path")
    assert_default_routes("image", launches)

    # attn2 over the 154 keys: the default route against LAVIE_ATTN2=cross,
    # each forward's event ms and, the forward being host-bound, the device
    # ms of its kernels (torch.profiler) and of the cross attention's
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 16, 40, 64, 4, generator=g, device="cuda")
    ts = torch.full((2,), 981.0, device="cuda")
    outs, ms, ab, device_ms, attn_ms = {}, {}, {}, {}, {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        for route in (None, "cross", "cross", None):
            with env(LAVIE_ATTN2=route):
                zero_launches()
                torch.cuda.synchronize()
                start.record()
                y = pipe.unet(x, ts, states)
                end.record()
                torch.cuda.synchronize()
                launches_ab = read_launches()
                key = route or "unset"
                if key in outs:  # the first forward of each route is its warm-up
                    ms[key] = start.elapsed_time(end)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        pipe.unet(x, ts, states)
                        torch.cuda.synchronize()
                    kernels = list(device_kernels(prof))
                    device_ms[key] = sum(us for _, us in kernels) / 1e3
                    attn_ms[key] = sum(us for e, us in kernels if "cross_kernel<" in e.key) / 1e3
            outs[key], ab[key] = y.float(), launches_ab
        zero_launches()
        with env(LAVIE_ATTN2="fused"):
            try:
                pipe.unet(x, ts, states)
                refused = None
            except ValueError as e:
                refused = str(e)
        fused_launches = sum(read_launches().values())
    scale = outs["unset"].abs().max().item()
    diff = (outs["cross"] - outs["unset"]).abs().max().item()
    row = {"phase": "image_attn2", "keys": IMAGE_KEYS, "shape": list(x.shape), "ms": ms,
           "device_ms": device_ms, "cross_attention_device_ms": attn_ms, "max_abs_diff": diff,
           "max_abs_ref": scale, "tol": MODEL_TOL["model"],
           "launches": {k: {n: c for n, c in v.items() if c} for k, v in ab.items()},
           "fused_refused": refused, "fused_launches": fused_launches}
    log(json.dumps(row))
    if ab["cross"]["cross_attention"] != 16 or ab["unset"]["cross_attention"]:
        raise AssertionError(f"image: cross_attention launched {ab['cross']['cross_attention']} "
                             "times over 154 keys, expected 16")
    if not (bool(torch.isfinite(outs["cross"]).all()) and diff <= MODEL_TOL["model"] * scale):
        raise AssertionError(f"image: LAVIE_ATTN2=cross vs unset: {diff} > {MODEL_TOL['model']}·{scale}")
    if refused is None or fused_launches:
        raise AssertionError(f"image: LAVIE_ATTN2=fused over 154 keys: raised {refused!r}, "
                             f"{fused_launches} launches")
    phase_profile("profile_image", pipe.unet, 16, keys=IMAGE_KEYS)
    del out, outs, states, text
    torch.cuda.empty_cache()
    return {**launches, "cross_attention_ab": ab["cross"]["cross_attention"]}, pipe


def write_train_clips(folder: str, n: int = 4, frames: int = 24, h: int = 240, w: int = 320,
                      seed: int = 31) -> str:
    """n seeded synthetic MSVD-shaped clips (24 frames of 240x320: a ramp
    drifting across noise) and their annotations.txt, through the port's
    MJPEG .avi codec where it builds, else as .npy; returns the format."""
    import numpy as np

    from lavie_tpu_torch.native import mjpeg_available, write_avi

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    fmt = "avi" if mjpeg_available() else "npy"
    lines = []
    for i in range(n):
        x = np.arange(w)[None, None, :, None] + 9 * np.arange(frames)[:, None, None, None]
        clip = (np.sin(x / (17.0 + 5 * i)) * 100 + 128 + rng.normal(0, 20, (frames, h, w, 3)))
        clip = np.clip(clip, 0, 255).astype(np.uint8)
        path = os.path.join(folder, f"clip{i}.{fmt}")
        if fmt == "avi":
            write_avi(path, clip, fps=8)
        else:
            np.save(path, clip)
        lines += [f"clip{i} a synthetic video number {i}", f"clip{i} stripes drifting sideways"]
    with open(os.path.join(folder, "annotations.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return fmt


def _grad_stats(got: dict, want: dict, prefix: str) -> dict:
    keys = [k for k in want if k.startswith(prefix)]
    g = torch.cat([got[k].float().flatten() for k in keys])
    p = torch.cat([want[k].float().flatten() for k in keys])
    return {"tensors": len(keys), "rel_norm_err": ((g - p).norm() / p.norm()).item(),
            "cosine": (torch.dot(g, p) / (g.norm() * p.norm())).item(),
            "norm": p.norm().item(), "finite": bool(torch.isfinite(g).all())}


def phase_train(pipe) -> dict:
    """The fork's training path at full width, on the image phase's modules
    (the 909M base UNet, the SD VAE, the ViT-L/14 text and vision towers,
    the 12-layer mapper; LoRA rank 16): cli.finetune's loop (method 1) on
    seeded synthetic MSVD-shaped clips at batch 1, TRAIN_FRAMES x 320x512,
    two steps with a checkpoint at each, then one more resumed from the
    latest (the oldest of the three rotated out); cli.train_mapping for two
    steps; then, on one fixed batch and fixed draws with B drawn nonzero,
    the LoRA and mapper gradients through the kernels against those of the
    plain versions, and the step's forward/backward split (CUDA events and
    torch.profiler)."""
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from lavie_tpu_torch.cli import finetune as ft_cli
    from lavie_tpu_torch.cli import train_mapping as map_cli
    from lavie_tpu_torch.data import MSVDDataset

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train")
    shutil.rmtree(root, ignore_errors=True)
    clips, out = os.path.join(root, "clips"), os.path.join(root, "out")
    fmt = write_train_clips(clips)
    free = shutil.disk_usage(os.path.dirname(root)).free
    if free < 8e9:
        raise AssertionError(f"train: {free} bytes free for the checkpoints")
    cfg = {"train_data_dir": clips, "annotations_path": os.path.join(clips, "annotations.txt"),
           "video_length": TRAIN_FRAMES, "image_size": [320, 512], "train_batch_size": 1,
           "max_train_steps": 2, "checkpointing_steps": 1, "checkpoints_total_limit": 2,
           "rank": 16, "learning_rate": 1e-4, "snr_gamma": 5, "output_dir": out,
           "logging_dir": os.path.join(root, "logs"), "seed": 0}
    losses, stamps = [], []

    def on_step(step, m):
        torch.cuda.synchronize()
        stamps.append(time.time())
        losses.append({k: float(v) for k, v in m.items()})

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.time()
    state = ft_cli.train(cfg, "cuda", pipe=pipe, on_step=on_step)
    first = sorted(os.listdir(out))
    state = ft_cli.train({**cfg, "max_train_steps": 3, "resume_from_checkpoint": "latest"}, "cuda",
                         pipe=pipe, on_step=on_step)
    finetune_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kept = sorted(os.listdir(out))
    ckpt_bytes = sum(os.path.getsize(os.path.join(out, d, f)) for d in kept
                     for f in os.listdir(os.path.join(out, d)))
    zero_map = read_launches()
    t0 = time.time()
    _, history = map_cli.train({**cfg, "train_batch_size": 2, "max_train_steps": 2,
                                "output_dir": os.path.join(root, "mapper_out")}, "cuda")
    mapping_s = time.time() - t0
    launches = read_launches()
    ok = (state.step == 3 and first == ["checkpoint-1", "checkpoint-2"]
          and kept == ["checkpoint-2", "checkpoint-3"] and len(losses) == 3 and len(history) == 2
          and all(np.isfinite(list(m.values())).all() for m in losses + history))
    log(json.dumps({"phase": "train", "clips": fmt, "frames": TRAIN_FRAMES, "batch": 1,
                    "finetune_s": finetune_s, "steps": state.step, "losses": losses,
                    # the wall between consecutive steps: the checkpoint saves, and
                    # before step 3 the second invocation's set-up and resume
                    "between_steps_s": [b - a for a, b in zip(stamps, stamps[1:])],
                    "checkpoints_after_2": first, "checkpoints_after_resume": kept,
                    "checkpoint_bytes": ckpt_bytes, "peak_mem_gb": peak_gb,
                    "mapping_s": mapping_s, "mapping_losses": history,
                    "launches": launches, "mapping_launches": {
                        k: v - zero_map[k] for k, v in launches.items() if v != zero_map[k]}}))
    if not ok:
        raise AssertionError(f"train: steps {state.step}, checkpoints {first} then {kept}, "
                             f"{len(losses)} finetune and {len(history)} mapping losses")
    for name in ("temporal_attention", "geglu"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the train path")
    assert_default_routes("train", launches)
    del state

    # one fixed batch: the gradients through the kernels against the plain route's
    tuner, _ = ft_cli._build(cfg, "cuda", pipe)
    ds = MSVDDataset(clips, cfg["annotations_path"], num_frames=TRAIN_FRAMES, size=(320, 512),
                     augment=False)
    sample = ds[0]
    batch = {"video": torch.from_numpy(sample["video"][None]).cuda(),
             "token_ids": torch.from_numpy(pipe.tokenizer([sample["caption"]]).astype(np.int64)).cuda(),
             "cond_image": torch.from_numpy(ft_cli.cond_images(sample["cond_frame"][None], 224)).cuda()}
    g = torch.Generator(device="cuda").manual_seed(41)
    state = tuner.init_state(g)
    with torch.no_grad():
        for k, v in state.lora.items():
            if k.endswith("lora_b"):
                v.normal_(0.0, 0.01, generator=g)
    draws = {"posterior_noise": torch.randn(TRAIN_FRAMES, 40, 64, 4, generator=g, device="cuda"),
             "t": torch.tensor([500], device="cuda"),
             "noise": torch.randn(1, TRAIN_FRAMES, 40, 64, 4, generator=g, device="cuda")}
    zero_launches()
    loss_k, aux_k, grads_k = tuner.grads(state, batch, **draws)
    per_step = read_launches()
    with plain_kernels():
        loss_p, aux_p, grads_p = tuner.grads(state, batch, **draws)
    plain_launches = sum(read_launches().values()) - sum(per_step.values())
    stats = {"lora": _grad_stats(grads_k, grads_p, "lora/"),
             "mapper": _grad_stats(grads_k, grads_p, "mapper/")}
    del grads_p

    # the step's forward/backward split: CUDA events, then torch.profiler
    params = state.trainables()
    split = []
    for _ in range(3):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        loss, _ = tuner._loss({"lora": state.lora, "mapper": state.mapper}, batch, **draws)
        torch.cuda.synchronize()
        t1 = time.time()
        torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        split.append({"forward_s": t1 - t0, "backward_s": time.time() - t1})
    # the same step under torch.profiler, forward and backward traced apart:
    # each one's device kernels, and the device span of the "plain_backward"
    # ranges (each recompute of rows 1 and 3 and its VJP, gaps included)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof_f:
        loss, _ = tuner._loss({"lora": state.lora, "mapper": state.mapper}, batch, **draws)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof_b:
        torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
    ranges = {"forward_ms": sum(us for _, us in device_kernels(prof_f)) / 1e3,
              "backward_ms": 0.0}
    for e, us in device_kernels(prof_b):
        if e.key == "plain_backward":
            ranges["plain_backward"] = {"calls": e.count, "device_span_ms": us / 1e3}
        else:
            ranges["backward_ms"] += us / 1e3
    busy = ranges["forward_ms"] + ranges["backward_ms"]
    step_s = split[-1]["forward_s"] + split[-1]["backward_s"]
    row = {"phase": "train_grads", "frames": TRAIN_FRAMES, "loss_kernels": loss_k.item(),
           "loss_plain": loss_p.item(), "mse": [aux_k[0].item(), aux_p[0].item()],
           "align": [aux_k[1].item(), aux_p[1].item()], "tol": TRAIN_GRAD_TOL, **stats,
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "plain_route_launches": plain_launches, "split_s": split, "s_per_step": step_s,
           "backward_share": split[-1]["backward_s"] / step_s,
           "profile": ranges if busy > 0 else "not measured",
           "plain_backward_share": (ranges["plain_backward"]["device_span_ms"] / 1e3 / step_s
                                    if "plain_backward" in ranges else "not measured"),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps(row))
    for name in ("temporal_attention", "geglu"):
        if per_step[name] <= 0:
            raise AssertionError(f"train: {name} launched 0 times in the step")
    assert_default_routes("train step", per_step)
    if plain_launches:
        raise AssertionError(f"train: the plain route launched {plain_launches} kernels")
    for group, st in stats.items():
        if not (st["finite"] and st["rel_norm_err"] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"train: {group} gradients, kernels vs plain: {st}")
    del tuner, state, params, grads_k, batch
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


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
    out-projection, residual: eager, cuBLAS and SDPA) and under a plan
    computed once (launch_ms), with its device ms by kernel and its bound
    also counting the xn, q and o round trips through device memory."""
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for where, b, n, d in levels:
        c, scale = h * d, d ** -0.5
        q, k, v = bf(b, n, h, d), bf(b, lkv, h, d), bf(b, lkv, h, d)
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        args = (q, k, v, scale)
        # the kernel alone, its plan computed once: the wrapper's checks and
        # plan lookup cost host time a call, which the small levels expose
        plan = ca.launch_plan(b, n, h, d, lkv, sms)
        rows["cross_attention"].append(check_row(
            "cross_attention", {"where": where, "B": b, "S": n, "H": h, "d": d, "L": lkv},
            ca.cross_attention(*args), ca.cross_attention_reference(*args), ATTN_TOL,
            lambda: ca.cross_attention(*args), lambda: ca.cross_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale),
            (2 * b * n * c + 2 * b * lkv * c) * 2, ((4 * b * h * n * lkv * d, BF16_FLOPS),),
            launch_ms=time_ms(lambda: ca._launch(*args, plan, stream))))
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

        fplan = cb.fused_launch_plan(b, n, c, d, lkv, sms)
        n_bytes = (2 * b * n * c + 2 * c * c + 2 * b * lkv * c) * 2 + 3 * c * 4
        ops = ((4 * b * n * c * c + 4 * b * n * lkv * c, BF16_FLOPS),)
        rows["fused_ln_cross_attention"].append(check_row(
            "fused_ln_cross_attention", {"where": where, "B": b, "N": n, "C": c, "heads": h, "L": lkv},
            cb.fused_ln_cross_attention(*fargs), cb.fused_ln_cross_attention_reference(*fargs),
            CROSS_TOL, lambda: cb.fused_ln_cross_attention(*fargs),
            lambda: cb.fused_ln_cross_attention_reference(*fargs), None, n_bytes, ops,
            unfused_ms=time_ms(unfused),
            launch_ms=time_ms(lambda: cb._launch_fused(x, p, scale, 1e-5, fplan, stream)),
            bound_with_round_trips_ms=bound(n_bytes + 6 * b * n * c * 2, ops)[0],
            kernels_ms=kernel_ms(lambda: cb.fused_ln_cross_attention(*fargs))))
        del x, p, fargs, k, v, kt, vt
    # the image path's attn2: 77 text and 77 mapped keys, the 160-key wgmma body
    rows["cross_attention_154"] = []
    for where, b, n, d in levels[:len(ATTENTION_LEVELS)]:
        c, scale, lkv = h * d, d ** -0.5, IMAGE_KEYS
        q, k, v = bf(b, n, h, d), bf(b, lkv, h, d), bf(b, lkv, h, d)
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        args = (q, k, v, scale)
        plan = ca.launch_plan(b, n, h, d, lkv, sms)
        rows["cross_attention_154"].append(check_row(
            "cross_attention", {"where": where, "B": b, "S": n, "H": h, "d": d, "L": lkv},
            ca.cross_attention(*args), ca.cross_attention_reference(*args), ATTN_TOL,
            lambda: ca.cross_attention(*args), lambda: ca.cross_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale),
            (2 * b * n * c + 2 * b * lkv * c) * 2, ((4 * b * h * n * lkv * d, BF16_FLOPS),),
            launch_ms=time_ms(lambda: ca._launch(*args, plan, stream))))
        del q, k, v, ql, kl, vl, args
    # the most keys the kernel takes, on no path: the 256-key wgmma body at
    # d = 128 and cross_long_kernel at d = 160, at base L2's queries
    rows["cross_attention_256"] = []
    for d in (128, 160):
        b, n, lkv, scale = 2, 16 * ATTENTION_LEVELS[2][0], ca.MAX_KV, d ** -0.5
        q, k, v = bf(b, n, h, d), bf(b, lkv, h, d), bf(b, lkv, h, d)
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        args = (q, k, v, scale)
        plan = ca.launch_plan(b, n, h, d, lkv, sms)
        rows["cross_attention_256"].append(check_row(
            "cross_attention", {"where": "L=256", "B": b, "S": n, "H": h, "d": d, "L": lkv},
            ca.cross_attention(*args), ca.cross_attention_reference(*args), ATTN_TOL,
            lambda: ca.cross_attention(*args), lambda: ca.cross_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale),
            (2 * b * n * h * d + 2 * b * lkv * h * d) * 2, ((4 * b * h * n * lkv * d, BF16_FLOPS),),
            threads=plan.threads, launch_ms=time_ms(lambda: ca._launch(*args, plan, stream))))
        del q, k, v, ql, kl, vl, args
    torch.cuda.empty_cache()
    return rows


def phase_temporal_proj_kernels() -> dict:
    """The temporal attention's boundaries at every base level (B=2, F=16),
    every TSR level (B=2, F=61) and every VSR level with temporal attention
    (B=1, one CFG half, F=8), E = C: ln_qkv (LAVIE_TEMPORAL_PROJ=1) against
    its plain version, timed beside the default path's LayerNorm and three
    projections (eager and cuBLAS), its bound given with and without the
    LayerNorm's xn round trip through device memory; out_proj_residual
    against its plain version, timed beside F.linear and the residual add,
    with its device ms by kernel."""
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
            ((2 * n * c * c, BF16_FLOPS),), eager_ms=time_ms(lambda: F.linear(o, wo, bob) + x),
            kernels_ms=kernel_ms(lambda: tp.out_proj_residual(*oargs))))
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


def phase_ckpt() -> dict:
    """Checkpoint loading at full width through the server: the base stage
    of Predictor().setup(seed=CKPT_SEED) written in the reference layout,
    fp32 (io/checkpoints.py::save_pipeline_params), as build/ckpt/
    lavie_base.pt and stable-diffusion-v1-4/{vae,text_encoder}/; then
    Predictor().setup(ckpt_dir=build/ckpt, seed=CKPT_SEED + 1). Its base
    UNet, VAE and text tower must equal the exporter's bit for bit on the
    card, and option 1 at one request seed must give both predictors' videos
    within one uint8 level. The files are deleted at the end."""
    import shutil

    from lavie_tpu_torch.io.checkpoints import BASE_CKPT, SD_DIR, save_pipeline_params
    from lavie_tpu_torch.serve import Predictor

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    prompt = "a teddy bear walking on the street, 2k, high quality"
    request = dict(interpolation=False, super_resolution=False, seed=0)
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        src = Predictor()
        src.setup(seed=CKPT_SEED)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        base = src.pipeline.base
        modules = ("unet", "vae", "text_encoder")
        need = sum(4 * p.numel() for m in modules for p in getattr(base, m).state_dict().values())
        free = shutil.disk_usage(root).free
        if free < 1.1 * need:
            raise AssertionError(f"ckpt: {free} bytes free under {root}, the files take {need}")
        t0 = time.time()
        save_pipeline_params(base, os.path.join(root, BASE_CKPT), os.path.join(root, SD_DIR))
        write_s = time.time() - t0
        files = {os.path.relpath(os.path.join(d, f), root): os.path.getsize(os.path.join(d, f))
                 for d, _, names in os.walk(root) for f in names}
        want = src.pipeline(prompt, **request).video
        torch.cuda.synchronize()
        t0 = time.time()
        dst = Predictor()
        dst.setup(ckpt_dir=root, seed=CKPT_SEED + 1)
        torch.cuda.synchronize()
        setup_ckpt_s = time.time() - t0
        for m in modules:
            a, b = getattr(base, m).state_dict(), getattr(dst.pipeline.base, m).state_dict()
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            if bad:
                raise AssertionError(f"ckpt: {len(bad)} {m} tensors differ after loading, e.g. {bad[:3]}")
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        got = dst.pipeline(prompt, **request).video
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = read_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    diff = int(abs(got.astype(int) - want.astype(int)).max())
    log(json.dumps({"phase": "ckpt", "files": files, "file_bytes": sum(files.values()),
                    "write_s": write_s, "setup_s": setup_s, "setup_ckpt_s": setup_ckpt_s,
                    "option1_seconds": secs, "shape": list(got.shape),
                    "video_max_abs_diff": diff, "weights_equal": True, "launches": launches,
                    "deleted": not os.path.exists(root)}))
    if diff > 1 or got.shape != (16, 320, 512, 3):
        raise AssertionError(f"ckpt: option 1 from the loaded predictor differs by {diff} levels "
                             f"(shape {got.shape})")
    for name in ("temporal_attention", "geglu"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the ckpt path")
    assert_default_routes("ckpt", launches)
    del src, dst, base
    torch.cuda.empty_cache()
    return launches


def phase_cascade() -> dict:
    """The serving entry point at full width: Predictor().setup() once and
    predict(...) for option 2 (16 → 61 frames at 320x512, 50 DDPM base
    steps, 50 DDIM TSR steps), which writes its file; then, that predictor
    freed, a second one in turbo, Predictor().setup(conv_quant="int8"), and
    its cascade pipeline for option 4 (16x320x512 → 61x320x512 →
    61x1280x2048: seven VSR windows of 8 and a tail of 5; base and TSR at
    CASCADE_BASE_STEPS and CASCADE_TSR_STEPS, VSR at CASCADE_VSR_STEPS) with
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
                              num_inference_steps=CASCADE_BASE_STEPS, interp_steps=CASCADE_TSR_STEPS,
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
            row["cut"] = {"base_steps": CASCADE_BASE_STEPS, "tsr_steps": CASCADE_TSR_STEPS,
                          "vsr_steps": CASCADE_VSR_STEPS}
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
        base_steps, tsr_steps = (CASCADE_BASE_STEPS, CASCADE_TSR_STEPS) if option == 4 else (50, TSR_STEPS)
        want = {"base": expected_stage_launches("base", base_steps, folded, stats, **routes),
                "interpolation": expected_stage_launches("interpolation", tsr_steps, folded, stats,
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


# the keys of a kernel row at the new paths' shapes in the kernels line
BRANCH_ROW_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
CROSS_ROW_KEYS = BRANCH_ROW_KEYS + ("launch_ms",)
# the eval phase: CLIPSIM of the card against the CPU (a cosine, absolute),
# R3D-18 features of the card against the CPU (of max|CPU|), and FVD of a set
# against itself (of the sets' feature variance, trace(Σ)); fp32 on both
# devices, the models turning TF32 off themselves (the phase turns it on
# around them), so only the summation order differs. The first two are
# about ten times an H100's readings (4.5e-8, and 1.9e-6 of 3.21: PERF.md
# §6); the features with TF32 are reported beside (feature_max_abs_err_tf32).
EVAL_CLIPSIM_TOL, EVAL_FEATURE_TOL, EVAL_SELF_FVD_TOL = 1e-6, 1e-5, 1e-4
EVAL_CPU_FRAMES = 4  # frames of the first video scored on the CPU as well
# vsr_branches: the VSR UNet with the versatile attention in every temporal
# module, kernels vs plain, of max|plain| (the shipped VSR UNet's MODEL_TOL);
# the warp on the card against the CPU, fp32, of max|CPU|; the flow path's
# mask may flip where a warped value lies within WARP_MASK_BAND of 0.9999
BRANCH_TYPES = ("SpatialTemporalShift", "CrossFrame")
WARP_TOL, WARP_MASK_BAND = 1e-4, 1e-4
# tiled_decode: the f4 decoder's tiles (64 latents, 16 apart) with the flash
# kernel against the plain version, of max|plain|
TILED_TOL = 2e-2


def _features(ext, groups):
    """R3D-18 features of clips in groups of one shape each, concatenated."""
    import numpy as np

    return np.concatenate([ext(np.stack(g)) for g in groups], axis=0)


def phase_eval(videos: list, prompts: list) -> dict:
    """The fork's evaluation harness at full width on the main phase's two
    16x320x512 videos: CLIPSIM through a seeded random ViT-L/14 dual encoder
    (fp32) against their prompts; FVD through a seeded random R3D-18 (fp32,
    16 frames, crop 270 -> 224) between set A (the two videos and two
    synthetic clips of write_train_clips, seed 41) and set B (four synthetic
    clips, seed 31); both models held against their CPU copies (the first
    video's first EVAL_CPU_FRAMES frames scored, two clips' features), and
    FVD(A, A) ~ 0. TF32 is on for the phase, as cuDNN's default has it, so
    the check holds the models' own exact_fp32; the features with TF32 (the
    net called outside it) are reported beside. No kernel of the port runs
    on this path."""
    import glob
    import shutil

    from lavie_tpu_torch.io.video import read_video

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "eval")
    shutil.rmtree(root, ignore_errors=True)
    synth = {}
    for name, n, seed in (("a", 2, 41), ("b", 4, 31)):
        write_train_clips(os.path.join(root, name), n=n, seed=seed)
        synth[name] = [read_video(p) for p in sorted(glob.glob(os.path.join(root, name, "clip*")))]
    shutil.rmtree(root, ignore_errors=True)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return _eval_with_tf32_on(videos, prompts, synth)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _eval_with_tf32_on(videos: list, prompts: list, synth: dict) -> dict:
    """phase_eval's measurements and checks."""
    import copy

    import numpy as np

    from lavie_tpu_torch.eval import CLIPSimilarityScorer, frechet_distance
    from lavie_tpu_torch.eval.fvd import FVDFeatureExtractor, fvd_preprocess

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.time()
    scorer = CLIPSimilarityScorer(seed=0)  # ViT-L/14, fp32, on the card
    torch.cuda.synchronize()
    init_s = time.time() - t0
    scorer.score(videos[0][:1], prompts[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    scores = [scorer.score(v, p) for v, p in zip(videos, prompts)]
    torch.cuda.synchronize()
    clipsim_s = time.time() - t0
    clipsim = scorer.score_batch(videos, prompts)
    cpu = CLIPSimilarityScorer(model=copy.deepcopy(scorer.model).cpu(), device="cpu")
    head = videos[0][:EVAL_CPU_FRAMES]
    card_head, cpu_head = scorer.score(head, prompts[0]), cpu.score(head, prompts[0])
    del cpu

    ext = FVDFeatureExtractor(seed=0)  # R3D-18, fp32, 16 frames at 224, on the card
    set_a = [list(videos), synth["a"]]
    set_b = [synth["b"]]
    _features(ext, [synth["b"][:1]])  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    feats_a = _features(ext, set_a)
    feats_b = _features(ext, set_b)
    torch.cuda.synchronize()
    features_s = time.time() - t0
    t0 = time.time()
    fvd = frechet_distance(feats_a, feats_b)
    fvd_self = frechet_distance(feats_a, feats_a)
    frechet_s = time.time() - t0
    cpu_ext = FVDFeatureExtractor(net=copy.deepcopy(ext.net).cpu(), device="cpu")
    cpu_feats = cpu_ext(np.stack(synth["b"][:2]))
    feat_err = float(np.abs(feats_b[:2] - cpu_feats).max())
    feat_scale = float(np.abs(cpu_feats).max())
    with torch.no_grad():  # outside exact_fp32: the convolutions in TF32
        clips = torch.from_numpy(fvd_preprocess(np.stack(synth["b"][:2]))).cuda()
        tf32_err = float(np.abs(ext.net(clips).cpu().numpy() - cpu_feats).max())
    trace_a = float(np.trace(np.cov(feats_a, rowvar=False)))
    launches = read_launches()
    row = {"phase": "eval", "prompts": prompts, "clipsim_per_video": scores, "clipsim": clipsim,
           "clipsim_card_vs_cpu": [card_head, cpu_head], "clipsim_frames_on_cpu": EVAL_CPU_FRAMES,
           "fvd": fvd, "fvd_self": fvd_self, "trace_cov_a": trace_a,
           "clips": {"a": len(feats_a), "b": len(feats_b)},
           "feature_max_abs_err": feat_err, "feature_max_abs_cpu": feat_scale,
           "feature_max_abs_err_tf32": tf32_err,
           "seconds": {"scorer_init": init_s, "clipsim_2_videos": clipsim_s,
                       "r3d_features": features_s, "frechet": frechet_s},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: v for k, v in launches.items() if v}}
    log(json.dumps(row))
    if any(launches.values()):
        raise AssertionError(f"eval: a kernel of the port was launched: {launches}")
    if not (np.isfinite(scores).all() and np.isfinite(fvd) and np.isfinite(feats_a).all()):
        raise AssertionError(f"eval: CLIPSIM {scores}, FVD {fvd} not finite")
    if feats_a.shape != (4, 512) or feats_b.shape != (4, 512):
        raise AssertionError(f"eval: features {feats_a.shape}, {feats_b.shape}")
    if abs(card_head - cpu_head) > EVAL_CLIPSIM_TOL:
        raise AssertionError(f"eval: CLIPSIM card {card_head} vs CPU {cpu_head}")
    if feat_err > EVAL_FEATURE_TOL * feat_scale:
        raise AssertionError(f"eval: R3D-18 features card vs CPU {feat_err} > "
                             f"{EVAL_FEATURE_TOL}·{feat_scale}")
    if abs(fvd_self) > EVAL_SELF_FVD_TOL * trace_a or fvd <= abs(fvd_self):
        raise AssertionError(f"eval: FVD(A, A) {fvd_self} (trace {trace_a}), FVD(A, B) {fvd}")
    del scorer, ext
    torch.cuda.empty_cache()
    return launches


def phase_branch_kernels() -> dict:
    """The two kernels at the shapes the new paths give them: GEGLU at the
    versatile feed-forward's widths (dim = C/2: 128 at up 3, 256 at up 1,
    512 at the L3 width) and the d=512 flash attention at a tiled_decode
    tile's mid attention (64x64 latents, 8 frames' worth)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from lavie_tpu_torch.kernels import flash_attention as fa

    f = VSR_FRAMES
    geglu_rows = phase_geglu(f, shapes=[(f * 163840, 128), (f * 40960, 256), (f * 2560, 512)])
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn(f, 4096, 1, 512, generator=g, device="cuda").bfloat16() for _ in range(3))
    ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))

    def efficient_sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(ql, kl, vl)

    flash_row = check_row(
        "flash_attention", {"B": f, "S": 4096, "H": 1, "d": 512},
        fa.flash_attention(q, k, v, 512 ** -0.5), fa.flash_attention_reference(q, k, v, 512 ** -0.5),
        FLASH_TOL, lambda: fa.flash_attention(q, k, v, 512 ** -0.5),
        lambda: fa.flash_attention_reference(q, k, v, 512 ** -0.5), efficient_sdpa,
        4 * q.numel() * 2, ((4 * f * 4096 * 4096 * 512, BF16_FLOPS),), iters=10)
    del q, k, v, ql, kl, vl
    torch.cuda.empty_cache()
    return {"geglu": geglu_rows, "flash_attention": flash_row}


def _warp_check(c: int, deformable: bool) -> dict:
    """WarpModule at 64x64 tokens of width c over 8 frames, random weights
    (alpha and the flow conv too), fp32 on the card against its CPU copy."""
    import copy

    from lavie_tpu_torch.nn.versatile_attention import WarpModule
    from lavie_tpu_torch.pipelines.t2v import random_init_

    m = WarpModule(c, deformable)
    random_init_(m, seed=13 + c)
    g = torch.Generator().manual_seed(14 + c)
    x = torch.randn(VSR_FRAMES, 4096, c, generator=g) * 0.5 + 1.0  # half past the mask's 0.9999
    off = torch.randn(VSR_FRAMES, 4096, c, generator=g)
    card = copy.deepcopy(m).cuda()
    with torch.no_grad():
        want = m(x, off)
        xd, od = x.cuda(), off.cuda()
        card(xd, od)  # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        got = card(xd, od)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
    got = got.cpu()
    diff = (got - want).abs()
    scale = want.abs().max().item()
    bad = diff > WARP_TOL * scale
    if not deformable:  # a mask flip at the threshold: one side 0, the other the value
        near = (torch.maximum(got.abs(), want.abs()) - 0.9999).abs() <= WARP_MASK_BAND
        bad &= ~near
    return {"C": c, "path": "deformable" if deformable else "flow", "ms": ms,
            "max_abs_err": diff.max().item(), "max_abs_ref": scale,
            "elements_past_tol": int((diff > WARP_TOL * scale).sum()),
            "unexplained": int(bad.sum()), "finite": bool(torch.isfinite(got).all())}


def phase_vsr_branches() -> dict:
    """One full-width VSR UNet half-forward (1x8x320x512x7, text and noise
    level, every parameter random) with the versatile attention in all nine
    temporal modules, attention types BRANCH_TYPES, cross-frame mode
    "0_i-1_i": kernels against the plain versions, ms of each (CUDA events),
    peak memory and the launches of the kernel run (geglu > 0: the
    versatile feed-forward); then WarpModule, both paths, at a square
    64x64-token grid of width 128 and 256 on the card against the CPU (the
    VSR latents are not square, so the UNet cannot run the warp, as in JAX).
    The forward is timed cold (no warm-up: cut for the mesh phase's time),
    so `ms` holds the attention's first calls at each shape."""
    import dataclasses

    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    cfg = dataclasses.replace(UNetConfig.vsr(), temporal_module_attention_types=BRANCH_TYPES)
    with torch.device("cuda"):
        unet = UNet3D(cfg).to(torch.bfloat16).eval()
    random_init_(unet, seed=7)
    x, ts, ctx, labels = unet_inputs(cfg, 1, VSR_FRAMES, 320, 512, 1024, seed=3, t=981.0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        start.record()
        got = unet(x, ts, ctx, labels)
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = got.float()
        with plain_kernels():
            start.record()
            want = unet(x, ts, ctx, labels).float()
            end.record()
            torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    finite = bool(torch.isfinite(got).all())
    warps = [_warp_check(c, d) for c in (128, 256) for d in (False, True)]
    row = {"phase": "vsr_branches", "shape": list(x.shape), "attention_types": list(BRANCH_TYPES),
           "cross_frame_mode": cfg.temporal_module_cross_frame_mode, "ms": ms, "plain_ms": plain_ms,
           "max_abs_err": err, "max_abs_ref": scale, "rel_err": err / scale, "finite": finite,
           "peak_mem_gb": peak, "launches": {k: v for k, v in launches.items() if v},
           "warp": warps}
    log(json.dumps(row))
    if not (finite and err <= MODEL_TOL["model_vsr"] * scale):
        raise AssertionError(f"vsr_branches: kernels vs plain {err} > {MODEL_TOL['model_vsr']}·{scale}")
    # the shipped VSR UNet's launches a half (phase_vsr) plus one geglu in
    # each of the nine temporal modules' versatile blocks
    for name, n in {"geglu": 6 + 9, "temporal_attention": 16, "cross_attention_head": 10,
                    "transformer_tail": 10, "flash_attention": 6, "gn_silu_tconv": 50}.items():
        if launches[name] != n:
            raise AssertionError(f"vsr_branches: {name} launched {launches[name]} times, expected {n}")
    assert_default_routes("vsr_branches", launches)
    for w in warps:
        if not w["finite"] or w["unexplained"]:
            raise AssertionError(f"vsr_branches: WarpModule card vs CPU: {w}")
    del unet, got, want
    torch.cuda.empty_cache()
    return launches


def phase_tiled_decode() -> dict:
    """The f4 VAE's tiled codec at full width on one frame: a 320x512 latent
    to 1280x2048 through tiled_decode (64-latent tiles, 16 apart: 77 tiles,
    the 60 of 64x64 latents with their mid attention on the flash kernel),
    the kernel route against the plain route, twice each in turns, and each
    route's device ms (torch.profiler); then tiled_encode of that frame back
    to a 320x512 latent (256-pixel tiles, 64 apart), shape and finiteness.
    Seconds, peak memory, launches."""
    from lavie_tpu_torch.core.config import VAEConfig
    from lavie_tpu_torch.nn.vae import AutoencoderKL
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        vae = AutoencoderKL(VAEConfig.vsr()).to(torch.bfloat16).eval()
    random_init_(vae, seed=8)
    g = torch.Generator(device="cuda").manual_seed(15)
    z = torch.randn(1, 320, 512, 4, generator=g, device="cuda").bfloat16()
    routes = {"kernels": contextlib.nullcontext, "plain": plain_kernels}
    secs, device_ms, outs, launches = {r: [] for r in routes}, {}, {}, {}
    with torch.no_grad():
        for route in routes.values():  # warm-up: the four tile shapes, both routes
            with route():
                vae.tiled_decode(z[:, :80, :80])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name in ("kernels", "plain", "kernels", "plain"):  # in turns: the host swings
            with routes[name]():
                zero_launches()
                t0 = time.time()
                outs[name] = vae.tiled_decode(z)
                torch.cuda.synchronize()
                secs[name].append(time.time() - t0)
                launches[name] = read_launches()
        decode_launches = launches["kernels"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        for name, route in routes.items():  # the device's share of a decode
            with route():
                ms = kernel_ms(lambda: vae.tiled_decode(z), calls=1)
            device_ms[name] = sum(ms.values()) if isinstance(ms, dict) else ms
        got, want = outs["kernels"], outs["plain"]
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.time()
        mean, logvar = vae.tiled_encode(got)
        torch.cuda.synchronize()
        encode_s = time.time() - t0
        encode_launches = read_launches()
        encode_peak = torch.cuda.max_memory_allocated() / 1e9
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = (tuple(got.shape) == (1, 1280, 2048, 3) and bool(torch.isfinite(got).all())
          and tuple(mean.shape) == tuple(logvar.shape) == (1, 320, 512, 4)
          and bool(torch.isfinite(mean).all()) and bool(torch.isfinite(logvar).all()))
    row = {"phase": "tiled_decode", "latent": list(z.shape), "shape": list(got.shape),
           "decode_s": secs["kernels"], "plain_decode_s": secs["plain"],
           "device_ms": device_ms["kernels"], "plain_device_ms": device_ms["plain"], "max_abs_err": err,
           "max_abs_ref": scale, "peak_mem_gb": peak,
           "decode_launches": {k: v for k, v in decode_launches.items() if v},
           "encode_s": encode_s, "encode_shape": list(mean.shape), "encode_peak_mem_gb": encode_peak,
           "encode_launches": {k: v for k, v in encode_launches.items() if v}, "ok": ok}
    log(json.dumps(row))
    if not ok or err > TILED_TOL * scale:
        raise AssertionError(f"tiled_decode: {row}")
    if (decode_launches["flash_attention"] != 60 or encode_launches["flash_attention"] != 60
            or launches["plain"]["flash_attention"]):
        raise AssertionError(f"tiled_decode: flash launched {decode_launches['flash_attention']} "
                             f"and {encode_launches['flash_attention']} times, expected 60 each")
    del vae, got, want
    torch.cuda.empty_cache()
    return {k: decode_launches[k] + encode_launches[k] for k in decode_launches}


# the mesh phase: two ranks on the one card over gloo (NCCL takes one rank a
# card), every stage at full width and these steps, each against the same
# run in one process
MESH_STEPS = {"base": 3, "tsr": 2, "vsr": 2}
MESH_TIMEOUT = 600  # seconds the two ranks may take, and a collective may wait
MESH_FRAMES = 16  # a training clip's frames in the mesh phase (the train phase's)
# a sharded run against the one-process run of the same seed (SDPA held to
# backends that answer alike in every process): bf16 at other
# shapes (cuDNN's convs and cuBLAS at half the frames or samples, GroupNorm
# sums in another order) moves the UNet as the kernels move it against their
# plain versions (the first mesh run read 0.0142 of max, the kernels 0.014),
# and a random-weight UNet amplifies that over the steps (base video 5.49
# uint8 levels apart on average at 5 steps, TSR 1.39 at 3): the bounds hold
# the UNet at 5e-2 of max, the videos' mean |Δ| well below what a misplaced
# frame or noise slice gives (tens of levels), VSR (each window whole on one
# rank) equal, the loss at 1e-3 and the gradients at 1e-1 relative norm
# (LoRA 0.011, the mapper 0.048) with cosine 0.99
MESH_TOL = {"unet": 5e-2, "mean_abs_diff": {"base": 16.0, "tsr": 8.0, "vsr": 0.0}, "loss": 1e-3,
            "grads": 1e-1, "cosine": 0.99}


def phase_mesh_kernels(sparse_rows: list) -> dict:
    """The two kernels a frame shard calls anew: flash_sparse_causal with
    its anchor and halo operands at the four TSR levels, on the second of
    two ranks' frames [31, 61) of two 61-frame videos (frame 0 and frame 30
    of each handed in as (B, S, C) tensors), against its plain version and
    against the whole video's kernel call (its rows bit for bit), timed per
    row beside the whole call's (sparse_rows, the kernels phase); and the
    temporal attention at half the positions of every frame (sp = 2) at the
    base (F=16, RoPE and bias) and TSR (F=61) levels."""
    from lavie_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    h, b, start = 8, 2, 31
    local = TSR_FRAMES - start
    rows = []
    for (s, d), whole_row in zip(ATTENTION_LEVELS, sparse_rows):
        c = h * d
        q, k, v = (torch.randn(b, TSR_FRAMES, s, c, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        whole = fa.flash_sparse_causal(*(x.view(b * TSR_FRAMES, s, c) for x in (q, k, v)),
                                       TSR_FRAMES, h, d**-0.5).view(b, TSR_FRAMES, s, c)
        mine = [x[:, start:].reshape(b * local, s, c) for x in (q, k, v)]
        kw = {"anchor": (k[:, 0].contiguous(), v[:, 0].contiguous()),
              "halo": (k[:, start - 1].contiguous(), v[:, start - 1].contiguous())}
        args = (*mine, local, h, d**-0.5)
        out = fa.flash_sparse_causal(*args, **kw)
        kf = fa.sparse_causal_kv(mine[1], local, anchor=kw["anchor"][0], halo=kw["halo"][0])
        vf = fa.sparse_causal_kv(mine[2], local, anchor=kw["anchor"][1], halo=kw["halo"][1])
        heads_first = lambda x: x.view(b * local, -1, h, d).transpose(1, 2).contiguous()  # noqa: E731
        ql, kl, vl = heads_first(mine[0]), heads_first(kf), heads_first(vf)
        row = check_row(
            "flash_sparse_causal (anchor, halo)", {"BF": b * local, "F": local, "S": s, "H": h, "d": d},
            out, fa.flash_sparse_causal_reference(*args, **kw), FLASH_TOL,
            lambda: fa.flash_sparse_causal(*args, **kw),
            lambda: fa.flash_sparse_causal_reference(*args, **kw),
            lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=d**-0.5),
            (4 * b * local * s * c + 4 * b * s * c) * 2,
            ((4 * b * local * h * s * (2 * s) * d, BF16_FLOPS),),
            equal_to_whole_rows=torch.equal(out.view(b, local, s, c), whole[:, start:]))
        row["ms_per_row"] = row["ms"] / (b * local)
        row["whole_ms_per_row"] = whole_row["ms"] / TSR_ROWS
        log(json.dumps({"kernel": row["kernel"], "shape": row["shape"],
                        "ms_per_row": row["ms_per_row"], "whole_ms_per_row": row["whole_ms_per_row"]}))
        if not row["equal_to_whole_rows"]:
            raise AssertionError(f"flash_sparse_causal (anchor, halo) {row['shape']}: rows differ "
                                 "from the whole video's call")
        rows.append(row)
        del q, k, v, whole, mine, out, kf, vf, ql, kl, vl
    half = [(s // 2, d) for s, d in ATTENTION_LEVELS]
    return {"flash_sparse_causal": rows, "temporal_base": phase_temporal(16, rope=32, levels=half),
            "temporal_tsr": phase_temporal(TSR_FRAMES, rope=0, levels=half)}


def _video_diff(got, want) -> dict:
    import numpy as np

    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"shape": list(got.shape), "max_abs_diff": int(diff.max()),
            "differing_share": float((diff > 0).mean()), "mean_abs_diff": float(diff.mean())}


def _mesh_work(rank: int) -> dict:
    """The mesh phase's work on one rank: the full-width base UNet forward
    frame-sharded over sp = 2 (collectives counted); a base video, 16 frames
    over sp = 2; TSR 16 → 61 over sp = 2 (31/30 frames); VSR's two windows
    of that video over dp = 2; one LoRA + mapper gradient at dp = 2 and
    per-rank batch 1. Rank 0 then runs each in its own process without a
    mesh (the VSR at window_batch 2, the gradient at batch 2) and compares.
    Launches are counted over the sharded runs only."""
    import numpy as np

    from lavie_tpu_torch.core import collectives
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.core.mesh import make_mesh
    from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
    from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline
    from lavie_tpu_torch.train.finetune import FinetuneConfig, LoRAFinetuner

    t_start = time.time()
    sp, dp = make_mesh(sp=2, backend="gloo"), make_mesh(dp=2, backend="gloo")
    launches, seconds, row = {}, {}, {"rank": rank}

    def sharded(name, fn):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        for k, n in read_launches().items():
            launches[k] = launches.get(k, 0) + n
        return out

    pipe = TextToVideoPipeline.init_random(seed=0, with_image_conditioning=True)
    row["init_s"] = time.time() - t_start

    # the base UNet forward, CFG-doubled 2x16x40x64, frames over sp
    x, ts, ctx, _ = unet_inputs(UNetConfig.base_t2v(), 2, 16, 40, 64, 768, seed=3, t=981.0)
    pipe.unet.set_mesh(sp)
    for fn in collectives.COLLECTIVES:
        fn.calls = fn.bytes = 0
    with torch.no_grad():
        mine = sharded("unet_forward", lambda: pipe.unet(sp.shard(x, 1, "sp").contiguous(), ts,
                                                         ctx, frames=16))
        row["collectives_per_forward"] = {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
                                          for fn in collectives.COLLECTIVES}
        got = sp.gather(mine, 1, "sp", 16).float()
        if rank == 0:
            want = pipe.unet(x, ts, ctx).float()
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            row["unet"] = {"max_abs_err": err, "max_abs_ref": scale, "rel_err": err / scale,
                           "mean_rel_err": ((got - want).abs().mean() / want.abs().mean()).item(),
                           "finite": bool(torch.isfinite(got).all())}
    del x, ctx, mine, got

    prompt = MAIN_PROMPTS[0]
    base_call = dict(num_inference_steps=MESH_STEPS["base"], guidance_scale=7.5,
                     sample_method="ddpm", seed=400)
    pipe.mesh = sp
    video = sharded("base", lambda: pipe(prompt, **base_call).video[0])
    if rank == 0:
        pipe.mesh = None
        row["base"] = _video_diff(video, pipe(prompt, **base_call).video[0])

    tsr = VideoInterpolationPipeline.init_random(seed=0)
    tsr_call = dict(prompt=prompt + ", 4k.", num_inference_steps=MESH_STEPS["tsr"],
                    guidance_scale=4.0, seed=0)
    tsr.mesh = sp
    out = sharded("tsr", lambda: tsr(video, **tsr_call).video[0])
    if rank == 0:
        tsr.mesh = None
        row["tsr"] = _video_diff(out, tsr(video, **tsr_call).video[0])
    del tsr, out
    torch.cuda.empty_cache()

    vsr = VideoSuperResolutionPipeline.init_random(seed=0)
    vsr_call = dict(prompt=prompt, num_inference_steps=MESH_STEPS["vsr"], guidance_scale=5.0,
                    noise_level=50, seed=10)
    vsr.mesh = dp
    out = sharded("vsr", lambda: vsr(video, **vsr_call).video)  # 16 frames: two windows
    if rank == 0:
        vsr.mesh, vsr.window_batch = None, 2
        row["vsr"] = _video_diff(out, vsr(video, **vsr_call).video)
    del vsr, out
    torch.cuda.empty_cache()

    # one LoRA + mapper gradient of the whole batch of two clips, per-rank batch 1
    tuner = LoRAFinetuner(pipe.unet, pipe.vae, pipe.text_encoder, pipe.vision_encoder, pipe.mapping,
                          FinetuneConfig(), mesh=dp)
    g = torch.Generator(device="cuda").manual_seed(41)
    state = tuner.init_state(g)
    with torch.no_grad():
        for k, v in state.lora.items():
            if k.endswith("lora_b"):
                v.normal_(0.0, 0.01, generator=g)
    n = len(MAIN_PROMPTS)
    batch = {"video": torch.rand(n, MESH_FRAMES, 320, 512, 3, generator=g, device="cuda") * 2 - 1,
             "token_ids": torch.from_numpy(pipe.tokenizer(MAIN_PROMPTS).astype(np.int64)).cuda(),
             "cond_image": torch.randn(n, 224, 224, 3, generator=g, device="cuda")}
    draws = {"posterior_noise": torch.randn(n * MESH_FRAMES, 40, 64, 4, generator=g, device="cuda"),
             "t": torch.tensor([500, 300], device="cuda"),
             "noise": torch.randn(n, MESH_FRAMES, 40, 64, 4, generator=g, device="cuda")}
    loss, aux, grads = sharded("train", lambda: tuner.grads(state, batch, **draws))
    if rank == 0:
        tuner.mesh = None
        loss_p, aux_p, grads_p = tuner.grads(state, batch, **draws)
        row["train"] = {"loss": [loss.item(), loss_p.item()], "mse": [aux[0].item(), aux_p[0].item()],
                        "align": [aux[1].item(), aux_p[1].item()],
                        "lora": _grad_stats(grads, grads_p, "lora/"),
                        "mapper": _grad_stats(grads, grads_p, "mapper/")}
    row.update({"seconds": seconds, "launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "total_s": time.time() - t_start})
    return row


def _mesh_rank(rank: int, world: int, folder: str) -> None:
    """One rank of the mesh phase, a process of its own on the one card:
    joins the gloo group through a file in `folder` and writes its row there.
    PyTorch's attention operator is held to its FlashAttention and
    memory-efficient backends here: its default on the card, cuDNN's,
    answers the same inputs differently from one process to the next
    (module outputs hashed in pairs of fresh processes), which would hide
    what sharding changes."""
    import datetime

    import torch.distributed as dist
    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            row = _mesh_work(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)


def _spawn(target, world: int, folder: str, timeout: float = MESH_TIMEOUT) -> list:
    """Run target(rank, world, folder) in `world` spawned processes; their
    exit codes (None: killed after `timeout` seconds)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, folder)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def phase_mesh() -> dict:
    """Two ranks on the one card over gloo (_mesh_work), each checked
    against one process: the base UNet forward's relative error, the
    videos' uint8 differences, the gradients' relative norm error; seconds,
    peak memory and launches per rank. Returns the launches of both ranks'
    sharded runs."""
    import tempfile

    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as folder:
        codes = _spawn(_mesh_rank, 2, folder)
        if codes != [0, 0]:
            raise AssertionError(f"mesh: rank exit codes {codes}")
        rows = []
        for r in range(2):
            with open(os.path.join(folder, f"rank{r}.json")) as f:
                rows.append(json.load(f))
    for row in rows:
        log(json.dumps({"phase": "mesh", **row}))
    ref = rows[0]
    log(json.dumps({"phase": "mesh", "seconds": time.time() - t0}))
    if not (ref["unet"]["finite"] and ref["unet"]["rel_err"] <= MESH_TOL["unet"]):
        raise AssertionError(f"mesh: the frame-sharded UNet against one process: {ref['unet']}")
    for stage, bound in MESH_TOL["mean_abs_diff"].items():
        if ref[stage]["mean_abs_diff"] > bound:
            raise AssertionError(f"mesh: {stage} video against one process: {ref[stage]}")
    tr = ref["train"]
    if abs(tr["loss"][0] - tr["loss"][1]) > MESH_TOL["loss"] * abs(tr["loss"][1]):
        raise AssertionError(f"mesh: train loss {tr['loss']}")
    for group in ("lora", "mapper"):
        if not (tr[group]["finite"] and tr[group]["rel_norm_err"] <= MESH_TOL["grads"]
                and tr[group]["cosine"] >= MESH_TOL["cosine"]):
            raise AssertionError(f"mesh: {group} gradients at dp = 2 against one process: {tr[group]}")
    launches = {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}
    for name in ("temporal_attention", "geglu", "flash_sparse_causal", "gn_silu_tconv",
                 "cross_attention_head", "transformer_tail", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"mesh: {name} was not launched on the mesh path")
    assert_default_routes("mesh", launches)
    return launches


def _nccl_two_ranks(rank: int, world: int, folder: str) -> None:
    """An all_reduce over NCCL with both ranks on card 0; writes what NCCL
    said (an error message, or the sum)."""
    import datetime

    import torch.distributed as dist

    try:
        dist.init_process_group("nccl", init_method=f"file://{folder}/rendezvous", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        said = f"all_reduce gave {x.item()}"
        dist.destroy_process_group()
    except Exception as e:  # the refusal is the measurement: its message is kept
        said = f"{type(e).__name__}: {e}"
    with open(os.path.join(folder, f"rank{rank}.txt"), "w") as f:
        f.write(said)


def phase_nccl() -> dict:
    """NCCL at world size 1, in this process: make_mesh(backend="nccl"), the
    base UNet forward with frames over the one-rank sp axis equal bit for
    bit to the meshless forward, and each collective over NCCL against its
    result computed here (frames_to_positions and back, the sparse-causal
    halo, all_reduce_sum in float64, all_gather_uneven); then what NCCL says
    to two ranks on the one card."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from lavie_tpu_torch.core import collectives as coll
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.core.mesh import make_mesh
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with tempfile.TemporaryDirectory() as folder:
        dist.init_process_group("nccl", init_method=f"file://{folder}/rendezvous", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            mesh = make_mesh(backend="nccl")
            with torch.device("cuda"):
                unet = UNet3D(UNetConfig.base_t2v()).to(torch.bfloat16).eval()
            random_init_(unet, seed=7)
            x, ts, ctx, _ = unet_inputs(UNetConfig.base_t2v(), 2, 16, 40, 64, 768, seed=3, t=981.0)
            with torch.no_grad():
                want = unet(x, ts, ctx)
                unet.set_mesh(mesh)
                got = unet(x, ts, ctx, frames=16)
            shard = coll.FrameShard(mesh.groups["sp"], (16,), 0)
            g = torch.Generator(device="cuda").manual_seed(5)
            y = torch.randn(2, 16, 2560, 320, generator=g, device="cuda").bfloat16()
            k, v = (torch.randn(32, 640, 640, generator=g, device="cuda").bfloat16() for _ in range(2))
            halo = torch.stack(coll.sparse_causal_halo(k, v, shard))
            first_k, first_v = k.view(2, 16, 640, 640)[:, 0], v.view(2, 16, 640, 640)[:, 0]
            s64 = torch.randn(2, 32, generator=g, device="cuda", dtype=torch.float64)
            checks = {
                "unet_forward_bit_equal": torch.equal(got, want),
                "frames_to_positions_round_trip": torch.equal(
                    coll.positions_to_frames(coll.frames_to_positions(y, shard), shard), y),
                "sparse_causal_halo": torch.equal(halo, torch.stack([first_k, first_v, first_k,
                                                                      first_v])),
                "all_reduce_sum": torch.equal(coll.all_reduce_sum(s64, mesh.groups["sp"]), s64),
                "all_gather_uneven": torch.equal(mesh.gather(y, 1, "sp", 16), y)}
            backend = dist.get_backend(mesh.groups["sp"])
        finally:
            dist.destroy_process_group()
        del unet, x, ctx, want, got, y, k, v
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as folder:
        codes = _spawn(_nccl_two_ranks, 2, folder, timeout=120)
        said = []
        for r in range(2):
            path = os.path.join(folder, f"rank{r}.txt")
            said.append(open(path).read() if os.path.exists(path) else f"no answer (exit {codes[r]})")
    row = {"phase": "nccl", "backend": backend, "world_size": 1, **checks,
           "two_ranks_one_card": said}
    log(json.dumps(row))
    if backend != "nccl" or not all(checks.values()):
        raise AssertionError(f"nccl: {row}")
    return row


TP_FRAMES = 16  # the tp step's clip: batch 1, 16x40x64 latents (the train phase's)
TP_LR, TP_MAX_NORM = 1e-4, 1.0
# the tp step against one process: the loss and gradients within MESH_TOL
# (bf16 at other GEMM shapes, the row-parallel partials summed in fp32 before
# one rounding); after one AdamW step each parameter within the two updates'
# reach of the other's: at step 1 Adam's term m/(sqrt(v) + eps) is at most 1
# in magnitude and the decay term is the same in both, so two runs differ by
# at most 2·lr before rounding, and each bf16 rounding by half an ulp (at
# most 2^-8 of the value)
TP_REACH_LR, TP_HALF_ULP = 2.002, 2.0 ** -8


def _stream_stats(got: dict, want: dict, keys) -> dict:
    """Relative norm error and cosine of got against want over `keys`,
    summed tensor by tensor (got on the host, want on the card)."""
    d2 = p2 = g2 = gp = 0.0
    finite = True
    for k in keys:
        g, w = got[k].to("cuda", torch.float32), want[k].float()
        finite &= bool(torch.isfinite(g).all())
        d2 += float(((g - w) ** 2).sum())
        p2 += float((w * w).sum())
        g2 += float((g * g).sum())
        gp += float((g * w).sum())
    return {"tensors": len(keys), "rel_norm_err": (d2 / p2) ** 0.5, "cosine": gp / (g2 * p2) ** 0.5,
            "norm": p2 ** 0.5, "finite": finite}


def _tp_unet():
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    with torch.device("cuda"):
        unet = UNet3D(UNetConfig.base_t2v()).to(torch.bfloat16)
    random_init_(unet, seed=7)
    return unet


def _tp_steps(unet, mesh) -> tuple:
    """Two full-parameter steps (bf16 parameters, fp32 moments) of `unet`
    on `mesh` (None: one process) over one fixed batch and fixed draws:
    of the first step its loss, the gradients its optimizer got and the
    clipping norm, the parameters after it (this rank's, on the host), its
    peak GB, launches and tp collectives, and N·C of each feed-forward
    input; the seconds of both steps."""
    from lavie_tpu_torch.core import tensor_parallel as tpm
    from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
    from lavie_tpu_torch.nn.transformer import FeedForward
    from lavie_tpu_torch.train.optim import AdamW
    from lavie_tpu_torch.train.step import TrainState, make_train_step

    g = torch.Generator(device="cuda").manual_seed(61)
    batch = {"latents": torch.randn(1, TP_FRAMES, 40, 64, 4, generator=g, device="cuda"),
             "text_states": torch.randn(1, 77, 768, generator=g, device="cuda")}
    draws = {"t": torch.tensor([500], device="cuda"),
             "noise": torch.randn(1, TP_FRAMES, 40, 64, 4, generator=g, device="cuda")}
    opt = AdamW(TP_LR, max_grad_norm=TP_MAX_NORM)
    seen = {}
    update = opt.step

    def spy(params, grads, state, square_sum=None):
        if "grads" not in seen:
            sq = sum((x.float() ** 2).sum() for x in grads.values()) if square_sum is None \
                else square_sum(grads)
            seen.update(grads={k: v.detach().cpu() for k, v in grads.items()}, norm=float(sq) ** 0.5)
        return update(params, grads, state, square_sum=square_sum)

    opt.step = spy
    step = make_train_step(unet, NoiseSchedule.create(), opt, min_snr_gamma=5.0, mesh=mesh)
    state = TrainState.create(dict(unet.named_parameters()), opt)
    tokens = []
    hooks = [m.register_forward_hook(lambda mod, a, out: tokens.append(a[0].numel()))
             for m in unet.modules() if isinstance(m, FeedForward)]
    for fn in tpm.TP_COLLECTIVES:
        fn.calls = fn.bytes = 0
    seconds = []
    for i in range(2):
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
        t0 = time.time()
        state, loss = step(state, batch, **draws)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        if i == 0:
            out = {"loss": float(loss), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": read_launches(), "tokens": list(tokens),
                   "collectives": {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
                                   for fn in tpm.TP_COLLECTIVES},
                   "params": {k: v.detach().cpu().clone() for k, v in state.params.items()}}
            for h in hooks:
                h.remove()
    return {**out, "grads": seen["grads"], "clip_norm": seen["norm"], "s_per_step": seconds}


def _tp_work(rank: int) -> dict:
    """The tp phase on one rank of a (1, 1, 2) mesh: the full-width base
    UNet split over tp (heads 8 → 4, GEGLU's I = 4C → 2C), two steps; the
    gradients and parameters of the first gathered whole. Rank 0 then frees
    its share and runs the same two steps in its own process without a
    mesh, and compares."""
    from lavie_tpu_torch.core import tensor_parallel as tpm
    from lavie_tpu_torch.core.mesh import make_mesh
    from lavie_tpu_torch.nn.attention import TemporalAttention
    from lavie_tpu_torch.nn.transformer import FeedForward

    t_start = time.time()
    mesh = make_mesh(tp=2, backend="gloo")
    unet = _tp_unet()
    run = _tp_steps(unet, mesh)
    grads, params, tokens = run.pop("grads"), run.pop("params"), run.pop("tokens")
    ff = [m for m in unet.modules() if isinstance(m, FeedForward)]
    temporal = [m for m in unet.modules() if isinstance(m, TemporalAttention)]
    row = {"rank": rank, **run,
           "geglu_inner_over_c": sorted({m.net[2].weight.shape[1] / m.net[2].weight.shape[0]
                                         for m in ff}),
           "temporal_heads": sorted({m.heads for m in temporal}), "blocks": len(ff),
           "local_params": sum(p.numel() for p in params.values())}
    # the computed figure: 4 fp32 reduces of N·C a block each way, and
    # backward the bias table and GEGLU's b0, whose rows the ranks share
    table = sum(m.time_rel_pos_bias.relative_attention_bias.weight.numel() for m in temporal) * 4
    b0 = sum(m.net[0].proj.bias.numel() for m in ff) * 4
    row["computed_collectives"] = {
        "reduce_from_tp": {"calls": 4 * len(ff), "bytes": sum(4 * 4 * nc for nc in tokens)},
        "copy_to_tp": {"calls": 6 * len(ff), "bytes": sum(4 * 4 * nc for nc in tokens) + table + b0}}
    del unet
    grads = tpm.gather_parameters(grads, mesh)
    params = tpm.gather_parameters(params, mesh)
    torch.cuda.empty_cache()
    if rank == 0:
        unet = _tp_unet()
        before = {k: v.detach().cpu().clone() for k, v in unet.named_parameters()}
        one = _tp_steps(unet, None)
        del unet
        torch.cuda.empty_cache()
        grads_p, params_p = one.pop("grads"), one.pop("params")
        keys = sorted(grads_p)
        grads_p = {k: v.cuda() for k, v in grads_p.items()}
        row["one_process"] = {k: one[k] for k in ("loss", "clip_norm", "s_per_step", "peak_mem_gb",
                                                  "launches")}
        row["grads"] = {"split": _stream_stats(grads, grads_p, [k for k in keys if tpm.tp_param_spec(
            k, grads_p[k].shape)]), "all": _stream_stats(grads, grads_p, keys)}
        del grads_p
        # each parameter after the step within both steps' reach of the other's
        worst, moved = 0.0, 0
        for k in keys:
            p0, got, want = before[k].float(), params[k].float(), params_p[k].float()
            reach = TP_REACH_LR * TP_LR + TP_HALF_ULP * (got.abs() + want.abs())
            worst = max(worst, float(((got - want).abs() / reach).max()))
            moved += int((want != p0).sum())
        row["params"] = {"worst_diff_over_reach": worst, "moved_share": moved / sum(
            v.numel() for v in params_p.values()), "rel_norm_err": _stream_stats(
                params, {k: v.cuda() for k, v in params_p.items()}, keys)["rel_norm_err"]}
    row["total_s"] = time.time() - t_start
    return row


def _tp_rank(rank: int, world: int, folder: str) -> None:
    """One rank of the tp phase, a process of its own on the one card (gloo
    through a rendezvous file in `folder`; SDPA held to the backends that
    answer alike in every process, as in _mesh_rank); writes its row."""
    import datetime

    import torch.distributed as dist
    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            row = _tp_work(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
        json.dump(row, f)


def phase_tp() -> dict:
    """Tensor-parallel training: two ranks share the card over gloo on a
    (1, 1, 2) mesh, each running the full-parameter make_train_step of the
    full-width base UNet (909M parameters, bf16, fp32 moments; batch 1,
    16x40x64 latents, fixed draws) with its attention and feed-forward
    projections split over tp; against rank 0's one-process steps: loss,
    gradients (relative norm, cosine), parameters after the step; seconds
    per step and peak memory per rank against one process's; the tp
    collectives' calls and bytes against the computed figure; geglu
    launched at I = 2C and the temporal attention at H = 4. Returns the
    launches of both ranks' first steps."""
    import tempfile

    torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as folder:
        codes = _spawn(_tp_rank, 2, folder)
        if codes != [0, 0]:
            raise AssertionError(f"tp: rank exit codes {codes}")
        rows = []
        for r in range(2):
            with open(os.path.join(folder, f"rank{r}.json")) as f:
                rows.append(json.load(f))
    for row in rows:
        log(json.dumps({"phase": "tp", **row}))
    ref = rows[0]
    log(json.dumps({"phase": "tp", "seconds": time.time() - t0}))
    one = ref["one_process"]
    for row in rows:
        if abs(row["loss"] - one["loss"]) > MESH_TOL["loss"] * abs(one["loss"]):
            raise AssertionError(f"tp: loss {row['loss']} against one process's {one['loss']}")
        if row["collectives"] != row["computed_collectives"]:
            raise AssertionError(f"tp: collectives {row['collectives']} against the computed "
                                 f"{row['computed_collectives']}")
        if not row["peak_mem_gb"] < one["peak_mem_gb"]:
            raise AssertionError(f"tp: rank {row['rank']} peak {row['peak_mem_gb']} GB, one "
                                 f"process {one['peak_mem_gb']} GB")
        if row["geglu_inner_over_c"] != [2.0] or row["temporal_heads"] != [4]:
            raise AssertionError(f"tp: geglu I/C {row['geglu_inner_over_c']}, temporal heads "
                                 f"{row['temporal_heads']}")
        for name in ("geglu", "temporal_attention"):
            if row["launches"][name] != row["blocks"]:
                raise AssertionError(f"tp: {name} launched {row['launches'][name]} times in a "
                                     f"step, {row['blocks']} blocks")
        assert_default_routes("tp", row["launches"])
    for group in ("split", "all"):
        st = ref["grads"][group]
        if not (st["finite"] and st["rel_norm_err"] <= MESH_TOL["grads"]
                and st["cosine"] >= MESH_TOL["cosine"]):
            raise AssertionError(f"tp: {group} gradients against one process: {st}")
    if not ref["params"]["worst_diff_over_reach"] <= 1.0:
        raise AssertionError(f"tp: parameters after the step: {ref['params']}")
    return {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    # the run's clock after each group of phases, for choosing what to cut
    mark = lambda what: log(f"[chip_smoke] {what} done at {time.time() - t_start:.1f} s")  # noqa: E731
    phase_device()
    phase_build()
    mark("build")
    group_norm_rows = phase_group_norm()
    bias_residual_rows = phase_bias_residual()
    temporal_rows = phase_temporal(16, rope=32)
    phase_temporal(TSR_FRAMES, rope=0)
    geglu_rows = phase_geglu(16)
    phase_geglu(TSR_FRAMES)
    sparse_rows, kv_row = phase_flash()
    mesh_rows = phase_mesh_kernels(sparse_rows)
    # what a tp = 2 rank of the training step calls: 4 of the 8 heads, I = 2C
    tp_rows = {"temporal": phase_temporal(16, rope=32, b=1, h=4),
               "geglu": phase_geglu(16, b=1, tp=2)}
    mark("kernels")
    from lavie_tpu_torch.core.config import UNetConfig

    phase_model("model", UNetConfig.base_t2v(), 16)
    phase_model("model_tsr", UNetConfig.interpolation(), TSR_FRAMES)
    mark("model, model_tsr")
    main_launches, main_videos = phase_main()
    base_video = main_videos[0]
    eval_launches = phase_eval(main_videos, MAIN_PROMPTS)
    mark("main, eval")
    image_launches, image_pipe = phase_image()
    train_launches = phase_train(image_pipe)
    del image_pipe
    torch.cuda.empty_cache()
    mark("image, train")
    tsr_launches = phase_tsr(base_video)
    mark("tsr")
    phase_temporal(VSR_FRAMES, rope=32, b=1,
                   levels=[(s, 64) for s, _ in VSR_LEVELS[1:3]] + [(VSR_LEVELS[3][0], 128)])
    phase_geglu(VSR_FRAMES, shapes=[(VSR_FRAMES * 10240, 512), (VSR_FRAMES * 2560, 1024)])
    vsr_rows = phase_vsr_kernels()
    phase_model("model_vsr", UNetConfig.vsr(), VSR_FRAMES, batch=1, h=320, w=512, ctx_dim=1024)
    vsr_launches = phase_vsr(base_video)
    mark("vsr_kernels, model_vsr, vsr")
    # the temporal module's versatile branch and the tiled f4 codec
    branch_rows = phase_branch_kernels()
    branch_launches = phase_vsr_branches()
    tiled_launches = phase_tiled_decode()
    mark("branch_kernels, vsr_branches, tiled_decode")
    # multi-GPU: two ranks on the one card over gloo, then NCCL at world size 1
    mesh_launches = phase_mesh()
    phase_nccl()
    mark("mesh, nccl")
    # tensor-parallel training: two ranks over gloo, the full-parameter step
    tp_launches = phase_tp()
    mark("tp")
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
    mark("optin, ab_vsr, ab_base")
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
    mark("cross_kernels, temporal_proj_kernels, ab_attn2, ab_temporal_proj")
    # the int8 turbo mode: its pieces, then each UNet in the three settings
    turbo_rows = phase_turbo_kernels()
    phase_ab_turbo("ab_turbo_vsr", UNetConfig.vsr(), VSR_FRAMES, batch=1, h=320, w=512, ctx_dim=1024)
    phase_ab_turbo("ab_turbo_base", UNetConfig.base_t2v(), 16, batch=2, h=40, w=64, ctx_dim=768)
    mark("turbo_kernels, ab_turbo")
    ckpt_launches = phase_ckpt()
    mark("ckpt")
    cascade_launches = phase_cascade()
    mark("cascade")

    def entry(name, source, replaces, row, note=None, counter=None, ab=None, extra=None):
        counter = counter or name
        by_path = {"main": main_launches[counter], "eval": eval_launches[counter],
                   "image": image_launches[counter],
                   "train": train_launches[counter], "tsr": tsr_launches[counter],
                   "vsr": vsr_launches[counter], "vsr_branches": branch_launches[counter],
                   "tiled_decode": tiled_launches[counter], "mesh": mesh_launches[counter],
                   "tp": tp_launches[counter],
                   "ckpt": ckpt_launches[counter], "cascade": cascade_launches[counter]}
        if ab is not None:  # the launches of one A/B forward with the route set
            by_path["ab"] = ab[counter]
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"], "shape": row["shape"]}
        if note:
            e["note"] = note
        if extra:
            e.update(extra)
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
              "lavie_tpu/kernels/temporal_fused.py:446", temporal_rows[0],
              extra={"half_positions": [{k: r[k] for k in BRANCH_ROW_KEYS}
                                        for r in mesh_rows["temporal_base"] + mesh_rows["temporal_tsr"]],
                     "tp_heads": [{k: r[k] for k in BRANCH_ROW_KEYS} for r in tp_rows["temporal"]]}),
        entry("geglu", "lavie_tpu_torch/csrc/geglu.cu", "lavie_tpu/kernels/geglu.py:85", geglu_rows[0],
              extra={"versatile_ff": [{k: r[k] for k in BRANCH_ROW_KEYS}
                                      for r in branch_rows["geglu"]],
                     "tp_shard": [{k: r[k] for k in BRANCH_ROW_KEYS} for r in tp_rows["geglu"]]}),
        entry("flash_sparse_causal", "lavie_tpu_torch/csrc/flash_attention.cu",
              "lavie_tpu/kernels/flash_attention.py:407", sparse_rows[0],
              extra={"anchor_halo": [{k: r[k] for k in BRANCH_ROW_KEYS + ("ms_per_row",
                                                                         "whole_ms_per_row")}
                                     for r in mesh_rows["flash_sparse_causal"]]}),
        entry("flash_attention_kv", "lavie_tpu_torch/csrc/flash_attention.cu",
              "lavie_tpu/kernels/flash_attention.py:302", kv_row,
              note="kernels phase only: no path of the port materialises the sparse kv"),
        entry("flash_attention", "lavie_tpu_torch/csrc/flash_attention.cu",
              "lavie_tpu/kernels/flash_attention.py:453", vsr_rows["flash_attention"][1],
              note="the VAE's d=512 shape; the L3 d=128 row is in the vsr_kernels phase",
              extra={"tiled_decode_tile": {k: branch_rows["flash_attention"][k]
                                           for k in BRANCH_ROW_KEYS}}),
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
                   "in-model launches are those of the ab_attn2 phase and, over the image "
                   "path's 154 keys (the 160-key wgmma body), of the image phase's A/B forward",
              ab=ab_attn2_launches["cross"],
              extra={"launches_image_ab": image_launches["cross_attention_ab"],
                     "keys_154": [{k: r[k] for k in CROSS_ROW_KEYS}
                                  for r in cross_rows["cross_attention_154"]],
                     "keys_256": [{k: r[k] for k in CROSS_ROW_KEYS + ("threads",)}
                                  for r in cross_rows["cross_attention_256"]]}),
        entry("fused_ln_cross_attention", "lavie_tpu_torch/csrc/cross_block.cu",
              "lavie_tpu/kernels/cross_block.py:293", cross_rows["fused_ln_cross_attention"][0],
              note="entry fused_ln_cross_attention_bf16: fused_ln_kernel (the LayerNorm pass), "
                   "fused_gemm_kernel (staged wgmma GEMM, EPI_SCALE), fused_attn_kernel "
                   "(csrc/cross_attn.cuh's body), fused_gemm_kernel (EPI_BIAS_RES); opt-in "
                   "(LAVIE_ATTN2=fused): launched on the cascade path and in ab_attn2",
              ab=ab_attn2_launches["fused"]),
        entry("ln_qkv", "lavie_tpu_torch/csrc/temporal_proj.cu", "lavie_tpu/kernels/temporal_proj.py:69",
              proj_rows["ln_qkv"][0],
              note="opt-in (LAVIE_TEMPORAL_PROJ=1): launched on the cascade path and in ab_temporal_proj",
              ab=ab_proj_launches["1"]),
        entry("out_proj_residual", "lavie_tpu_torch/csrc/temporal_proj.cu",
              "lavie_tpu/kernels/temporal_proj.py:141", proj_rows["out_proj_residual"][0],
              note="entry out_proj_residual_bf16: out_proj_gemm_kernel (staged wgmma GEMM, "
                   "EPI_BIAS_RES, the residual loaded by TMA); opt-in (LAVIE_TEMPORAL_PROJ=1): "
                   "launched on the cascade path and in ab_temporal_proj",
              ab=ab_proj_launches["1"]),
    ]}))
    gn_row = group_norm_rows[0]  # the base UNet's L0 resnet norm1
    log(json.dumps({"kernels_new": [{
        "name": "group_norm", "route": "cuda", "source": "lavie_tpu_torch/csrc/group_norm.cu",
        "replaces": "no Pallas kernel: the JAX package leaves GroupNorm to XLA "
                    "(lavie_tpu/nn/layers.py:45, groupnorm_affine); the port's eager GroupNorm",
        "launches_main": main_launches["group_norm"], **{k: gn_row[k] for k in BRANCH_ROW_KEYS},
        "eager_ms": gn_row["eager_ms"], "device_ms": gn_row["device_ms"],
        "shapes": [{k: r[k] for k in BRANCH_ROW_KEYS + ("eager_ms", "device_ms")}
                   for r in group_norm_rows]}, {
        "name": "bias_residual", "route": "cuda", "source": "lavie_tpu_torch/csrc/bias_residual.cu",
        "replaces": "no Pallas kernel: the JAX package leaves the convs' biases and the residual "
                    "add to XLA; ATen's add_ of each conv's bias after cuDNN, then x + h",
        "launches_main": main_launches["bias_residual"],
        "shapes": [{k: r[k] for k in BRANCH_ROW_KEYS + ("device_ms", "library_device_ms")}
                   for r in bias_residual_rows]}]}))
    log(f"[chip_smoke] {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
