"""A/B of the VSR slice's kernels between two checkouts, on one card.

    python3 chip_ab.py ROOT TAG          # once per checkout, in turns
    python3 chip_ab.py --compare TAG1 TAG2
    python3 chip_ab.py --cluster4 ROOT DEST
    python3 chip_ab.py --video ROOT TAG  # once per checkout, in turns
    python3 chip_ab.py --sparse ROOT TAG  # once per checkout, in turns
    python3 chip_ab.py --compare-sparse TAG1 TAG2

The first form imports chip_smoke.py and lavie_tpu_torch from the checkout
at ROOT, builds that checkout's kernels there and prints one JSON line for
TAG: the SASS op counts (all ops, HGMMA, UTMALDG) of each instance of
GEGLU's GEMMs, of the transformer tail's LayerNorm pass and GEMMs, of the
d <= 160 flash body, of the temporal projections' kernels and of the fused
attn2's, and the ms per call (CUDA events, chip_smoke.time_ms)
of GEGLU at the base L0, TSR L0 and the two VSR shapes, of
cross_attention_head and transformer_tail at VSR L1 and L2, of the d <= 160
flash body as rows 4 (VSR L3), 5 (TSR L0 over the materialised kv) and 6
(the four TSR levels), of the f4 VAE's d=512 flash attention over one
8-frame window (one timed call), of gn_silu_tconv at the eight VSR shapes
(one CFG half of an 8-frame window), of its int8 variant at three VSR
shapes, of ln_qkv at the four base levels and the three VSR levels, of
out_proj_residual at the base L0, TSR L0 and VSR L1 levels and of
fused_ln_cross_attention at the base L0, TSR L0 and VSR L3 levels, and
the device ms of a full-width VSR UNet half-forward in bf16 and in int8
turbo (chip_smoke's ab_turbo_vsr). The
inputs come from fixed seeds, so every checkout sees the same ones; the
int8 outputs are saved to build/ab_int8_TAG.pt beside this script. Run
parent, change, change, parent in one call: two versions are compared only
on one card. The second form says whether the int8 outputs y of two tags
are equal bit for bit, and how far apart their statistics are (Σy, Σy²:
sums of the same values, taken in another order by another kernel, are
held to SUMS_TOL of max|Σ|); the yardstick of a change to the int8 kernels
is the tag of a checkout that computes the same function. The
third copies the checkout at ROOT to DEST with the d=512 flash kernel's
cluster of 2 CTAs set to 4 (csrc/flash_attention.cu's W_CLUSTER), a
variant for the first form to time beside the checkout. The fourth makes
three full-width base videos (16x320x512, 50 DDPM steps, CFG 7.5, the
same seeds) with the checkout at ROOT in a process of its own and prints
their seconds (the first builds the kernels it needs) and the last video's
md5: the default path of two checkouts, timed end to end in turns. The
fifth runs the checkout's sparse-causal flash entry (row 6) over the whole
video at the four TSR levels (B·F = 2·61 rows, 8 heads) on seeded inputs,
the same for every checkout, prints its ms per call (CUDA events) and saves
its outputs to build/ab_sparse_TAG.pt beside this script; the sixth says
whether two tags' outputs are equal bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
VSR_LEVELS = [(163840, 256), (40960, 512), (10240, 512), (2560, 1024)]
GEGLU_SHAPES = [(81920, 320), (312320, 320), (81920, 512), (20480, 1024)]
INT8_SHAPES = [(8, 40960, 512, 5, False), (8, 10240, 512, 3, True), (5, 10240, 512, 5, False)]
# (S, head dim) of the TSR UNet's levels, B = 2 CFG x 61 frames, 8 heads
TSR_LEVELS = [(2560, 40), (640, 80), (160, 160), (40, 160)]
# (B, F, S, C) of ln_qkv: the base levels, then the VSR levels (one CFG half)
PROJ_SHAPES = [(2, 16, 2560, 320), (2, 16, 640, 640), (2, 16, 160, 1280), (2, 16, 40, 1280),
               (1, 8, 40960, 512), (1, 8, 10240, 512), (1, 8, 2560, 1024)]
# (B, F, S, C) of out_proj_residual: base L0, TSR L0, VSR L1 (one CFG half)
OUT_PROJ_SHAPES = [(2, 16, 2560, 320), (2, 61, 2560, 320), (1, 8, 40960, 512)]
# (B, N, C, head dim) of the fused attn2: base L0, TSR L0, VSR L3 (one CFG half)
FUSED_SHAPES = [(2, 16 * 2560, 320, 40), (2, 61 * 2560, 320, 40), (1, 8 * 2560, 1024, 128)]
SUMS_TOL = 1e-4


def run(root: str, tag: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from lavie_tpu_torch.kernels import _build
    from lavie_tpu_torch.kernels import cross_block as cb
    from lavie_tpu_torch.kernels import flash_attention as fa
    from lavie_tpu_torch.kernels import geglu as gg
    from lavie_tpu_torch.kernels import temporal_proj as tp
    from lavie_tpu_torch.kernels import temporal_resblock as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0)}
    _build.build(["geglu", "temporal_resblock", "transformer_tail", "flash_attention", "temporal_proj",
                  "cross_block"])
    # keyed by the kernel's own name (the mangled prefix holds a hash of the source file)
    for lib, subs in (("geglu", ("geglu_pingpong_kernel", "geglu_coop_kernel")),
                      ("transformer_tail", ("tail_gemm_", "tail_ln_kernel")),
                      ("flash_attention", ("flash_kernel",)),
                      ("temporal_proj", ("ln_qkv_", "out_proj_")),
                      ("cross_block", ("single_kernel", "fused_"))):
        sass = {}
        for name, ops in _build.sass_op_counts(_build.library_path(lib)).items():
            if any(sub in name for sub in subs):
                key = name[name.index(next(sub for sub in subs if sub in name)):]
                sass[key] = {"all": sum(ops.values()),
                             **{p: sum(n for op, n in ops.items() if op.startswith(p)) for p in ("HGMMA", "UTMALDG")}}
        row[f"{lib}_sass"] = sass

    g = torch.Generator(device="cuda").manual_seed(5)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    row["geglu_ms"] = {}
    for n, c in GEGLU_SHAPES:
        args = (bf(n, c), bf(8 * c, c, sd=c ** -0.5), bf(8 * c, sd=0.1), bf(c, 4 * c, sd=(4 * c) ** -0.5),
                bf(c, sd=0.1))
        row["geglu_ms"][f"N={n} C={c}"] = cs.time_ms(lambda: gg.geglu(*args))
        del args
    row["tail_ms"], row["head_ms"] = {}, {}
    for s, c in VSR_LEVELS[1:3]:
        n = 8 * s
        targs = (bf(n, c), bf(n, c), f32(c, m=1.0), f32(c), bf(8 * c, c, sd=c ** -0.5), f32(8 * c),
                 bf(c, 4 * c, sd=(4 * c) ** -0.5), f32(c), bf(c, c, sd=c ** -0.5), f32(c))
        row["tail_ms"][f"N={n}"] = cs.time_ms(lambda: cb.transformer_tail(*targs))
        del targs
        attn = lambda: (f32(c, m=1.0), f32(c), bf(c, c, sd=c ** -0.5), bf(c, c, sd=c ** -0.5),  # noqa: E731
                        f32(c), bf(1, 77, c), bf(1, 77, c))
        hargs = (bf(1, n, c), bf(c, c, sd=c ** -0.5), f32(c), attn(), attn(), c // 64, 0.125)
        row["head_ms"][f"N={n}"] = cs.time_ms(lambda: cb.cross_attention_head(*hargs))
        del hargs
    # the d <= 160 flash body: row 4 at VSR L3, row 5 over TSR L0's
    # materialised kv, row 6 at the TSR levels
    q, k, v = (bf(8, VSR_LEVELS[3][0], 8, 128) for _ in range(3))
    row["flash_ms"] = {"row 4 (8, 2560, 8, 128)": cs.time_ms(lambda: fa.flash_attention(q, k, v, 128 ** -0.5))}
    q, k, v = bf(122, 2560, 320), bf(122, 5120, 320), bf(122, 5120, 320)
    row["flash_ms"]["row 5 (122, 2560, 5120, 320)"] = cs.time_ms(
        lambda: fa.flash_attention_kv(q, k, v, 8, 40 ** -0.5))
    for s, d in TSR_LEVELS:
        q, k, v = (bf(122, s, 8 * d) for _ in range(3))
        row["flash_ms"][f"row 6 S={s} d={d}"] = cs.time_ms(
            lambda: fa.flash_sparse_causal(q, k, v, 61, 8, d ** -0.5))
    row["ln_qkv_ms"] = {}
    for b, f, s, c in PROJ_SHAPES:
        args = (bf(b, f, s, c), f32(c, m=1.0), f32(c), *(bf(c, c, sd=c ** -0.5) for _ in range(3)))
        row["ln_qkv_ms"][f"B={b} F={f} S={s} C={c}"] = cs.time_ms(lambda: tp.ln_qkv(*args))
        del args
    row["out_proj_ms"] = {}
    for b, f, s, c in OUT_PROJ_SHAPES:
        args = (bf(b, f, s, c), bf(b, f, s, c), bf(c, c, sd=c ** -0.5), f32(c))
        row["out_proj_ms"][f"B={b} F={f} S={s} C={c}"] = cs.time_ms(lambda: tp.out_proj_residual(*args))
        del args
    row["fused_attn2_ms"] = {}
    for b, n, c, d in FUSED_SHAPES:
        p = (f32(c, m=1.0), f32(c), bf(c, c, sd=c ** -0.5), bf(c, c, sd=c ** -0.5), f32(c),
             bf(b, 77, c), bf(b, 77, c))
        args = (bf(b, n, c), p, c // d, d ** -0.5)
        row["fused_attn2_ms"][f"B={b} N={n} C={c}"] = cs.time_ms(
            lambda: cb.fused_ln_cross_attention(*args))
        del p, args
    q, k, v = (bf(8, VSR_LEVELS[0][0], 1, 512) for _ in range(3))
    row["flash_d512_ms"] = cs.time_ms(lambda: fa.flash_attention(q, k, v, 512 ** -0.5), 1, 1)
    del q, k, v
    row["tconv_ms"] = {}
    for s, c in VSR_LEVELS:
        for k, res in ((5, False), (3, True)):
            args = (bf(1, 8, s, c), f32(1, c, m=1.0), f32(1, c), bf(k, c, c, sd=c ** -0.5), f32(1, c),
                    bf(1, 8, s, c) if res else None)
            row["tconv_ms"][f"S={s} C={c} k={k}"] = cs.time_ms(lambda: tr.gn_silu_tconv(*args))
            del args
    row["int8_ms"], outs = {}, []
    for f, s, c, k, res in INT8_SHAPES:
        args = (bf(1, f, s, c), f32(1, c, m=1.0), f32(1, c), bf(k, c, c, sd=c ** -0.5), f32(1, c),
                bf(1, f, s, c) if res else None)
        kw = dict(quant="int8", emit_stats=f == 5)
        outs.append(tr.gn_silu_tconv(*args, **kw))
        row["int8_ms"][f"F={f} S={s} C={c} k={k}"] = cs.time_ms(lambda: tr.gn_silu_tconv(*args, **kw), 10)
        del args
    torch.save(outs, os.path.join(HERE, "build", f"ab_int8_{tag}.pt"))
    del outs
    torch.cuda.empty_cache()
    # one full-width VSR UNet half-forward in bf16, in turbo and in turbo
    # excluding samplers and up_blocks (chip_smoke's ab_turbo_vsr): device ms
    from lavie_tpu_torch.core.config import UNetConfig

    turbo = cs.phase_ab_turbo("ab_turbo_vsr", UNetConfig.vsr(), cs.VSR_FRAMES, batch=1, h=320, w=512,
                              ctx_dim=1024)
    row["ab_turbo_vsr_ms"] = {r["conv_quant"] + ("_excluding" if r["exclude"] else ""): r["device_ms"]
                              for r in turbo["runs"]}
    print(json.dumps(row), flush=True)


def compare(a: str, b: str) -> None:
    load = lambda t: torch.load(os.path.join(HERE, "build", f"ab_int8_{t}.pt"))  # noqa: E731
    parts = lambda o: tuple(o) if isinstance(o, (tuple, list)) else (o,)  # noqa: E731
    equal, sums = [], []
    for x, y in zip(load(a), load(b)):
        x, y = parts(x), parts(y)
        equal.append(bool(torch.equal(x[0], y[0])))
        sums += [((p - q).abs().max() / q.abs().max()).item() for p, q in zip(x[1:], y[1:])]
    print(json.dumps({"compare": [a, b], "int8_y_equal": equal, "int8_sums_diff_of_max": sums}),
          flush=True)
    if not all(equal) or any(d > SUMS_TOL for d in sums):
        sys.exit(1)


def cluster4(root: str, dest: str) -> None:
    shutil.copytree(root, dest, ignore=shutil.ignore_patterns(".git", "build", "chiprun_out"))
    path = os.path.join(dest, "lavie_tpu_torch", "csrc", "flash_attention.cu")
    with open(path) as f:
        text = f.read()
    line = "constexpr int W_CLUSTER = 2;"
    if line not in text:
        sys.exit(f"chip_ab: {line!r} not in {path}")
    with open(path, "w") as f:
        f.write(text.replace(line, "constexpr int W_CLUSTER = 4;"))


def video(root: str, tag: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import hashlib
    import time

    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = TextToVideoPipeline.init_random(seed=0)
    prompt = "a teddy bear walking on the street, 2k, high quality"
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        out = pipe(prompt, num_inference_steps=50, guidance_scale=7.5, sample_method="ddpm", seed=400)
        torch.cuda.synchronize()
        runs.append(time.time() - t0)
    print(json.dumps({"tag": tag, "root": root, "seconds": runs,
                      "video_md5": hashlib.md5(out.video.tobytes()).hexdigest()}), flush=True)


def sparse(root: str, tag: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from lavie_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(6)
    outs, ms = [], {}
    for s, d in TSR_LEVELS:
        q, k, v = (torch.randn(122, s, 8 * d, generator=g, device="cuda").bfloat16() for _ in range(3))
        outs.append(fa.flash_sparse_causal(q, k, v, 61, 8, d ** -0.5))
        ms[f"S={s} d={d}"] = cs.time_ms(lambda: fa.flash_sparse_causal(q, k, v, 61, 8, d ** -0.5))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    torch.save(outs, os.path.join(HERE, "build", f"ab_sparse_{tag}.pt"))
    print(json.dumps({"tag": tag, "root": root, "device": torch.cuda.get_device_name(0),
                      "flash_sparse_causal_ms": ms}), flush=True)


def compare_sparse(a: str, b: str) -> None:
    load = lambda t: torch.load(os.path.join(HERE, "build", f"ab_sparse_{t}.pt"))  # noqa: E731
    equal = [bool(torch.equal(x, y)) for x, y in zip(load(a), load(b))]
    print(json.dumps({"compare": [a, b], "levels": [f"S={s} d={d}" for s, d in TSR_LEVELS],
                      "flash_sparse_causal_equal": equal}), flush=True)
    if not all(equal):
        sys.exit(1)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--cluster4":
        cluster4(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--video":
        video(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--sparse":
        sparse(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--compare-sparse":
        compare_sparse(sys.argv[2], sys.argv[3])
    else:
        run(sys.argv[1], sys.argv[2])
