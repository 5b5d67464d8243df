"""A/B of the VSR slice's kernels between two checkouts, on one card.

    python3 chip_ab.py ROOT TAG          # once per checkout, in turns
    python3 chip_ab.py --compare TAG1 TAG2

The first form imports chip_smoke.py and lavie_tpu_torch from the checkout
at ROOT, builds that checkout's kernels there and prints one JSON line for
TAG: the SASS op counts of each GEGLU instance (all ops, HGMMA, UTMALDG),
and the ms per call (CUDA events, chip_smoke.time_ms) of GEGLU at the base
L0, TSR L0 and the two VSR shapes, of transformer_tail at VSR L1 and L2, of
gn_silu_tconv at the eight VSR shapes (one CFG half of an 8-frame window)
and of its int8 variant at three VSR shapes. The inputs come from fixed
seeds, so every checkout sees the same ones; the int8 outputs are saved to
build/ab_int8_TAG.pt beside this script. Run parent, change, change, parent
in one call: two versions are compared only on one card. The second form
says whether the int8 outputs of two tags are equal bit for bit.
"""

from __future__ import annotations

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
VSR_LEVELS = [(163840, 256), (40960, 512), (10240, 512), (2560, 1024)]
GEGLU_SHAPES = [(81920, 320), (312320, 320), (81920, 512), (20480, 1024)]
INT8_SHAPES = [(8, 40960, 512, 5, False), (8, 10240, 512, 3, True), (5, 10240, 512, 5, False)]


def run(root: str, tag: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from lavie_tpu_torch.kernels import _build
    from lavie_tpu_torch.kernels import cross_block as cb
    from lavie_tpu_torch.kernels import geglu as gg
    from lavie_tpu_torch.kernels import temporal_resblock as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = {"tag": tag, "root": root, "device": torch.cuda.get_device_name(0)}
    _build.build(["geglu", "temporal_resblock", "cross_block"])
    sass = {}
    for name, ops in _build.sass_op_counts(_build.library_path("geglu")).items():
        if "geglu_" in name and "kernel" in name:
            key = name[name.index("geglu_"):name.index("v14CUtensorMap")]
            sass[key] = {"all": sum(ops.values()),
                         **{p: sum(n for op, n in ops.items() if op.startswith(p)) for p in ("HGMMA", "UTMALDG")}}
    row["geglu_sass"] = sass

    g = torch.Generator(device="cuda").manual_seed(5)
    bf = lambda *shape, sd=1.0: (sd * torch.randn(*shape, generator=g, device="cuda")).bfloat16()  # noqa: E731
    f32 = lambda *shape, sd=0.1, m=0.0: m + sd * torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    row["geglu_ms"] = {}
    for n, c in GEGLU_SHAPES:
        args = (bf(n, c), bf(8 * c, c, sd=c ** -0.5), bf(8 * c, sd=0.1), bf(c, 4 * c, sd=(4 * c) ** -0.5),
                bf(c, sd=0.1))
        row["geglu_ms"][f"N={n} C={c}"] = cs.time_ms(lambda: gg.geglu(*args))
        del args
    row["tail_ms"] = {}
    for s, c in VSR_LEVELS[1:3]:
        n = 8 * s
        targs = (bf(n, c), bf(n, c), f32(c, m=1.0), f32(c), bf(8 * c, c, sd=c ** -0.5), f32(8 * c),
                 bf(c, 4 * c, sd=(4 * c) ** -0.5), f32(c), bf(c, c, sd=c ** -0.5), f32(c))
        row["tail_ms"][f"N={n}"] = cs.time_ms(lambda: cb.transformer_tail(*targs))
        del targs
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
    print(json.dumps(row), flush=True)


def compare(a: str, b: str) -> None:
    load = lambda t: torch.load(os.path.join(HERE, "build", f"ab_int8_{t}.pt"))  # noqa: E731
    flat = lambda outs: [t for o in outs for t in (o if isinstance(o, (tuple, list)) else (o,))]  # noqa: E731
    pairs = list(zip(flat(load(a)), flat(load(b))))
    equal = [bool(torch.equal(x, y)) for x, y in pairs]
    print(json.dumps({"compare": [a, b], "int8_outputs_equal": equal}), flush=True)
    if not all(equal):
        sys.exit(1)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        run(sys.argv[1], sys.argv[2])
