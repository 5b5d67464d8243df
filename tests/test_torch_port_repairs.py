"""The two repairs of the port's arithmetic towards the TPU bodies, on the CPU.

1. The d <= 160 flash body stores bf16(o / l), a true division, as every
   TPU flash body does (lavie_tpu/kernels/flash_attention.py, `acc / l`),
   where it stored bf16(o * (1 / l)). `division_cases` searches, from a
   seed, for bf16 values v whose sum over L = 7 keys is exact in fp32 and
   for which the two orders round to different bf16 values: with L equal
   keys every probability is 1, so the kernel's output is bf16(Σv / L). The
   card test (tests/test_torch_port_cuda.py) feeds these v to the kernel;
   the tests here show that the cases exist, so that test is not vacuous.
2. The int8 GN·SiLU·temporal conv applies SiLU as the TPU body's _silu,
   a · (1 / (1 + e^-a)), where it divided; its plain version
   (kernels/temporal_resblock.py::silu) takes the same order.

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from lavie_tpu_torch.kernels import temporal_resblock as tr

KEYS = 7


def bf16_rne(x) -> np.ndarray:
    """fp32 values rounded to bf16 (round to nearest, ties to even), as fp32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


def division_cases(seed: int, n: int = 1 << 16, keys: int = KEYS):
    """(v (m, keys), bf16(Σv / keys), bf16(Σv · RN(1 / keys))) over the m of
    n random sets of bf16 values (signs random, magnitudes 2^-1..2^6) whose
    sum is exact in fp32 in any order and whose two normalised values
    differ after rounding to bf16."""
    rng = np.random.RandomState(seed)
    v = bf16_rne(rng.choice([-1.0, 1.0], (n, keys)) * np.exp2(rng.uniform(-1, 6, (n, keys))))
    s32 = v.sum(axis=1, dtype=np.float32)
    exact = s32.astype(np.float64) == v.astype(np.float64).sum(axis=1)
    div = bf16_rne(s32 / np.float32(keys))
    mul = bf16_rne(s32 * (np.float32(1) / np.float32(keys)))
    hit = exact & (div != mul)
    return v[hit], div[hit], mul[hit]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_division_cases_exist_and_differ(seed):
    v, div, mul = division_cases(seed)
    assert len(v) >= 64  # enough for one head's columns at d = 40 and more
    assert (div != mul).all()
    # every partial sum is exact too: 8-bit mantissas over 7 binades and 7 terms
    assert (np.abs(v) >= 0.5).all() and (np.abs(v) < 128).all()
    s = v.astype(np.float64).sum(axis=1)
    assert (s.astype(np.float32).astype(np.float64) == s).all()
    # the quotient the kernel stores: div.rn.f32 of the exact sum, then bf16
    assert np.array_equal(div, bf16_rne(s.astype(np.float32) / np.float32(KEYS)))


def test_division_cases_are_reproducible():
    a, b = division_cases(5), division_cases(5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", [(4096,), (3, 5, 64), (2, 8, 33, 128)])
def test_plain_silu_is_the_tpu_order_bit_for_bit(shape):
    """silu(a) == a · (1 / (1 + e^-a)) in fp32, bit for bit; the division
    F.silu does gives other bits for some a, so the order matters."""
    g = torch.Generator().manual_seed(len(shape))
    a = 4.0 * torch.randn(shape, generator=g)
    want = a * (1.0 / (1.0 + torch.exp(-a)))
    assert torch.equal(tr.silu(a), want)
    if a.numel() >= 4096:
        assert not torch.equal(want, a / (1.0 + torch.exp(-a)))


@pytest.mark.parametrize("f,s,c", [(1, 7, 32), (3, 64, 64), (5, 100, 128)])
def test_plain_conv_activates_with_the_tpu_silu(f, s, c):
    """One tap that is the identity and a zero bias: the plain version's y
    is its bf16 activation, bf16(silu(bf16(bf16(x · w) + u))), bit for bit."""
    g = torch.Generator().manual_seed(f * s)
    x = torch.randn(1, f, s, c, generator=g).bfloat16()
    w = 1.0 + 0.5 * torch.randn(1, c, generator=g)
    u = 0.5 * torch.randn(1, c, generator=g)
    taps = torch.eye(c).bfloat16()[None]
    y = tr.gn_silu_tconv_reference(x, w, u, taps, torch.zeros(1, c))
    a = (x * w.bfloat16()[:, None, None] + u.bfloat16()[:, None, None]).float()
    assert torch.equal(y, (a * (1.0 / (1.0 + torch.exp(-a)))).bfloat16())


def test_the_two_silu_orders_agree_once_rounded_to_bf16():
    """Over every finite bf16 input t, t / (1 + e^-t) and t · (1 / (1 +
    e^-t)) differ in fp32 for about 2% of t but not once rounded to bf16:
    the activation the int8 conv quantises is bf16, so its outputs kept
    their bits through the SiLU repair (as chip_ab.py found on the card)."""
    t = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).float()
    t = t[torch.isfinite(t)]
    d = 1.0 + torch.exp(-t)
    div, mul = t / d, tr.silu(t)
    assert (div != mul).sum() > 1000
    assert torch.equal(div.bfloat16(), mul.bfloat16())
