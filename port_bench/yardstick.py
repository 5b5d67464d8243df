"""The benchmark's frozen yardstick: the H100's published peaks, the bound
arithmetic, the kernel groups a device trace is sorted into, the filter of
what the profiler records that is not device work, and the bound of one
call of each kernel that a cell measures, from the call's shapes. Each
stage's module (stages/<stage>.py) walks its call sites and sums these
bounds over one denoising step (`bounds`).

Copied from the port's smoke script (`bound`, `KERNEL_GROUPS`,
`device_kernels`' filter and the per-row byte and flop counts of its kernel
phases) and frozen here, so that a change to the program cannot move the
yardstick it is measured by.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core bf16
FP32_FLOPS = 67e12  # fp32 outside the tensor cores

KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names), first match wins
    ("temporal_attention", ("temporal_attention_kernel",)),
    ("geglu", ("geglu_pingpong_kernel<", "geglu_coop_kernel<")),
    ("cross_attention (attn2=cross)", ("cross_kernel<", "cross_long_kernel<")),
    ("gn_silu_tconv", ("tconv_", "colsum_kernel", "act_absmax_kernel", "act_scale_kernel",
                       "act_quant_kernel")),
    ("temporal_proj", ("ln_qkv_", "out_proj_gemm_kernel<")),
    ("fused_ln_cross_attention (attn2=fused)", ("fused_ln_kernel<", "fused_gemm_kernel<",
                                                "fused_attn_kernel<")),
    ("cross_attention_head", ("head_ln_kernel<", "head_gemm_kernel<", "head_attn_kernel")),
    ("transformer_tail", ("tail_gemm_", "tail_ln_kernel<")),
    ("flash d=512", ("flash_d512_kernel",)),
    ("flash d<=160 (sparse-causal, explicit kv, VSR L3)", ("flash_kernel<",)),
    ("attention (SDPA)", ("flash", "fmha", "attention", "softmax")),
    ("convolution", ("conv", "implicit", "winograd", "dgrad", "wgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma", "sm90", "cublas", "splitk")),
    ("norm and elementwise", ("",)),
)

# what a profiler records beside device work: "Command Buffer Full" is its
# record of a stalled launch queue (counting it put a busy share above 1),
# "Activity Buffer Request" the tracer's own
NOT_DEVICE_WORK = ("Command Buffer Full", "Activity Buffer Request")

# the port's launch counters (`<wrapper>.launches`, and the statistics and
# int8 variants of gn_silu_tconv), and those of the opt-in entries, which
# no default route launches
COUNTERS = {
    "temporal_attention": ("lavie_tpu_torch.kernels.temporal_fused", "temporal_attention",
                           "launches"),
    "geglu": ("lavie_tpu_torch.kernels.geglu", "geglu", "launches"),
    "flash_sparse_causal": ("lavie_tpu_torch.kernels.flash_attention", "flash_sparse_causal",
                            "launches"),
    "flash_attention_kv": ("lavie_tpu_torch.kernels.flash_attention", "flash_attention_kv",
                           "launches"),
    "flash_attention": ("lavie_tpu_torch.kernels.flash_attention", "flash_attention", "launches"),
    "cross_attention_head": ("lavie_tpu_torch.kernels.cross_block", "cross_attention_head",
                             "launches"),
    "transformer_tail": ("lavie_tpu_torch.kernels.cross_block", "transformer_tail", "launches"),
    "gn_silu_tconv": ("lavie_tpu_torch.kernels.temporal_resblock", "gn_silu_tconv", "launches"),
    "temporal_attention_folded": ("lavie_tpu_torch.kernels.temporal_fused",
                                  "temporal_attention_folded", "launches"),
    "cross_attention": ("lavie_tpu_torch.kernels.cross_attention", "cross_attention",
                        "launches"),
    "fused_ln_cross_attention": ("lavie_tpu_torch.kernels.cross_block",
                                 "fused_ln_cross_attention", "launches"),
    "ln_qkv": ("lavie_tpu_torch.kernels.temporal_proj", "ln_qkv", "launches"),
    "out_proj_residual": ("lavie_tpu_torch.kernels.temporal_proj", "out_proj_residual",
                          "launches"),
    "gn_silu_tconv_stats": ("lavie_tpu_torch.kernels.temporal_resblock", "gn_silu_tconv",
                            "stats_launches"),
    "gn_silu_tconv_int8": ("lavie_tpu_torch.kernels.temporal_resblock", "gn_silu_tconv",
                           "int8_launches"),
}
OPT_IN = ("temporal_attention_folded", "gn_silu_tconv_stats", "gn_silu_tconv_int8",
          "cross_attention", "fused_ln_cross_attention", "ln_qkv", "out_proj_residual")


def bound_s(n_bytes: float, ops) -> float:
    """The least seconds the card could take: bytes over HBM bandwidth, or
    the operations ((flops, peak rate) pairs, whose times add), whichever
    is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, sum(n / rate for n, rate in ops))


def group_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next(g for g, subs in KERNEL_GROUPS if any(s in name for s in subs))


# -- the bound of one call of each kernel ---------------------------------------

def temporal_attention_bound(b: int, f: int, s: int, heads: int, d: int, rope: int) -> float:
    """Row 1: q, k, v read and o written once, the bias and RoPE tables; QKᵀ
    at the bf16 rate and P·V (fp32 probabilities) at the fp32 rate."""
    c = heads * d
    n_bytes = 4 * b * f * s * c * 2 + (heads * f * f * 4 + 2 * f * (rope // 2) * 4 if rope else 0)
    half = 2 * b * s * heads * f * f * d
    return bound_s(n_bytes, ((half, BF16_FLOPS), (half, FP32_FLOPS)))


def geglu_bound(n: int, c: int, inner: int) -> float:
    """Row 3: 6·N·C·I flops against x in, y out and the weights once."""
    n_bytes = n * c * 2 + n * c * 2 + (3 * inner * c + 2 * inner + c) * 2
    return bound_s(n_bytes, ((6 * n * c * inner, BF16_FLOPS),))


def sparse_causal_bound(rows: int, s: int, heads: int, d: int) -> float:
    """Row 6: each of `rows` frames attends to 2S keys (its video's frame 0
    and the frame before it); q, k, v read and o written once."""
    c = heads * d
    return bound_s(4 * rows * s * c * 2, ((4 * rows * heads * s * 2 * s * d, BF16_FLOPS),))
