"""K4 / K5: GroupNorm(+SiLU) and its per-group statistics.

Port of gcd_tpu/ops/fused_norm.py: `_kernel` (K4, entry `fused_group_norm`)
and `_stats_kernel` (K5, entry `group_stats_pallas`). The CUDA kernels are
csrc/fused_norm.cu. Semantics are those of `_reference_groupnorm`: one-pass
fp32 statistics with the variance clamped at 0, (x - mean) * (inv * gamma)
+ beta and the optional SiLU in fp32, one rounding to the input dtype.

Inputs are (N, C, *spatial) in one of three memory layouts, and the
output keeps the input's layout:
  - contiguous (channels-first);
  - the (B, C, T, H, W) view of a contiguous (B, T, C, H, W) video, as the
    time_stack blocks make it (`x.reshape(b, t, c, h, w).transpose(1, 2)`);
  - channels-last (torch.channels_last / channels_last_3d), the layout the
    port's convolutions produce from its channels-last inputs; the
    time_stack view of a channels-last tensor is channels_last_3d.
The kernels read each in place.

`group_norm` runs K4 in one pass on a channels-first group of at most
FUSED_MAX_VALUES values, and on a channels-last tensor whose samples each fit
one thread-block cluster (`cl_one_pass`: at least ONEPASS_MIN_SAMPLES
samples, a span of ceil(P / ONEPASS_CLUSTER) pixels within ONEPASS_BYTES;
the UNet's per-frame sites). Everything else takes K5 first and K4's apply
pass after it; on a channels-last tensor that is one C call, K5 writing the
(scale, shift) table that the apply pass reads, both kept per stream with
K5's scratch. `uses_split_path` is the rule. Each wrapper takes its
plain version for CPU tensors, or under `kernel_flags(fused_gn=False)` /
`kernel_flags(gn_stats=False)`; on a CUDA tensor it launches its kernel or
raises. `group_norm`'s gradient is that of `group_norm_plain`, recomputed
from the saved x, weight and bias (ops/recompute.py; gcd_tpu's fused_norm
`_bwd`); K5 runs inside its forward only.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import torch

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled
from gcd_tpu_torch.ops.recompute import plain_gradient

# Largest group normalised in one pass (96 KB of bf16 in one block's shared
# memory); must equal FUSED_MAX in csrc/fused_norm.cu.
FUSED_MAX_VALUES = 49152
# Values per block of K5's partial sums on the channels-first split path.
STATS_CHUNK = 8192
# K4's channels-last one pass (OP_CLUSTER, OP_MIN_N, OP_BYTES and OP_THREADS
# in csrc/fused_norm.cu; a test pins them): blocks a sample (one cluster),
# fewest samples, most bytes of x a block holds, threads a block aims at.
ONEPASS_CLUSTER = 8
ONEPASS_MIN_SAMPLES = 16
ONEPASS_BYTES = 163840
ONEPASS_THREADS = 512
# The channels-last K5 partition (CL_THREADS, CL_MAX_THREADS, CL_UNROLL,
# CL_BLOCKS, CL_CLUSTER, CL_CLUSTER_FROM and TICKETS in csrc/fused_norm.cu; a
# test pins them): threads a block aims at, most threads of a block, loads in
# flight per thread, the most blocks a call aims at, blocks a cluster, blocks
# a sample from which they form clusters, most samples.
STATS_THREADS = 256
STATS_MAX_THREADS = 512
STATS_UNROLL = 8
STATS_BLOCKS = 512
STATS_CLUSTER = 8
STATS_CLUSTER_FROM = 64
TICKETS = 4096


class ClStatsPlan(NamedTuple):
    """How channels-last K5 cuts n (P, C) samples: `vpr` threads of 8
    channels per pixel lane, `lanes` pixel lanes; a chunk of `rows` = lanes *
    STATS_UNROLL pixels; `per` chunks a block; `clusters` clusters of
    `cluster` blocks, `blocks` = clusters * cluster blocks per sample."""
    vpr: int
    lanes: int
    threads: int
    rows: int
    per: int
    cluster: int
    clusters: int
    blocks: int


def cl_stats_plan(n: int, c: int, p: int) -> ClStatsPlan:
    """csrc/fused_norm.cu's cl_plan."""
    vpr = c // 8
    lanes = STATS_THREADS // vpr if vpr < STATS_THREADS else 1
    rows = lanes * STATS_UNROLL
    chunks = -(-p // rows)
    per = -(-chunks // max(STATS_BLOCKS // n, 1))
    used = -(-chunks // per)
    cluster = STATS_CLUSTER if used >= STATS_CLUSTER_FROM else 1
    clusters = -(-used // cluster)
    return ClStatsPlan(vpr, lanes, vpr * lanes, rows, per, cluster, clusters, clusters * cluster)


def _cl_check(who: str, too_many: int, c: int, groups: int, threads: int,
              x: torch.Tensor) -> None:
    """Raise unless the channels-last kernels take C channels in `groups`
    groups with blocks of `threads` threads, and a 16-byte aligned x;
    `too_many` is a sample count past the kernel's most, or 0."""
    cpg = c // groups if c % groups == 0 else 0
    if (too_many or c % 8 or c > 8 * STATS_MAX_THREADS or cpg < 4 or cpg % 2
            or groups > threads // 32 * 32 or x.data_ptr() % 16):
        raise ValueError(f"{who} takes C a multiple of 8 up to {8 * STATS_MAX_THREADS}, an "
                         f"even C / groups of at least 4, at most {TICKETS} samples and a "
                         f"16-byte aligned tensor, got N={x.shape[0]}, C={c}, G={groups}")


def cl_stats_work(n: int, c: int, p: int, groups: int, x: torch.Tensor) -> int:
    """Device pointer to channels-last K5's scratch for an (n, p, c) tensor:
    TICKETS zero tickets (each call leaves them zero) then the cluster
    partials, kept per stream. Raises on a shape or tensor the kernel does
    not take."""
    _cl_check("group_stats: channels-last K5", n if n > TICKETS else 0, c, groups,
              cl_stats_plan(n, c, p).threads if c % 8 == 0 else 0, x)
    words = TICKETS + 2 * n * cl_stats_plan(n, c, p).clusters * groups
    return _native.stream_scratch("gn_stats_work", words, torch.int32, zeroed=True).data_ptr()


def cl_one_pass(n: int, c: int, p: int) -> bool:
    """Whether K4 normalises a channels-last (n, p, c) bf16 tensor in one
    pass (csrc/fused_norm.cu, variant (a)): enough samples to fill the card
    with clusters, and a sample's span a block within shared memory."""
    return (n >= ONEPASS_MIN_SAMPLES and c % 8 == 0
            and -(-p // ONEPASS_CLUSTER) * c * 2 <= ONEPASS_BYTES)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm over dim 1 with fp32 one-pass statistics, the variance
    clamped at 0 (gcd_tpu/ops/fused_norm.py:_reference_groupnorm), optional
    fused SiLU in fp32, result in x.dtype."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, num_groups, c // num_groups, -1)
    cnt = xf.shape[2] * xf.shape[3]
    mean = xf.sum(dim=(2, 3), keepdim=True) / cnt
    var = (xf * xf).sum(dim=(2, 3), keepdim=True) / cnt - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    w = weight.float().reshape(1, num_groups, -1, 1)
    b = bias.float().reshape(1, num_groups, -1, 1)
    y = (xf - mean) * (inv * w) + b
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def group_stats_plain(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, *spatial) -> (sum x, sum x^2), each (N, G) fp32."""
    xf = x.float().reshape(x.shape[0], num_groups, -1)
    return xf.sum(dim=-1), (xf * xf).sum(dim=-1)


def _channels_last(x: torch.Tensor) -> bool:
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    return fmt is not None and not x.is_contiguous() and x.is_contiguous(memory_format=fmt)


def uses_split_path(x: torch.Tensor, num_groups: int) -> bool:
    """Whether `group_norm` on a CUDA tensor like `x` (any device, meta
    included: the rule reads the shape and layout only) runs K5 before K4."""
    if _channels_last(x):
        return not cl_one_pass(x.shape[0], x.shape[1], math.prod(x.shape[2:]))
    return x[0].numel() // num_groups > FUSED_MAX_VALUES


def _layout(x: torch.Tensor, num_groups: int, who: str) -> Tuple[int, ...]:
    """Check a CUDA operand. Channels-last: (N, C, P) with P the pixel
    count. Otherwise (N, C, F, L, sample stride, frame stride), x read as
    (N, C, F, L) with channel stride L."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"{who}: expected a bf16 CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() < 3 or x.shape[1] % num_groups:
        raise ValueError(f"{who}: expected (N, C, ...) with C divisible by "
                         f"{num_groups}, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    if _channels_last(x):
        if (c // num_groups) % 2 or x.data_ptr() % 4:
            raise ValueError(f"{who}: channels-last kernel takes an even C / groups and "
                             f"a 4-byte aligned tensor, got {tuple(x.shape)}")
        return n, c, math.prod(x.shape[2:])
    if x.is_contiguous():
        f, l = 1, math.prod(x.shape[2:])
        s_n, s_f = c * l, c * l
    elif x.dim() == 5 and x.stride() == (
            x.shape[2] * c * x.shape[3] * x.shape[4], x.shape[3] * x.shape[4],
            c * x.shape[3] * x.shape[4], x.shape[4], 1):
        f, l = x.shape[2], x.shape[3] * x.shape[4]
        s_n, s_f = f * c * l, c * l
    else:
        raise ValueError(f"{who}: kernel takes a contiguous or channels-last tensor, or "
                         f"the (B, C, T, H, W) view of a contiguous (B, T, C, H, W) one; "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if l % 8 or x.data_ptr() % 16:
        raise ValueError(f"{who}: channels-first kernel takes H*W a multiple of 8 and a "
                         f"16-byte aligned tensor, got shape {tuple(x.shape)}")
    return n, c, f, l, s_n, s_f


def group_stats(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, group) sum and sum of squares, fp32 (N, G) each; K5 on
    CUDA (bf16): one launch on a channels-last tensor, two on a
    channels-first one."""
    if x.device.type == "cpu" or not kernel_enabled("gn_stats"):
        return group_stats_plain(x, num_groups)
    lay = _layout(x, num_groups, "group_stats")
    n, c = lay[:2]
    # One allocation: the sums, then (channels-first) the block partials.
    parts = 0 if len(lay) == 3 else lay[2] * -(-(c // num_groups) * lay[3] // STATS_CHUNK)
    buf = torch.empty(2 * n * num_groups * (1 + parts), dtype=torch.float32, device=x.device)
    sums = buf[:2 * n * num_groups].view(2, n, num_groups)
    s1, s2 = sums[0], sums[1]
    if len(lay) == 3:
        work = cl_stats_work(n, c, lay[2], num_groups, x)
        _native.launch("gcd_group_stats_cl", x.data_ptr(), work, s1.data_ptr(), s2.data_ptr(),
                       *lay, num_groups, None, None, None, 0.0)
    else:
        _native.launch("gcd_group_stats", x.data_ptr(), buf[2 * n * num_groups:].data_ptr(),
                       s1.data_ptr(), s2.data_ptr(), *lay, num_groups, STATS_CHUNK)
    group_stats.launches += 1
    return s1, s2


def group_scale_shift_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, eps: float) -> torch.Tensor:
    """(N, C, 2) fp32: per (sample, channel) the GroupNorm's (scale, shift),
    normalised x = x * scale + shift, from `group_stats_plain`'s sums. K5's
    last block per sample writes this table for K7 (csrc/fused_norm.cu)."""
    n, c = x.shape[:2]
    s1, s2 = group_stats_plain(x, num_groups)
    count = x[0].numel() // num_groups
    mean = s1 / count
    inv = torch.rsqrt((s2 / count - mean * mean).clamp_min(0.0) + eps)
    scale = inv.repeat_interleave(c // num_groups, 1) * weight.float()
    shift = bias.float() - mean.repeat_interleave(c // num_groups, 1) * scale
    return torch.stack((scale, shift), dim=-1)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) over dim 1; K4 on CUDA (bf16 x, weight and bias).
    The result has x's memory layout."""
    args = dict(num_groups=num_groups, eps=eps, silu=silu)
    return plain_gradient(partial(_group_norm_forward, **args),
                          partial(group_norm_plain, **args), x, weight, bias)


def _group_norm_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    if x.device.type == "cpu" or not kernel_enabled("fused_gn"):
        return group_norm_plain(x, weight, bias, num_groups, eps, silu)
    lay = _layout(x, num_groups, "group_norm")
    c = lay[1]
    _native.check_cuda_operand("weight", weight, torch.bfloat16, (c,), align=2)
    _native.check_cuda_operand("bias", bias, torch.bfloat16, (c,), align=2)
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr())
    if len(lay) == 3:
        n, c, p = lay
        if cl_one_pass(n, c, p):
            vpr = c // 8
            _cl_check("group_norm: channels-last K4", 0, c, num_groups,
                      vpr * max(ONEPASS_THREADS // vpr, 1), x)
            _native.launch("gcd_group_norm_cl_onepass", *ptrs, n, c, p, num_groups,
                           float(eps), int(silu))
        else:
            # K5 writes the (N, C) (scale, shift) table, then the apply pass
            # reads it; the table and K5's sums are kept per stream.
            work = cl_stats_work(n, c, p, num_groups, x)
            stats = kernel_enabled("gn_stats")
            if stats:
                buf = _native.stream_scratch("gn_table", 2 * n * (c + num_groups),
                                             torch.float32)
                table, sums = buf.data_ptr(), buf.data_ptr() + 8 * n * c
            else:
                plain = group_scale_shift_plain(x, weight, bias, num_groups, eps)
                table, sums = plain.data_ptr(), None
            _native.launch("gcd_group_norm_cl", *ptrs, work, sums, table, n, c, p,
                           num_groups, float(eps), int(stats), int(silu))
            group_stats.launches += int(stats)
    else:
        s1 = s2 = None
        if uses_split_path(x, num_groups):
            s1, s2 = group_stats(x, num_groups)
        _native.launch("gcd_group_norm", *ptrs, None if s1 is None else s1.data_ptr(),
                       None if s2 is None else s2.data_ptr(), *lay, num_groups,
                       float(eps), int(silu), STATS_CHUNK)
    group_norm.launches += 1
    return out


group_stats.launches = 0
group_norm.launches = 0
