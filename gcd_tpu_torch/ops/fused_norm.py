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
K5's scratch. `uses_split_path` is the rule. Each wrapper calls its op
(`gcd::group_norm`, `gcd::group_stats`, `gcd::group_norm_from_sums`;
ops/library.py): the plain version on CPU tensors, the kernel or an error
on CUDA ones; under `kernel_flags(fused_gn=False)` /
`kernel_flags(gn_stats=False)` it runs the plain version. The output keeps
x's layout on CUDA (the fake implementation says so); K4's `gn_stats`
switch is its op's `stats` argument, read when the wrapper is called. `group_norm`'s gradient is that of `group_norm_plain`, recomputed
from the saved x, weight and bias (ops/recompute.py; gcd_tpu's fused_norm
`_bwd`); K5 runs inside its forward only.

With a `stats_group` (a process group), x is one rank's share of the
positions of every sample, and the statistics are those of the samples
whole: K5's sums (`group_stats`) are summed over the group in one
all-reduce, then K4's split-path apply normalises with them
(`group_norm_from_sums`), as GSPMD all-reduces the (s1, s2) of
gcd_tpu/ops/fused_norm.py:143-160 for a sharded operand. Without one,
`group_norm` and its plain version are the one-rank code.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

import torch.distributed as dist

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled
from gcd_tpu_torch.ops.library import define
from gcd_tpu_torch.ops.recompute import plain_gradient
from gcd_tpu_torch.parallel.frames import all_reduce_sums

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


@lru_cache(maxsize=None)
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
    plan = cl_stats_plan(n, c, p) if c % 8 == 0 else None
    _cl_check("group_stats: channels-last K5", n if n > TICKETS else 0, c, groups,
              plan.threads if plan else 0, x)
    words = TICKETS + 2 * n * plan.clusters * groups
    return _native.stream_scratch("gn_stats_work", words, torch.int32, zeroed=True).data_ptr()


def cl_one_pass(n: int, c: int, p: int) -> bool:
    """Whether K4 normalises a channels-last (n, p, c) bf16 tensor in one
    pass (csrc/fused_norm.cu, variant (a)): enough samples to fill the card
    with clusters, and a sample's span a block within shared memory."""
    return (n >= ONEPASS_MIN_SAMPLES and c % 8 == 0
            and -(-p // ONEPASS_CLUSTER) * c * 2 <= ONEPASS_BYTES)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, silu: bool, stats_group=None) -> torch.Tensor:
    """GroupNorm over dim 1 with fp32 one-pass statistics, the variance
    clamped at 0 (gcd_tpu/ops/fused_norm.py:_reference_groupnorm), optional
    fused SiLU in fp32, result in x.dtype. With `stats_group`, the
    statistics are `group_stats_plain`'s sums summed over the group."""
    if stats_group is not None:
        s1, s2 = all_reduce_sums(*group_stats_plain(x, num_groups), stats_group)
        count = x[0].numel() // num_groups * dist.get_world_size(stats_group)
        return group_norm_from_sums_plain(x, weight, bias, num_groups, eps, silu, s1, s2, count)
    n, c = x.shape[:2]
    xf = x.float().reshape(n, num_groups, c // num_groups, -1)
    cnt = xf.shape[2] * xf.shape[3]
    mean = xf.sum(dim=(2, 3), keepdim=True) / cnt
    var = (xf * xf).sum(dim=(2, 3), keepdim=True) / cnt - mean * mean
    return _normalise(x, xf, mean, var, weight, bias, num_groups, eps, silu)


def group_norm_from_sums_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               num_groups: int, eps: float, silu: bool, s1: torch.Tensor,
                               s2: torch.Tensor, count: int) -> torch.Tensor:
    """GroupNorm(+SiLU) of x with the statistics of (N, G) fp32 sums (sum x,
    sum x^2) over `count` values a group, which may hold more than x's."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, num_groups, c // num_groups, -1)
    mean = (s1 / count)[..., None, None]
    var = (s2 / count)[..., None, None] - mean * mean
    return _normalise(x, xf, mean, var, weight, bias, num_groups, eps, silu)


def _normalise(x, xf, mean, var, weight, bias, num_groups, eps, silu) -> torch.Tensor:
    """(xf - mean) * (inv * gamma) + beta, the optional SiLU, in fp32, then
    x's shape and dtype; xf is x as (N, G, C / G, -1) fp32."""
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


_CHANNELS_LAST = {4: torch.channels_last, 5: torch.channels_last_3d}


def _channels_last(x: torch.Tensor) -> bool:
    fmt = _CHANNELS_LAST.get(x.dim())
    return fmt is not None and x.is_contiguous(memory_format=fmt) and not x.is_contiguous()


def uses_split_path(x: torch.Tensor, num_groups: int) -> bool:
    """Whether `group_norm` on a CUDA tensor like `x` (any device, meta
    included: the rule reads the shape and layout only) runs K5 before K4."""
    if _channels_last(x):
        return not cl_one_pass(x.shape[0], x.shape[1], math.prod(x.shape[2:]))
    return x.numel() // x.shape[0] // num_groups > FUSED_MAX_VALUES


def _layout(x: torch.Tensor, num_groups: int, who: str) -> Tuple[int, ...]:
    """Check a CUDA operand. Channels-last: (N, C, P) with P the pixel
    count. Otherwise (N, C, F, L, sample stride, frame stride), x read as
    (N, C, F, L) with channel stride L."""
    if not x.is_cuda or x.dtype != torch.bfloat16:
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


def _group_stats_cuda(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K5: `gcd::group_stats` on CUDA tensors, (2, N, G) fp32 sums: one
    launch on a channels-last tensor, two on a channels-first one."""
    lay = _layout(x, num_groups, "group_stats")
    n, c = lay[:2]
    sums = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
    s1 = sums.data_ptr()
    s2 = s1 + 4 * n * num_groups
    if len(lay) == 3:
        work = cl_stats_work(n, c, lay[2], num_groups, x)
        _native.launch("gcd_group_stats_cl", x.data_ptr(), work, s1, s2, *lay, num_groups, None,
                       None, None, 0.0)
    else:  # the block partials first
        parts = torch.empty(2 * n * num_groups * lay[2] * -(-(c // num_groups) * lay[3]
                                                             // STATS_CHUNK),
                            dtype=torch.float32, device=x.device)
        _native.launch("gcd_group_stats", x.data_ptr(), parts.data_ptr(), s1, s2, *lay,
                       num_groups, STATS_CHUNK)
    group_stats.launches += 1
    return sums


_GROUP_STATS = define("group_stats(Tensor x, int groups) -> Tensor", _group_stats_cuda,
                      lambda x, groups: torch.stack(group_stats_plain(x, groups)),
                      lambda x, groups: x.new_empty((2, x.shape[0], groups),
                                                    dtype=torch.float32))


def group_stats(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, group) sum and sum of squares, fp32 (N, G) each; K5
    (`gcd::group_stats`) on CUDA (bf16)."""
    if not kernel_enabled("gn_stats"):
        return group_stats_plain(x, num_groups)
    return _GROUP_STATS(x, num_groups).unbind(0)


def scale_shift(s1: torch.Tensor, s2: torch.Tensor, count: int, weight: torch.Tensor,
                bias: torch.Tensor, eps: float) -> torch.Tensor:
    """(N, C, 2) fp32: per (sample, channel) the GroupNorm's (scale, shift)
    from (N, G) sums over `count` values a group."""
    c = weight.shape[0]
    g = s1.shape[1]
    mean = s1 / count
    inv = torch.rsqrt((s2 / count - mean * mean).clamp_min(0.0) + eps)
    scale = inv.repeat_interleave(c // g, 1) * weight.float()
    shift = bias.float() - mean.repeat_interleave(c // g, 1) * scale
    return torch.stack((scale, shift), dim=-1)


def group_scale_shift_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, eps: float) -> torch.Tensor:
    """(N, C, 2) fp32: per (sample, channel) the GroupNorm's (scale, shift),
    normalised x = x * scale + shift, from `group_stats_plain`'s sums. K5's
    last block per sample writes this table for K7 (csrc/fused_norm.cu)."""
    return scale_shift(*group_stats_plain(x, num_groups), x[0].numel() // num_groups, weight,
                       bias, eps)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, silu: bool, stats_group=None) -> torch.Tensor:
    """GroupNorm(+SiLU) over dim 1; K4 on CUDA (bf16 x, weight and bias).
    The result has x's memory layout. With `stats_group`, the statistics
    are summed over the group's ranks (module docstring)."""
    return plain_gradient(_group_norm_forward, group_norm_plain, (x, weight, bias),
                          num_groups=num_groups, eps=eps, silu=silu, stats_group=stats_group)


def _from_sums_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float, silu: bool, s1: torch.Tensor,
                    s2: torch.Tensor, count: int) -> torch.Tensor:
    """K4's split-path apply: `gcd::group_norm_from_sums` on CUDA tensors."""
    lay = _layout(x, num_groups, "group_norm_from_sums")
    c = lay[1]
    _native.check_cuda_operand("weight", weight, torch.bfloat16, (c,), align=2)
    _native.check_cuda_operand("bias", bias, torch.bfloat16, (c,), align=2)
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr())
    if len(lay) == 3:
        n, c, p = lay
        work = cl_stats_work(n, c, p, num_groups, x)
        table = scale_shift(s1, s2, count, weight, bias, eps)
        _native.launch("gcd_group_norm_cl", *ptrs, work, None, table.data_ptr(), n, c, p,
                       num_groups, float(eps), 0, int(silu))
    else:
        share = (x.numel() // x.shape[0] // num_groups) / count
        s1, s2 = (s1 * share).contiguous(), (s2 * share).contiguous()
        _native.launch("gcd_group_norm", *ptrs, s1.data_ptr(), s2.data_ptr(), *lay, num_groups,
                       float(eps), int(silu), STATS_CHUNK)
    group_norm.launches += 1
    return out


_FROM_SUMS = define("group_norm_from_sums(Tensor x, Tensor weight, Tensor bias, int groups, "
                    "float eps, bool silu, Tensor s1, Tensor s2, int count) -> Tensor",
                    _from_sums_cuda, group_norm_from_sums_plain,
                    lambda x, *args: torch.empty_like(x))


def group_norm_from_sums(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, eps: float, silu: bool, s1: torch.Tensor,
                         s2: torch.Tensor, count: int) -> torch.Tensor:
    """GroupNorm(+SiLU) of x with the statistics of the (N, G) fp32 sums
    s1, s2 over `count` values a group; K4's split-path apply on CUDA
    (`gcd::group_norm_from_sums`): the (scale, shift) table pass on a
    channels-last x, the apply kernel over the sums (rescaled to x's own
    count) on a channels-first one."""
    if not kernel_enabled("fused_gn"):
        return group_norm_from_sums_plain(x, weight, bias, num_groups, eps, silu, s1, s2, count)
    return _FROM_SUMS(x, weight, bias, num_groups, eps, silu, s1, s2, count)


def _group_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, silu: bool, stats: bool) -> torch.Tensor:
    """K4: `gcd::group_norm` on CUDA tensors; `stats` runs K5 where the site
    takes the split path (else the plain statistics)."""
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
            sums = (_group_stats_cuda(x, num_groups) if stats
                    else torch.stack(group_stats_plain(x, num_groups)))
            s1 = sums.data_ptr()
            s2 = s1 + 4 * sums.shape[1] * sums.shape[2]
        _native.launch("gcd_group_norm", *ptrs, s1, s2, *lay, num_groups, float(eps), int(silu),
                       STATS_CHUNK)
    group_norm.launches += 1
    return out


_GROUP_NORM = define("group_norm(Tensor x, Tensor weight, Tensor bias, int groups, float eps, "
                     "bool silu, bool stats) -> Tensor", _group_norm_cuda,
                     lambda x, weight, bias, groups, eps, silu, stats: group_norm_plain(
                         x, weight, bias, groups, eps, silu),
                     lambda x, *args: torch.empty_like(x))


def _group_norm_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        num_groups: int, eps: float, silu: bool, stats_group) -> torch.Tensor:
    if not kernel_enabled("fused_gn"):
        return group_norm_plain(x, weight, bias, num_groups, eps, silu, stats_group)
    if stats_group is not None:  # K5 on the rank's share, the sums summed, K4's apply
        s1, s2 = all_reduce_sums(*group_stats(x, num_groups), stats_group)
        count = x[0].numel() // num_groups * dist.get_world_size(stats_group)
        return group_norm_from_sums(x, weight, bias, num_groups, eps, silu, s1, s2, count)
    return _GROUP_NORM(x, weight, bias, num_groups, eps, silu, kernel_enabled("gn_stats"))


group_stats.launches = 0
group_norm.launches = 0
