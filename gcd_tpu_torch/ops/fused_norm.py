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
FUSED_MAX_VALUES values; larger groups and every channels-last tensor take
K5 (`group_stats`) first and K4's apply pass after it. Each wrapper takes its
plain version for CPU tensors, or under `kernel_flags(fused_gn=False)` /
`kernel_flags(gn_stats=False)`; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled

# Largest group normalised in one pass (96 KB of bf16 in one block's shared
# memory); must equal FUSED_MAX in csrc/fused_norm.cu.
FUSED_MAX_VALUES = 49152
# Values per block on the channels-first split path, and pixels per block on
# the channels-last one (the partitions of K5's partial sums).
STATS_CHUNK = 8192
CL_PIXEL_TILE = 128


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
    """Whether `group_norm` on a CUDA tensor like `x` runs K5 before K4."""
    return _channels_last(x) or x[0].numel() // num_groups > FUSED_MAX_VALUES


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
    CUDA (bf16)."""
    if x.device.type == "cpu" or not kernel_enabled("gn_stats"):
        return group_stats_plain(x, num_groups)
    lay = _layout(x, num_groups, "group_stats")
    n, c = lay[:2]
    s1 = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    if len(lay) == 3:
        tiles = -(-lay[2] // CL_PIXEL_TILE)
        part = torch.empty((n * tiles * (c // 2), 2), dtype=torch.float32, device=x.device)
        _native.launch("gcd_group_stats_cl", x.data_ptr(), part.data_ptr(), s1.data_ptr(),
                       s2.data_ptr(), *lay, num_groups, CL_PIXEL_TILE)
    else:
        f, l = lay[2:4]
        chunks = -(-(c // num_groups) * l // STATS_CHUNK)
        part = torch.empty((n * num_groups * f * chunks, 2), dtype=torch.float32,
                           device=x.device)
        _native.launch("gcd_group_stats", x.data_ptr(), part.data_ptr(), s1.data_ptr(),
                       s2.data_ptr(), *lay, num_groups, STATS_CHUNK)
    group_stats.launches += 1
    return s1, s2


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm(+SiLU) over dim 1; K4 on CUDA (bf16 x, weight and bias).
    The result has x's memory layout."""
    if x.device.type == "cpu" or not kernel_enabled("fused_gn"):
        return group_norm_plain(x, weight, bias, num_groups, eps, silu)
    lay = _layout(x, num_groups, "group_norm")
    c = lay[1]
    _native.check_cuda_operand("weight", weight, torch.bfloat16, (c,), align=2)
    _native.check_cuda_operand("bias", bias, torch.bfloat16, (c,), align=2)
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr())
    if len(lay) == 3:
        s1, s2 = group_stats(x, num_groups)
        _native.launch("gcd_group_norm_cl", *ptrs, s1.data_ptr(), s2.data_ptr(), *lay,
                       num_groups, float(eps), int(silu), CL_PIXEL_TILE)
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
