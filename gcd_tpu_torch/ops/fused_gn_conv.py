"""K7: GroupNorm -> SiLU -> 3x3 same-pad convolution in one kernel.

Port of gcd_tpu/ops/fused_gn_conv.py: `_kernel` (pallas_call in
`_fused_forward`, entry `gn_silu_conv3x3`). The CUDA kernel is
csrc/fused_gn_conv.cu. Semantics are those of `_xla_chain`: GroupNorm with
fp32 statistics and the variance clamped at 0, the optional SiLU, one
rounding to x.dtype; then the 3x3 conv with padding 1 and fp32
accumulation, the fp32 bias, one rounding to x.dtype.

What bounds it on the H100: operations (at the UNet's ResBlock shapes the
products are 5-7x the time of the bytes at the card's peaks), so the kernel
is an implicit GEMM on wgmma. K5 (channels-last; launched by K7's C entry
point, and counted under `gn_stats`) computes the statistics first, as K4's
split path does, and in the same launch the per-(sample, channel) scale and
shift (under `kernel_flags(gn_stats=False)`, `group_scale_shift_plain`
does); each block normalises the halo
tile of its output pixels once per 64-channel chunk, zeroes the positions
off the plane after the normalisation, and never writes the normalised
activation to device memory -- the pass of K4 plus the cuDNN read it
replaces. `tile_plan` picks each block's output tile and how many blocks
share a tile's channel chunks (split-K, summed in a fixed order).

Tensors are torch's: x (N, C, H, W), conv weight (F, C, 3, 3). On CUDA the
kernel takes x in channels_last memory (the layout of the port's
activations) and the weight in channels_last memory, (F, 3, 3, C) in
memory, in which the 2D ResBlocks build the routed convs
(models/resblock.py); it raises on anything else, and its output
is channels_last. The wrapper calls the op `gcd::gn_silu_conv3x3`
(ops/library.py), whose CPU implementation is `gn_silu_conv3x3_plain`;
under `kernel_flags(fused_gn_conv=False)` it runs the plain version. The
`gn_stats` switch is the op's `stats` argument, read at the call.

The gradient is that of the plain chain (gcd_tpu's `_bwd`): the backward
recomputes GroupNorm + SiLU from the saved x and takes the conv's input and
weight gradients directly from the incoming gradient -- the conv forward is
not run again (ops/recompute.py).
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled
from gcd_tpu_torch.ops.fused_norm import (
    cl_stats_work,
    group_norm_plain,
    group_scale_shift_plain,
    group_stats,
)
from gcd_tpu_torch.ops.library import define
from gcd_tpu_torch.ops.recompute import plain_gradient


def gn_silu_conv3x3_plain(x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor,
                          conv_weight: torch.Tensor, conv_bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5, silu: bool = True
                          ) -> torch.Tensor:
    """GroupNorm(groups, eps) (+ SiLU) -> 3x3 conv, padding 1, fp32
    accumulation and bias, one rounding to x.dtype."""
    y = group_norm_plain(x, gn_weight, gn_bias, groups, eps, silu)
    out = F.conv2d(y.float(), conv_weight.to(y.dtype).float(), padding=1)
    return (out + conv_bias.float()[:, None, None]).to(x.dtype)


def supported(x: torch.Tensor, conv_weight: torch.Tensor, groups: int) -> bool:
    """The shapes K7 takes (gcd_tpu's `supported`, less its VMEM budget):
    a 4D input, a 3x3 weight, C divisible by the groups and by 64, F by 64."""
    if x.dim() != 4 or conv_weight.dim() != 4 or tuple(conv_weight.shape[2:]) != (3, 3):
        return False
    c, f = x.shape[1], conv_weight.shape[0]
    return conv_weight.shape[1] == c and c % groups == 0 and c % 64 == 0 and f % 64 == 0


# The kernel's fixed tiling, mirrors of csrc/fused_gn_conv.cu's BM, BN, CK,
# HALO_MAX and NS_MAX: output pixels and filters per block, channels per
# chunk, halo pixels and samples per block.
BLOCK_PIXELS, BLOCK_FILTERS, CHUNK, HALO_MAX, SAMPLES_MAX = 192, 160, 64, 384, 8


class TilePlan(NamedTuple):
    """Each block's output tile is `samples` x `rows` x `cols` pixels (whole
    planes when a plane has at most BLOCK_PIXELS), times BLOCK_FILTERS
    filters; the C / CHUNK channel chunks are split over `splits` blocks
    per tile, split s taking chunks [s * chunks // splits, (s + 1) *
    chunks // splits)."""
    rows: int
    cols: int
    samples: int
    splits: int


@lru_cache(maxsize=None)
def tile_plan(n: int, h: int, w: int, c: int, f: int, sms: int) -> TilePlan:
    """The tile and split-K plan K7 runs (n, h, w, c, f) with on `sms` SMs.

    One block fits an SM, so blocks run in waves of `sms`. The split count
    minimises waves x (chunks per block + 1, for the block's fill and
    epilogue), plus half a chunk per extra split for the fp32 partial sums
    and their second pass."""
    rows = cols = samples = 0
    if h * w <= BLOCK_PIXELS:
        rows, cols = h, w
        samples = min(BLOCK_PIXELS // (h * w), SAMPLES_MAX, n)
        while samples and samples * (h + 2) * (w + 2) > HALO_MAX:
            samples -= 1
    if not samples:
        samples = 1
        shapes = [(r, BLOCK_PIXELS // r) for r in range(1, BLOCK_PIXELS + 1)
                  if BLOCK_PIXELS % r == 0]
        rows, cols = min(
            ((r, q) for r, q in shapes if (r + 2) * (q + 2) <= HALO_MAX),
            key=lambda rq: (-(-h // rq[0]) * rq[0] * -(-w // rq[1]) * rq[1],
                            (rq[0] + 2) * (rq[1] + 2)))
    tiles = -(-n // samples) * -(-h // rows) * -(-w // cols)
    blocks = tiles * -(-f // BLOCK_FILTERS)
    chunks = c // CHUNK

    def cost(s):
        return -(-blocks * s // sms) * (-(-chunks // s) + 1) + 0.5 * (s - 1)

    splits = min(range(1, min(chunks, 16) + 1), key=cost)
    return TilePlan(rows, cols, samples, splits)


class _ConvGradient(torch.autograd.Function):
    """conv2d(y, w, padding=1) + b for the backward only: its forward makes
    no product (the output is a zero-stride placeholder of the right shape),
    its backward is the plain chain's conv gradient, in y's dtype with the
    rounding points of the fp32-accumulating conv."""

    @staticmethod
    def forward(ctx, y, weight, bias):
        ctx.save_for_backward(y, weight)
        ctx.bias_dtype = bias.dtype
        n, _, h, w = y.shape
        return y.new_zeros(()).expand(n, weight.shape[0], h, w)

    @staticmethod
    def backward(ctx, grad):
        y, weight = ctx.saved_tensors
        need_y, need_w, need_b = ctx.needs_input_grad
        g = grad.to(y.dtype)
        gy, gw, _ = torch.ops.aten.convolution_backward(
            g, y, weight.to(y.dtype), None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [need_y, need_w, False])
        gb = grad.float().sum(dim=(0, 2, 3)).to(ctx.bias_dtype) if need_b else None
        return gy, None if gw is None else gw.to(weight.dtype), gb


def _gradient_chain(x, gn_weight, gn_bias, conv_weight, conv_bias, groups, eps, silu):
    """The plain chain as the backward differentiates it: GroupNorm + SiLU
    recomputed, the conv through _ConvGradient."""
    y = group_norm_plain(x, gn_weight, gn_bias, groups, eps, silu)
    return _ConvGradient.apply(y, conv_weight, conv_bias)


def gn_silu_conv3x3(x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor,
                    conv_weight: torch.Tensor, conv_bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """GroupNorm(groups, eps) (+ SiLU) -> 3x3 same-pad conv; K7 on CUDA."""
    return plain_gradient(_forward, _gradient_chain, (x, gn_weight, gn_bias, conv_weight,
                                                      conv_bias), groups=groups, eps=eps, silu=silu)


def _cuda(x, gn_weight, gn_bias, conv_weight, conv_bias, groups: int, eps: float, silu: bool,
          stats: bool) -> torch.Tensor:
    """K7: `gcd::gn_silu_conv3x3` on CUDA tensors; `stats` runs K5 for the
    statistics (else the plain scale / shift table)."""
    if not supported(x, conv_weight, groups):
        raise ValueError(f"gn_silu_conv3x3: K7 takes (N, C, H, W) with C % {groups}, "
                         f"C % 64 and F % 64 == 0 and a (F, C, 3, 3) weight; got "
                         f"{tuple(x.shape)} and {tuple(conv_weight.shape)}")
    n, c, h, w = x.shape
    f = conv_weight.shape[0]
    fmt = torch.channels_last
    for name, t in (("x", x), ("conv_weight", conv_weight)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"gn_silu_conv3x3: {name} must be a bf16 CUDA tensor, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous(memory_format=fmt) or t.data_ptr() % 16:
            raise ValueError(f"gn_silu_conv3x3: {name} must be channels_last and 16-byte "
                             f"aligned, got strides {t.stride()}")
    _native.check_cuda_operand("gn_weight", gn_weight, torch.bfloat16, (c,), align=2)
    _native.check_cuda_operand("gn_bias", gn_bias, torch.bfloat16, (c,), align=2)
    _native.check_cuda_operand("conv_bias", conv_bias, torch.bfloat16, (f,), align=2)
    plan = tile_plan(n, h, w, c, f, _native.sm_count(x.get_device()))
    # One fp32 scratch: K5's group sums (s1, s2) and the scale / shift table,
    # K7's split-K partial sums; each part a multiple of 16 bytes. K5's
    # tickets and block partials are its per-stream scratch.
    work = cl_stats_work(n, c, h * w, groups, x) if stats else None
    sizes = [n * groups, n * groups, 2 * n * c,
             plan.splits * n * h * w * f if plan.splits > 1 else 0]
    sizes = [-(-size // 4) * 4 for size in sizes]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    s1, s2, table, partial_sums = (
        scratch.data_ptr() + 4 * offset for offset in itertools.accumulate([0] + sizes[:-1]))
    if not stats:
        plain_table = group_scale_shift_plain(x, gn_weight, gn_bias, groups, eps)
        scratch.narrow(0, sum(sizes[:2]), 2 * n * c).copy_(plain_table.flatten())
    out = torch.empty((n, f, h, w), dtype=x.dtype, device=x.device, memory_format=fmt)
    _native.launch("gcd_gn_silu_conv3x3", x.data_ptr(), conv_weight.data_ptr(),
                   gn_weight.data_ptr(), gn_bias.data_ptr(), conv_bias.data_ptr(), work, s1, s2,
                   table, partial_sums, out.data_ptr(), n, h, w, c, f, groups,
                   float(eps), int(stats), int(silu), *plan)
    if stats:
        group_stats.launches += 1
    gn_silu_conv3x3.launches += 1
    return out


_GN_CONV = define("gn_silu_conv3x3(Tensor x, Tensor gn_weight, Tensor gn_bias, "
                  "Tensor conv_weight, Tensor conv_bias, int groups, float eps, bool silu, "
                  "bool stats) -> Tensor", _cuda,
                  lambda x, gw, gb, cw, cb, groups, eps, silu, stats: gn_silu_conv3x3_plain(
                      x, gw, gb, cw, cb, groups, eps, silu),
                  lambda x, gw, gb, cw, *args: torch.empty(
                      (x.shape[0], cw.shape[0], *x.shape[2:]), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last))


def _forward(x, gn_weight, gn_bias, conv_weight, conv_bias, groups, eps, silu):
    if not kernel_enabled("fused_gn_conv"):
        return gn_silu_conv3x3_plain(x, gn_weight, gn_bias, conv_weight, conv_bias,
                                     groups, eps, silu)
    return _GN_CONV(x, gn_weight, gn_bias, conv_weight, conv_bias, groups, eps, silu,
                    kernel_enabled("gn_stats"))


gn_silu_conv3x3.launches = 0
