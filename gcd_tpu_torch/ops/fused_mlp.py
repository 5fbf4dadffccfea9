"""K3: fused GEGLU feed-forward.

Port of gcd_tpu/ops/fused_mlp.py (`_kernel`, entry `geglu_mlp`), with exact
erf GELU. Weights are in torch Linear layout: w1 (2I, C) with the value rows
first and the gate rows second, b1 (2I,), w2 (C_out, I), b2 (C_out,).

`geglu_mlp_plain` follows the TPU kernel's rounding points: the up products
are rounded to the input dtype, the bias is added in that dtype, the gated
product is computed in fp32 and rounded before the down product, whose bias
is added in fp32 before the one rounding. The CUDA kernels
(csrc/fused_mlp.cu) run both products on wgmma: the up kernel keeps the
(M, 2I) up-projection on chip and writes h = bf16(a * gelu(g)) once to an
(M, I) buffer kept per stream (`_native.stream_scratch`), which the down
kernel reads with b2 in its epilogue. No atomics: two calls agree bit for
bit.

`geglu_mlp` calls the op `gcd::geglu_mlp` (ops/library.py): the plain
version on CPU tensors, the kernels or an error on CUDA ones; under
`kernel_flags(fused_mlp=False)` it runs the plain version. Its gradient is that of the plain version (the same erf
GELU), recomputed from the saved inputs (ops/recompute.py; gcd_tpu's
fused_mlp `_bwd`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled
from gcd_tpu_torch.ops.library import define
from gcd_tpu_torch.ops.recompute import plain_gradient


def geglu_mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (..., C) -> (..., C_out) in x.dtype."""
    inner = w2.shape[1]
    up = F.linear(x, w1.to(x.dtype))
    b1 = b1.to(x.dtype)
    a = up[..., :inner] + b1[:inner]
    g = up[..., inner:] + b1[inner:]
    h = (a.float() * F.gelu(g.float())).to(x.dtype)
    return F.linear(h, w2.to(x.dtype), b2.to(x.dtype))


# Tiling of csrc/fused_mlp.cu (BN_UP, BM_DOWN and DOWN_TILES there; a test
# pins them): inner columns (each with its gate column) per up tile, rows
# per down tile and the down tile's widths, preferred first.
INNER_TILE = 64
DOWN_ROWS = 128
DOWN_TILES = (256, 160, 128)


def down_tile(m: int, c_out: int, sms: int) -> int:
    """The down kernel's column tile, which the wrapper passes to
    csrc/fused_mlp.cu: the one of DOWN_TILES whose busiest SM (one block an
    SM, tiles dealt round-robin) has the fewest output columns to compute,
    the wider on a tie."""
    rows = -(-m // DOWN_ROWS)
    cost = {bn: -(-rows * -(-c_out // bn) // sms) * bn for bn in DOWN_TILES}
    return min(DOWN_TILES, key=lambda bn: cost[bn])


def check_shape(m: int, c: int, inner: int, c_out: int) -> None:
    """Raise on a shape the kernels do not take: C and C_out multiples of 8,
    I of INNER_TILE."""
    if c % 8 or inner % INNER_TILE or c_out % 8 or m <= 0:
        raise ValueError(f"geglu_mlp: kernel takes C and C_out multiples of 8 and I of "
                         f"{INNER_TILE}, got M={m}, C={c}, I={inner}, C_out={c_out}")


def geglu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEGLU MLP; K3 on CUDA (bf16; C and C_out multiples of 8, I of 64)."""
    return plain_gradient(_geglu_forward, geglu_mlp_plain, (x, w1, b1, w2, b2))


def _geglu_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K3: `gcd::geglu_mlp` on CUDA tensors."""
    c = x.shape[-1]
    c_out, inner = w2.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, c)
    m = x2.shape[0]
    check_shape(m, c, inner, c_out)
    _native.check_cuda_operand("x", x2, torch.bfloat16, (m, c))
    _native.check_cuda_operand("w1", w1, torch.bfloat16, (2 * inner, c))
    _native.check_cuda_operand("b1", b1, torch.bfloat16, (2 * inner,), align=4)
    _native.check_cuda_operand("w2", w2, torch.bfloat16, (c_out, inner))
    _native.check_cuda_operand("b2", b2, torch.bfloat16, (c_out,), align=4)
    h = _native.stream_scratch("geglu_h", m * inner, torch.bfloat16)
    out = torch.empty((m, c_out), dtype=x.dtype, device=x.device)
    bn = down_tile(m, c_out, _native.sm_count(x.get_device()))
    _native.launch("gcd_geglu_mlp", x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), b2.data_ptr(), h.data_ptr(), out.data_ptr(),
                   m, c, inner, c_out, bn)
    geglu_mlp.launches += 1
    return out.reshape(*lead, c_out)


_GEGLU = define("geglu_mlp(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
                _geglu_cuda, geglu_mlp_plain,
                lambda x, w1, b1, w2, b2: x.new_empty((*x.shape[:-1], w2.shape[0])))


def _geglu_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if not kernel_enabled("fused_mlp"):
        return geglu_mlp_plain(x, w1, b1, w2, b2)
    return _GEGLU(x, w1, b1, w2, b2)


geglu_mlp.launches = 0
