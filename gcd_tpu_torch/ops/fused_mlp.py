"""K3: fused GEGLU feed-forward.

Port of gcd_tpu/ops/fused_mlp.py (`_kernel`, entry `geglu_mlp`), with exact
erf GELU. Weights are in torch Linear layout: w1 (2I, C) with the value rows
first and the gate rows second, b1 (2I,), w2 (C_out, I), b2 (C_out,).

`geglu_mlp_plain` follows the TPU kernel's rounding points: the up products
are rounded to the input dtype, the bias is added in that dtype, the gated
product is computed in fp32 and rounded before the down product. The CUDA
kernel (csrc/fused_mlp.cu) keeps the (M, 2I) up-projection on chip; it sums
the down product over inner-dimension slices in an fp32 workspace that the
wrapper allocates.

`geglu_mlp` takes the plain version for CPU tensors, or when
`kernel_flags(fused_mlp=False)` is set; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled


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


def geglu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEGLU MLP; K3 on CUDA (bf16, C a multiple of 64, I of 256, C_out of 16)."""
    if x.device.type == "cpu" or not kernel_enabled("fused_mlp"):
        return geglu_mlp_plain(x, w1, b1, w2, b2)
    c = x.shape[-1]
    c_out, inner = w2.shape
    if c % 64 or inner % 256 or c_out % 16:
        raise ValueError(f"geglu_mlp: kernel takes C a multiple of 64, I of 256 and "
                         f"C_out of 16, got C={c}, I={inner}, C_out={c_out}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, c)
    m = x2.shape[0]
    _native.check_cuda_operand("x", x2, torch.bfloat16, (m, c))
    _native.check_cuda_operand("w1", w1, torch.bfloat16, (2 * inner, c))
    _native.check_cuda_operand("b1", b1, torch.bfloat16, (2 * inner,), align=2)
    _native.check_cuda_operand("w2", w2, torch.bfloat16, (c_out, inner))
    _native.check_cuda_operand("b2", b2, torch.bfloat16, (c_out,), align=2)
    workspace = torch.empty((m, c_out), dtype=torch.float32, device=x.device)
    out = torch.empty((m, c_out), dtype=x.dtype, device=x.device)
    _native.launch("gcd_geglu_mlp", x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), b2.data_ptr(), workspace.data_ptr(), out.data_ptr(),
                   m, c, inner, c_out)
    geglu_mlp.launches += 1
    return out.reshape(*lead, c_out)


geglu_mlp.launches = 0
