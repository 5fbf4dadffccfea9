"""K1: multi-head self-attention on the natural (B, S, H*D) layout.

Port of gcd_tpu/ops/flash_attention.py (`_mh_kernel`, entry
`flash_attention`). The CUDA kernel is csrc/flash_attention.cu;
`flash_attention_plain` is the same computation in plain PyTorch, with the
same fp32 islands and bf16 rounding points: fp32 logits, unnormalised
P = exp(s - max) cast to the input dtype for the PV product, fp32
accumulation, division by the row sum after PV.

`flash_attention` takes the plain version for CPU tensors, or when
`kernel_flags(flash=False)` is set; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled

KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                          heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """(B, Sq, H*D) x (B, Skv, H*D) -> (B, Sq, H*D), dtype of q3."""
    b, sq, hd = q3.shape
    skv = k3.shape[1]
    d = hd // heads
    scale = float(d ** -0.5 if scale is None else scale)
    qh = q3.reshape(b, sq, heads, d).transpose(1, 2).float()
    kh = k3.reshape(b, skv, heads, d).transpose(1, 2).float()
    vh = v3.reshape(b, skv, heads, d).transpose(1, 2).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q3.dtype).float(), vh) / denom
    return out.transpose(1, 2).reshape(b, sq, hd).to(q3.dtype)


def flash_attention(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                    heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on (B, S, H*D) tokens; K1 on CUDA (bf16, D in {64, 128})."""
    if q3.device.type == "cpu" or not kernel_enabled("flash"):
        return flash_attention_plain(q3, k3, v3, heads, scale)
    b, sq, hd = q3.shape
    skv = k3.shape[1]
    if hd % heads or hd // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd}/{heads} not in {KERNEL_HEAD_DIMS}")
    d = hd // heads
    scale = float(d ** -0.5 if scale is None else scale)
    _native.check_cuda_operand("q", q3, torch.bfloat16, (b, sq, hd))
    _native.check_cuda_operand("k", k3, torch.bfloat16, (b, skv, hd))
    _native.check_cuda_operand("v", v3, torch.bfloat16, (b, skv, hd))
    out = torch.empty_like(q3)
    _native.launch("gcd_flash_attention", q3.data_ptr(), k3.data_ptr(),
                   v3.data_ptr(), out.data_ptr(), b, sq, skv, heads, d, scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
