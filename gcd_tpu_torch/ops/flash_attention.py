"""K1 / K6: multi-head self-attention on the natural (B, S, H*D) layout, and
its backward.

Port of gcd_tpu/ops/flash_attention.py: `_mh_kernel` (K1, entry
`flash_attention`) and `_bwd_kernel` (K6, entry `flash_attention_bwd`), with
the JAX package's custom_vjp (`_flash3`) as a torch.autograd.Function. The
CUDA kernels are csrc/flash_attention.cu and csrc/flash_attention_bwd.cu.

`flash_attention_plain` is K1's computation in plain PyTorch, with the same
fp32 islands and bf16 rounding points: fp32 logits, unnormalised
P = exp(s - max) cast to the input dtype for the PV product, fp32
accumulation, division by the row sum after PV.

`flash_attention_bwd_plain` is K6's: fp32 logits, the exact normalised P in
fp32 (not the forward's bf16 P), dV = P^T dO and dP = dO V^T in fp32,
delta = rowsum(dP * P), dS = P (dP - delta) scale rounded to the input dtype
before dQ = dS K and dK = dS^T Q, fp32 accumulation, results in the input
dtype. Its gradient is that of exact attention whichever forward ran, as in
the JAX package.

Each wrapper calls its op (`gcd::flash_attention`,
`gcd::flash_attention_bwd`; ops/library.py), whose CPU implementation is
the plain version and whose CUDA one launches the kernel or raises; under
`kernel_flags(flash=False)` / `kernel_flags(flash_bwd=False)` it runs the
plain version. The backward's path is the
`flash_bwd` switch as it stood at the forward: PyTorch runs a CUDA backward
on its own thread, where the caller's switches are not set.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled, kernel_flags
from gcd_tpu_torch.ops.library import define

KERNEL_HEAD_DIMS = (64, 128)
# Rows of K6's query and key tiles; must equal TR in csrc/flash_attention_bwd.cu.
BWD_TILE = 64


def _heads_first(z: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D) fp32."""
    b, s, hd = z.shape
    return z.reshape(b, s, heads, hd // heads).transpose(1, 2).float()


def _scale(hd: int, heads: int, scale: Optional[float]) -> float:
    return float((hd // heads) ** -0.5 if scale is None else scale)


def flash_attention_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                          heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """(B, Sq, H*D) x (B, Skv, H*D) -> (B, Sq, H*D), dtype of q3."""
    b, sq, hd = q3.shape
    scale = _scale(hd, heads, scale)
    qh, kh, vh = (_heads_first(z, heads) for z in (q3, k3, v3))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q3.dtype).float(), vh) / denom
    return out.transpose(1, 2).reshape(b, sq, hd).to(q3.dtype)


def flash_attention_bwd_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                              do3: torch.Tensor, heads: int,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of self-attention w.r.t. q3, k3, v3 given the output's
    gradient do3, all (B, S, H*D), in the dtypes of q3, k3, v3
    (gcd_tpu/ops/flash_attention.py:_bwd_kernel)."""
    b, sq, hd = q3.shape
    skv = k3.shape[1]
    scale = _scale(hd, heads, scale)
    qh, kh, vh, doh = (_heads_first(z, heads) for z in (q3, k3, v3, do3))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds.to(k3.dtype).float(), kh)
    dk = torch.matmul(ds.to(q3.dtype).float().transpose(-1, -2), qh)

    def back(z, s, dtype):
        return z.transpose(1, 2).reshape(b, s, hd).to(dtype)

    return back(dq, sq, q3.dtype), back(dk, skv, k3.dtype), back(dv, skv, v3.dtype)


def _flash_cuda(q3, k3, v3, heads: int, scale: Optional[float]) -> torch.Tensor:
    """K1: `gcd::flash_attention` on CUDA tensors."""
    b, sq, hd = q3.shape
    skv = k3.shape[1]
    if hd % heads or hd // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd}/{heads} not in {KERNEL_HEAD_DIMS}")
    d = hd // heads
    _native.check_cuda_operand("q", q3, torch.bfloat16, (b, sq, hd))
    _native.check_cuda_operand("k", k3, torch.bfloat16, (b, skv, hd))
    _native.check_cuda_operand("v", v3, torch.bfloat16, (b, skv, hd))
    out = torch.empty_like(q3)
    _native.launch("gcd_flash_attention", q3.data_ptr(), k3.data_ptr(),
                   v3.data_ptr(), out.data_ptr(), b, sq, skv, heads, d,
                   _scale(hd, heads, scale))
    flash_attention.launches += 1
    return out


_FLASH = define("flash_attention(Tensor q, Tensor k, Tensor v, int heads, float? scale) "
                "-> Tensor", _flash_cuda, flash_attention_plain,
                lambda q3, k3, v3, heads, scale: q3.new_empty(q3.shape))


def _flash_forward(q3, k3, v3, heads: int, scale: Optional[float]) -> torch.Tensor:
    """K1 (`gcd::flash_attention`), or the plain version under flash=False."""
    if not kernel_enabled("flash"):
        return flash_attention_plain(q3, k3, v3, heads, scale)
    return _FLASH(q3, k3, v3, heads, scale)


def _flash_bwd_cuda(q3, k3, v3, do3, heads: int, scale: Optional[float]):
    """K6: `gcd::flash_attention_bwd` on CUDA tensors."""
    b, s, hd = q3.shape
    if hd % heads or hd // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd}/{heads} not in "
                         f"{KERNEL_HEAD_DIMS}")
    h, d = heads, hd // heads
    for name, z in (("q", q3), ("k", k3), ("v", v3), ("do", do3)):
        _native.check_cuda_operand(name, z, torch.bfloat16, (b, s, hd))
    dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
    # Per (b, h, row), rows padded to whole tiles: (lse, delta) fp32, kept per
    # stream.
    rows = -(-s // BWD_TILE) * BWD_TILE
    stats = _native.stream_scratch("flash_bwd_stats", 2 * b * h * rows, torch.float32)
    _native.launch("gcd_flash_attention_bwd", q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                   do3.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   stats.data_ptr(), b, s, h, d, _scale(hd, heads, scale))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


_FLASH_BWD = define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor do, int heads, "
                    "float? scale) -> (Tensor, Tensor, Tensor)", _flash_bwd_cuda,
                    flash_attention_bwd_plain,
                    lambda q3, k3, v3, do3, heads, scale: tuple(
                        z.new_empty(z.shape) for z in (q3, k3, v3)))


def flash_attention_bwd(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                        do3: torch.Tensor, heads: int, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of self-attention on (B, S, H*D); K6
    (`gcd::flash_attention_bwd`) on CUDA: bf16 q, k, v, do of one shape
    (Sq = Skv), D in {64, 128}, B and H at most 65535, 16-byte aligned."""
    if not kernel_enabled("flash_bwd"):
        return flash_attention_bwd_plain(q3, k3, v3, do3, heads, scale)
    return _FLASH_BWD(q3, k3, v3, do3, heads, scale)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K6 backward (gcd_tpu/ops/flash_attention.py `_flash3`):
    saves q, k, v, and the `flash_bwd` switch of the forward's thread."""

    @staticmethod
    def forward(ctx, q3, k3, v3, heads, scale):
        ctx.save_for_backward(q3, k3, v3)
        ctx.heads, ctx.scale = heads, scale
        ctx.flash_bwd = kernel_enabled("flash_bwd")
        return _flash_forward(q3, k3, v3, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3 = ctx.saved_tensors
        with kernel_flags(flash_bwd=ctx.flash_bwd):
            dq, dk, dv = flash_attention_bwd(q3, k3, v3, g.contiguous(), ctx.heads,
                                             ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                    heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on (B, S, H*D) tokens; K1 on CUDA (bf16, D in {64, 128}),
    differentiable through K6."""
    if torch.is_grad_enabled() and (q3.requires_grad or k3.requires_grad or v3.requires_grad):
        return _FlashAttention.apply(q3, k3, v3, heads, scale)
    return _flash_forward(q3, k3, v3, heads, scale)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
