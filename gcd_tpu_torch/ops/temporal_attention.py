"""K2: frame-axis self-attention on the natural (B*T, S, C) layout.

Port of gcd_tpu/ops/temporal_attention.py (`_kernel`, entry
`temporal_attention`). Every spatial position s of video b attends over its
T frames, per head. The CUDA kernel is csrc/temporal_attention.cu;
`temporal_attention_plain` computes the same with a relayout to
(B, S, H, T, D), fp32 logits and softmax, unnormalised P cast to the input
dtype for PV and division after PV.

`temporal_attention` takes the plain version for CPU tensors, or when
`kernel_flags(tattn=False)` is set; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled

MAX_FRAMES = 16
MAX_HEAD_DIM = 128


def temporal_attention_plain(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                             timesteps: int, heads: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """(B*T, S, H*D) q/k/v -> (B*T, S, H*D), attention over the T frames."""
    bt, s, c = q3.shape
    t = timesteps
    b = bt // t
    d = c // heads
    scale = float(d ** -0.5 if scale is None else scale)

    def frames_last(z):  # (B*T, S, C) -> (B, S, H, T, D), fp32
        return z.reshape(b, t, s, heads, d).permute(0, 2, 3, 1, 4).float()

    qh, kh, vh = frames_last(q3), frames_last(k3), frames_last(v3)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q3.dtype).float(), vh) / denom  # (B, S, H, T, D)
    return out.to(q3.dtype).permute(0, 3, 1, 2, 4).reshape(bt, s, c)


def temporal_attention(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                       timesteps: int, heads: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Frame-axis attention on (B*T, S, H*D) tokens; K2 on CUDA (bf16,
    T <= 16, even D <= 128)."""
    if q3.device.type == "cpu" or not kernel_enabled("tattn"):
        return temporal_attention_plain(q3, k3, v3, timesteps, heads, scale)
    bt, s, c = q3.shape
    t = timesteps
    if bt % t or c % heads:
        raise ValueError(f"temporal_attention: shape {tuple(q3.shape)} with "
                         f"T={t}, heads={heads}")
    d = c // heads
    if t > MAX_FRAMES or d % 2 or d > MAX_HEAD_DIM:
        raise ValueError(f"temporal_attention: kernel takes T <= {MAX_FRAMES} and "
                         f"even D <= {MAX_HEAD_DIM}, got T={t}, D={d}")
    scale = float(d ** -0.5 if scale is None else scale)
    for name, z in (("q", q3), ("k", k3), ("v", v3)):
        _native.check_cuda_operand(name, z, torch.bfloat16, (bt, s, c), align=4)
    out = torch.empty_like(q3)
    _native.launch("gcd_temporal_attention", q3.data_ptr(), k3.data_ptr(),
                   v3.data_ptr(), out.data_ptr(), bt, t, s, c, heads, scale)
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0
