"""K2: frame-axis self-attention on the natural (B*T, S, C) layout.

Port of gcd_tpu/ops/temporal_attention.py (`_kernel`, entry
`temporal_attention`). Every spatial position s of video b attends over its
T frames, per head. The CUDA kernel is csrc/temporal_attention.cu;
`temporal_attention_plain` computes the same with a relayout to
(B, S, H, T, D), fp32 logits and softmax, unnormalised P cast to the input
dtype for PV and division after PV.

`temporal_attention` calls the op `gcd::temporal_attention`
(ops/library.py): the plain version on CPU tensors, the kernel or an error
on CUDA ones; under `kernel_flags(tattn=False)` it runs the plain version.
The kernel takes, family by family (`kernel_takes`): a head size D that is
a multiple of 16 up to 128 (the UNet's heads, the narrow family) with T <=
32 frames (SVD-XT's 25 among them), or a multiple of 64 up to 512 (the VAE
decoder's one-head VideoAttnBlock, the wide family; the JAX kernel's own
`d % 64` rule) with T <= 16; the wrapper raises on a CUDA tensor outside
that domain. Its gradient is that of the plain version, recomputed from the
saved q, k, v (ops/recompute.py; gcd_tpu's `_temporal_bwd`).
"""

from __future__ import annotations

from typing import Optional

import torch

from gcd_tpu_torch.ops import _native
from gcd_tpu_torch.ops.dispatch import kernel_enabled
from gcd_tpu_torch.ops.library import define
from gcd_tpu_torch.ops.recompute import plain_gradient

MAX_FRAMES = 32          # the narrow family: two 16-row tiles
MAX_WIDE_FRAMES = 16     # the wide family: one 16-row tile
MAX_HEAD_DIM = 128       # the narrow family: D a multiple of 16
MAX_WIDE_HEAD_DIM = 512  # the wide family: D a multiple of 64


def kernel_head_dim(d: int) -> bool:
    """Whether K2 takes head size d: a multiple of 16 up to MAX_HEAD_DIM
    or of 64 up to MAX_WIDE_HEAD_DIM."""
    return 0 < d and ((d % 16 == 0 and d <= MAX_HEAD_DIM)
                      or (d % 64 == 0 and d <= MAX_WIDE_HEAD_DIM))


def kernel_takes(t: int, d: int) -> bool:
    """Whether K2 takes T = t frames at head size d: T <= MAX_FRAMES in the
    narrow family, T <= MAX_WIDE_FRAMES in the wide one."""
    if not kernel_head_dim(d):
        return False
    return 0 < t <= (MAX_FRAMES if d <= MAX_HEAD_DIM else MAX_WIDE_FRAMES)


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
    """Frame-axis attention on (B*T, S, H*D) tokens; K2 on CUDA (bf16, D a
    multiple of 16 up to 128 with T <= 32, or of 64 up to 512 with T <=
    16)."""
    return plain_gradient(_temporal_forward, temporal_attention_plain, (q3, k3, v3),
                          timesteps=timesteps, heads=heads, scale=scale)


def _temporal_cuda(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                   timesteps: int, heads: int, scale: Optional[float]) -> torch.Tensor:
    """K2: `gcd::temporal_attention` on CUDA tensors."""
    bt, s, c = q3.shape
    t = timesteps
    if bt % t or c % heads:
        raise ValueError(f"temporal_attention: shape {tuple(q3.shape)} with "
                         f"T={t}, heads={heads}")
    d = c // heads
    if not kernel_takes(t, d):
        raise ValueError(f"temporal_attention: kernel takes D a multiple of 16 up to "
                         f"{MAX_HEAD_DIM} with T <= {MAX_FRAMES}, or of 64 up to "
                         f"{MAX_WIDE_HEAD_DIM} with T <= {MAX_WIDE_FRAMES}; got T={t}, D={d}")
    scale = float(d ** -0.5 if scale is None else scale)
    for name, z in (("q", q3), ("k", k3), ("v", v3)):
        _native.check_cuda_operand(name, z, torch.bfloat16, (bt, s, c))
    out = torch.empty_like(q3)
    _native.launch("gcd_temporal_attention", q3.data_ptr(), k3.data_ptr(),
                   v3.data_ptr(), out.data_ptr(), bt, t, s, c, heads, scale)
    temporal_attention.launches += 1
    return out


_TATTN = define("temporal_attention(Tensor q, Tensor k, Tensor v, int timesteps, int heads, "
                "float? scale) -> Tensor", _temporal_cuda, temporal_attention_plain,
                lambda q3, k3, v3, timesteps, heads, scale: q3.new_empty(q3.shape))


def _temporal_forward(q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor,
                      timesteps: int, heads: int, scale: Optional[float]) -> torch.Tensor:
    if not kernel_enabled("tattn"):
        return temporal_attention_plain(q3, k3, v3, timesteps, heads, scale)
    return _TATTN(q3, k3, v3, timesteps, heads, scale)


temporal_attention.launches = 0
