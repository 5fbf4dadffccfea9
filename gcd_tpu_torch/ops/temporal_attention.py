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
The kernel takes every T >= 1 and every head size D up to
MAX_GENERAL_HEAD_DIM = 1024 (`kernel_takes`), in three families
(`kernel_family`): D a multiple of 16 up to 128 (the UNet's heads) with T
<= 32 frames (SVD-XT's 25 among them) takes the narrow family; D a
multiple of 64 up to 512 (the VAE decoder's one-head VideoAttnBlock; the
JAX kernel's own `d % 64` rule) with T <= 16 the wide family; every other
shape (clips past 32 frames, the VAE's heads past 16, heads of 40, 80, 160
of a UNet built with `num_heads`) the general family, in one of two
kernels: "resident" where T <= MAX_RESIDENT_FRAMES and one unit's q, k and
v (all T frames of one video, position and head) fit in a block's shared
memory, which loads each unit once and computes each query strip's logits
once; "streamed" for the rest (T past 128, one head of 1024 past 32
frames, of 512 past 64), which streams the key tiles in two passes. The
wrapper raises on a CUDA tensor with D past 1024; no shape is routed to
the plain version. Its gradient is that of the plain version, recomputed
from the saved q, k, v (ops/recompute.py; gcd_tpu's `_temporal_bwd`).
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
MAX_GENERAL_HEAD_DIM = 1024  # the general family: any D, any T
MAX_RESIDENT_FRAMES = 128    # its resident kernel: a strip's logits in registers
_MAX_SMEM = 232448           # shared memory a block may take (csrc's GEN_MAX_SMEM)


def resident_unit_bytes(t: int, d: int) -> int:
    """Shared memory of one resident unit (csrc's `res_unit_bytes`): q, k
    and v, each D padded to 16 in boxes of 64 channels x T padded to 16
    frames, 2 bytes a value. The kernel takes a unit where it fits beside
    1 KB of alignment and 16 bytes of barriers (`res_takes`)."""
    return 3 * -(-(-(-d // 16) * 16) // 64) * 64 * -(-t // 16) * 16 * 2


def kernel_family(t: int, d: int) -> Optional[str]:
    """The kernel of K2 that takes T = t frames at head size d (the C
    entry's dispatch): "narrow", "wide", the general family's "resident" or
    "streamed", or None past MAX_GENERAL_HEAD_DIM."""
    if t < 1 or d < 1 or d > MAX_GENERAL_HEAD_DIM:
        return None
    if d <= MAX_HEAD_DIM and d % 16 == 0 and t <= MAX_FRAMES:
        return "narrow"
    if MAX_HEAD_DIM < d <= MAX_WIDE_HEAD_DIM and d % 64 == 0 and t <= MAX_WIDE_FRAMES:
        return "wide"
    if t <= MAX_RESIDENT_FRAMES and 1024 + resident_unit_bytes(t, d) + 16 <= _MAX_SMEM:
        return "resident"
    return "streamed"


def kernel_takes(t: int, d: int) -> bool:
    """Whether K2 takes T = t frames at head size d: every T >= 1 with D up
    to MAX_GENERAL_HEAD_DIM."""
    return kernel_family(t, d) is not None


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
    """Frame-axis attention on (B*T, S, H*D) tokens; K2 on CUDA (bf16, any
    T, D up to 1024)."""
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
        raise ValueError(f"temporal_attention: kernel takes heads of up to "
                         f"{MAX_GENERAL_HEAD_DIM} channels; got T={t}, D={d}")
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
