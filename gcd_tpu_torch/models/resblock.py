"""UNet residual blocks and resampling (port of gcd_tpu/models/resblock.py).

Plain cuDNN conv2d / conv3d; the JAX package's XLA conv rewrites
(ops/subpixel.py, ops/temporal_conv.py, ops/spatial_conv.py) are TPU-only
and not ported. Images are (N, C, H, W), videos (B, C, T, H, W).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.layers import AlphaBlender, GroupNorm32


class Upsample(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels or channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.op = nn.Conv2d(channels, out_channels or channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv x2 with timestep-embedding injection. A 3-entry
    `kernel_size` makes it the 3D (video) form. Keys in_layers.{0,2},
    emb_layers.1, out_layers.{0,3}, skip_connection as in the reference."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None,
                 kernel_size: Sequence[int] = (3, 3)):
        super().__init__()
        out_ch = out_channels or channels
        ks = tuple(kernel_size)
        conv = nn.Conv2d if len(ks) == 2 else nn.Conv3d
        pad = tuple(k // 2 for k in ks)
        self.in_layers = nn.Sequential(GroupNorm32(channels, silu=True), nn.Identity(),
                                       conv(channels, out_ch, ks, padding=pad))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch, silu=True), nn.Identity(),
                                        nn.Identity(), conv(out_ch, out_ch, ks, padding=pad))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else conv(channels, out_ch, 1))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) with emb (N, E), or x (B, C, T, H, W) with emb (B, T, E)."""
        h = self.in_layers[2](self.in_layers[0](x))
        emb_out = self.emb_layers(emb)
        if x.dim() == 5:
            emb_out = emb_out.transpose(1, 2)  # (B, C, T)
        emb_out = emb_out.reshape(*emb_out.shape, *([1] * (h.dim() - emb_out.dim())))
        h = h + emb_out.to(h.dtype)
        h = self.out_layers[3](self.out_layers[0](h))
        return self.skip_connection(x) + h


class VideoResBlock(ResBlock):
    """Spatial ResBlock + (3,1,1) time-mixing ResBlock `time_stack`, merged
    by an AlphaBlender. x (B*T, C, H, W), emb (B*T, E), indicator (B, T)."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None,
                 video_kernel_size: Sequence[int] = (3, 1, 1),
                 merge_strategy: str = "learned_with_images",
                 merge_factor: float = 0.5):
        super().__init__(channels, emb_channels, out_channels)
        out_ch = out_channels or channels
        self.time_stack = ResBlock(out_ch, emb_channels, out_ch,
                                   kernel_size=video_kernel_size)
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                image_only_indicator: torch.Tensor, num_video_frames: int
                ) -> torch.Tensor:
        t = num_video_frames
        x = super().forward(x, emb)
        bt, c, h, w = x.shape
        b = bt // t
        x_mix = x.reshape(b, t, c, h, w).transpose(1, 2)  # (B, C, T, H, W)
        x_vid = self.time_stack(x_mix, emb.reshape(b, t, -1))
        alpha = self.time_mixer.get_alpha(image_only_indicator)
        if alpha.dim():
            alpha = alpha[:, None, :, None, None]
        out = self.time_mixer(x_mix, x_vid, alpha)
        return out.transpose(1, 2).reshape(bt, c, h, w)
