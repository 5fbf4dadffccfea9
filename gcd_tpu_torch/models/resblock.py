"""UNet residual blocks and resampling (port of gcd_tpu/models/resblock.py).

The 2D ResBlocks (the spatial half of each VideoResBlock) run their
GroupNorm -> SiLU -> 3x3 conv chains, in_layers and out_layers (after the
embedding is added), through K7 (ops/fused_gn_conv.py) under the
`fused_gn_conv` switch, where its shape rule holds, as
gcd_tpu/models/resblock.py:132-190 does; the parameters keep their names.
Every other conv is a plain cuDNN conv2d / conv3d; the JAX package's XLA
conv rewrites (ops/subpixel.py, ops/temporal_conv.py, ops/spatial_conv.py)
are TPU-only and not ported. Images are (N, C, H, W), videos
(B, C, T, H, W).

Under a frame group (parallel/frames.py) a VideoResBlock holds T / F frames
of its videos: the spatial ResBlock runs on them, and its `time_stack` on
all T frames at 1 / F of the positions (frames_to_rows before it,
rows_to_frames after it), its GroupNorm statistics summed over the group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.layers import AlphaBlender, GroupNorm32
from gcd_tpu_torch.ops.dispatch import kernel_enabled
from gcd_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3, supported
from gcd_tpu_torch.parallel.frames import (
    current_frame_group,
    frames_to_rows,
    local_frames,
    rows_to_frames,
)


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
        for c in self.fused_convs():
            # (F, 3, 3, C) memory, the layout K7 reads in place. Module.to,
            # to_empty and load_state_dict's copy_ all keep a weight's strides.
            c.weight.data = c.weight.data.contiguous(memory_format=torch.channels_last)

    def _norm_conv(self, layers: nn.Sequential, x: torch.Tensor, stats_group=None
                   ) -> torch.Tensor:
        """layers[-1](layers[0](x)): K7 for a 2D 3x3 chain under the switch
        where it takes the shape, else GroupNorm32 (its statistics summed
        over `stats_group`, if any) then the conv."""
        norm, conv = layers[0], layers[-1]
        if (x.dim() == 4 and kernel_enabled("fused_gn_conv")
                and supported(x, conv.weight, norm.num_groups)):
            # The weight as built is channels_last already (no copy); FSDP's
            # gathered weight is contiguous, and is relaid out here.
            weight = conv.weight.contiguous(memory_format=torch.channels_last)
            return gn_silu_conv3x3(x, norm.weight, norm.bias, weight, conv.bias,
                                   norm.num_groups, norm.eps, norm.silu)
        return conv(norm(x, stats_group))

    def forward(self, x: torch.Tensor, emb: torch.Tensor, stats_group=None) -> torch.Tensor:
        """x (N, C, H, W) with emb (N, E), or x (B, C, T, H, W) with emb (B, T, E);
        a video's GroupNorm statistics summed over `stats_group`, if any."""
        h = self._norm_conv(self.in_layers, x, stats_group)
        emb_out = self.emb_layers(emb)
        if x.dim() == 5:
            emb_out = emb_out.transpose(1, 2)  # (B, C, T)
        emb_out = emb_out.reshape(*emb_out.shape, *([1] * (h.dim() - emb_out.dim())))
        h = h + emb_out.to(h.dtype)
        h = self._norm_conv(self.out_layers, h, stats_group)
        return self.skip_connection(x) + h

    def fused_convs(self):
        """The convs K7 can take: those of a 2D block's in_layers and
        out_layers."""
        if not (isinstance(self.in_layers[2], nn.Conv2d)
                and self.in_layers[2].kernel_size == (3, 3)):
            return []
        return [self.in_layers[2], self.out_layers[3]]


class VideoResBlock(ResBlock):
    """Spatial ResBlock + (3,1,1) time-mixing ResBlock `time_stack`, merged
    by an AlphaBlender. x (B*T, C, H, W), emb (B*T, E), indicator (B, T);
    under a frame group x holds this rank's T / F frames of each video and
    the indicator its columns, while emb covers all T."""

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
        fg = current_frame_group()
        x = super().forward(x, local_frames(emb, t, fg))
        bt, c, h, w = x.shape
        b = emb.shape[0] // t
        x_mix = x.reshape(b, bt // b, c, h, w).transpose(1, 2)  # (B, C, T or T/F, H, W)
        rows = frames_to_rows(x, fg)  # all T frames of the rank's share of the positions
        x_rows = rows.reshape(b, t, c, *rows.shape[2:]).transpose(1, 2)
        x_vid = self.time_stack(x_rows, emb.reshape(b, t, -1),
                                None if fg is None else fg.group)
        if fg is not None:
            x_vid = rows_to_frames(x_vid.transpose(1, 2).reshape(b * t, c, *rows.shape[2:]),
                                   fg, (h, w)).reshape(b, bt // b, c, h, w).transpose(1, 2)
        alpha = self.time_mixer.get_alpha(image_only_indicator)
        if alpha.dim():
            alpha = alpha[:, None, :, None, None]
        out = self.time_mixer(x_mix, x_vid, alpha)
        return out.transpose(1, 2).reshape(bt, c, h, w)
