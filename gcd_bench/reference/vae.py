"""Plain float32 KL autoencoder of Stable Video Diffusion: the f8 image
Encoder, the 2D Decoder, and the temporal VideoDecoder in GCD's
"conv-only" time mode (sgm's `temporal_ae.VideoDecoder`). Keys are the
checkpoint's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gcd_bench.reference.layers import GroupNorm, QConv2d, QConv3d, attention


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm1 = GroupNorm(c_in, eps=1e-6, silu=True)
        self.conv1 = QConv2d(c_in, c_out, 3, padding=1)
        self.norm2 = GroupNorm(c_out, eps=1e-6, silu=True)
        self.conv2 = QConv2d(c_out, c_out, 3, padding=1)
        if c_out != c_in:
            self.nin_shortcut = QConv2d(c_in, c_out, 1)

    def forward(self, x: torch.Tensor, t: int = 1) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class TimeStack(nn.Module):
    """(3, 1, 1) conv residual block over (B, C, T, H, W)."""

    def __init__(self, ch: int, kernel):
        super().__init__()
        pad = tuple(k // 2 for k in kernel)
        self.in_layers = nn.Sequential(GroupNorm(ch, silu=True), nn.Identity(),
                                       QConv3d(ch, ch, tuple(kernel), padding=pad))
        self.out_layers = nn.Sequential(GroupNorm(ch, silu=True), nn.Identity(), nn.Identity(),
                                        QConv3d(ch, ch, tuple(kernel), padding=pad))

    def forward(self, x):
        h = self.in_layers[2](self.in_layers[0](x))
        return x + self.out_layers[3](self.out_layers[0](h))


class VideoResnetBlock(ResnetBlock):
    """ResnetBlock, then alpha * time_stack + (1 - alpha) * itself, alpha = sigmoid(mix)."""

    def __init__(self, c_in: int, c_out: int, kernel):
        super().__init__(c_in, c_out)
        self.time_stack = TimeStack(c_out, kernel)
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, t: int = 1) -> torch.Tensor:
        x = super().forward(x)
        bt, c, h, w = x.shape
        x_mix = x.reshape(bt // t, t, c, h, w).transpose(1, 2)
        alpha = torch.sigmoid(self.mix_factor)[0]
        out = alpha * self.time_stack(x_mix) + (1.0 - alpha) * x_mix
        return out.transpose(1, 2).reshape(bt, c, h, w)


class AttnBlock(nn.Module):
    """One head of the block's width over the plane's tokens."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (QConv2d(ch, ch, 1) for _ in range(4))

    def forward(self, x: torch.Tensor, t: int = 1) -> torch.Tensor:
        n, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (p(hn).reshape(n, c, h * w).transpose(1, 2) for p in (self.q, self.k, self.v))
        out = attention(q, k, v).transpose(1, 2).reshape(n, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Level(nn.Module):
    def __init__(self, blocks, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, resample_name, resample)


class Mid(nn.Module):
    def __init__(self, block_1, attn_1, block_2):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = block_1, attn_1, block_2

    def forward(self, h, t: int = 1):
        return self.block_2(self.attn_1(self.block_1(h, t), t), t)


class Encoder(nn.Module):
    """(N, 3, H, W) -> moments (N, 2 z, H/8, W/8)."""

    def __init__(self, ch: int = 128, ch_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 4, in_channels: int = 3, **unused):
        super().__init__()
        self.conv_in = QConv2d(in_channels, ch, 3, padding=1)
        c, levels = ch, []
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(c, ch * mult))
                c = ch * mult
            last = i == len(ch_mult) - 1
            levels.append(Level(blocks, "downsample", None if last else Downsample(c)))
        self.down = nn.ModuleList(levels)
        self.mid = Mid(ResnetBlock(c, c), AttnBlock(c), ResnetBlock(c, c))
        self.norm_out = GroupNorm(c, eps=1e-6, silu=True)
        self.conv_out = QConv2d(c, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    """z (N, z, h, w) -> (N, 3, 8h, 8w); `video` makes it the temporal
    decoder whose blocks mix the `t` frames of each chunk."""

    def __init__(self, ch: int = 128, ch_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                 z_channels: int = 4, out_ch: int = 3, video: bool = False,
                 video_kernel_size=(3, 1, 1), **unused):
        super().__init__()
        self.video = video

        def res(c_in, c_out):
            if video:
                return VideoResnetBlock(c_in, c_out, video_kernel_size)
            return ResnetBlock(c_in, c_out)

        c = ch * ch_mult[-1]
        self.conv_in = QConv2d(z_channels, c, 3, padding=1)
        self.mid = Mid(res(c, c), AttnBlock(c), res(c, c))
        levels = []
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(res(c, ch * ch_mult[i]))
                c = ch * ch_mult[i]
            levels.insert(0, Level(blocks, "upsample", Upsample(c) if i else None))
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(c, eps=1e-6, silu=True)
        self.conv_out = QConv2d(c, out_ch, 3, padding=1)
        if video:
            pad = tuple(k // 2 for k in video_kernel_size)
            self.conv_out.time_mix_conv = QConv3d(out_ch, out_ch, tuple(video_kernel_size),
                                                  padding=pad)

    def forward(self, z: torch.Tensor, t: int = 1) -> torch.Tensor:
        h = self.mid(self.conv_in(z), t)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, t)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        out = self.conv_out(self.norm_out(h))
        if self.video:
            bt, c, hh, ww = out.shape
            out = out.reshape(bt // t, t, c, hh, ww).transpose(1, 2)
            out = self.conv_out.time_mix_conv(out).transpose(1, 2).reshape(bt, c, hh, ww)
        return out


def posterior(moments: torch.Tensor, noise=None) -> torch.Tensor:
    """The diagonal Gaussian's mean, or mean + std * noise; logvar clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=1)
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise


class FirstStage(nn.Module):
    """`first_stage_model`: encoder and the temporal decoder, no quant convs."""

    def __init__(self, ddconfig: dict, video_kernel_size=(3, 1, 1)):
        super().__init__()
        self.encoder = Encoder(**ddconfig)
        self.decoder = Decoder(**ddconfig, video=True, video_kernel_size=video_kernel_size)


class ModeOnlyAE(nn.Module):
    """The conditioner's frame encoder (AutoencoderKLModeOnly): encoder,
    quant convs and a 2D decoder the checkpoint holds; encodes to the mode."""

    def __init__(self, embed_dim: int, ddconfig: dict):
        super().__init__()
        z = ddconfig.get("z_channels", 4)
        self.encoder = Encoder(**ddconfig)
        self.decoder = Decoder(**ddconfig)
        self.quant_conv = QConv2d(2 * z, 2 * embed_dim, 1)
        self.post_quant_conv = QConv2d(embed_dim, z, 1)

    def encode(self, x):
        return posterior(self.quant_conv(self.encoder(x)))
