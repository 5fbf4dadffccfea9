"""SVD temporal VAE decoder, time_mode "conv-only" (port of the decoder side
of gcd_tpu/models/vae.py). Encoder side arrives with the conditioner.

The reference's VAEGroupNorm is GroupNorm32 with eps 1e-6 here. Its only
attention is the mid-block spatial AttnBlock: one head of width 512
over the latent's tokens, computed with plain matmuls and an fp32 softmax as
the JAX package does (head dim not in {64, 128}). None of the port's CUDA
kernels runs here. Keys follow first_stage_model.decoder.* of the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.layers import GroupNorm32
from gcd_tpu_torch.models.resblock import Upsample
from gcd_tpu_torch.utils.config import instantiate_from_config


class ResnetBlock(nn.Module):
    """norm-swish-conv x2 + 1x1 nin_shortcut."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or channels
        self.norm1 = GroupNorm32(channels, eps=1e-6)
        self.conv1 = nn.Conv2d(channels, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if out_ch != channels:
            self.nin_shortcut = nn.Conv2d(channels, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens, 1x1-conv projections."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (proj(hn).reshape(n, c, h * w) for proj in (self.q, self.k, self.v))
        logits = torch.matmul(q.transpose(1, 2).float(), k.float()) * c ** -0.5
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(weights.float(), v.transpose(1, 2).float()).to(x.dtype)
        return x + self.proj_out(out.transpose(1, 2).reshape(n, c, h, w))


class TemporalResStack(nn.Module):
    """(3,1,1) conv ResBlock without time embedding (`time_stack`), GroupNorm
    eps 1e-5 with fused SiLU. x (B, C, T, H, W)."""

    def __init__(self, channels: int, kernel_size: Sequence[int] = (3, 1, 1)):
        super().__init__()
        pad = tuple(k // 2 for k in kernel_size)
        self.in_layers = nn.Sequential(GroupNorm32(channels, silu=True), nn.Identity(),
                                       nn.Conv3d(channels, channels, tuple(kernel_size), padding=pad))
        self.out_layers = nn.Sequential(GroupNorm32(channels, silu=True), nn.Identity(),
                                        nn.Identity(),
                                        nn.Conv3d(channels, channels, tuple(kernel_size), padding=pad))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](self.in_layers[0](x))
        return x + self.out_layers[3](self.out_layers[0](h))


class DecoderVideoResBlock(ResnetBlock):
    """Spatial ResnetBlock + temporal time_stack, with a learned scalar
    alpha = sigmoid(mix_factor) weighting the temporal branch."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 video_kernel_size: Sequence[int] = (3, 1, 1), alpha: float = 0.0):
        super().__init__(channels, out_channels)
        self.time_stack = TemporalResStack(out_channels or channels, video_kernel_size)
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def forward(self, x: torch.Tensor, timesteps: int) -> torch.Tensor:
        x = super().forward(x)
        bt, c, h, w = x.shape
        x_mix = x.reshape(bt // timesteps, timesteps, c, h, w).transpose(1, 2)
        x_vid = self.time_stack(x_mix)
        alpha = torch.sigmoid(self.mix_factor)[0].to(x.dtype)
        out = alpha * x_vid + (1.0 - alpha) * x_mix
        return out.transpose(1, 2).reshape(bt, c, h, w)


class AE3DConvOut(nn.Conv2d):
    """3x3 conv followed by a (3,1,1) time-mixing conv (`time_mix_conv`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 video_kernel_size: Sequence[int] = (3, 1, 1)):
        super().__init__(in_channels, out_channels, 3, padding=1)
        pad = tuple(k // 2 for k in video_kernel_size)
        self.time_mix_conv = nn.Conv3d(out_channels, out_channels,
                                       tuple(video_kernel_size), padding=pad)

    def forward(self, x: torch.Tensor, timesteps: int) -> torch.Tensor:
        x = super().forward(x)
        bt, c, h, w = x.shape
        x = x.reshape(bt // timesteps, timesteps, c, h, w).transpose(1, 2)
        return self.time_mix_conv(x).transpose(1, 2).reshape(bt, c, h, w)


class _Mid(nn.Module):
    def __init__(self, channels: int, video_kernel_size):
        super().__init__()
        self.block_1 = DecoderVideoResBlock(channels, video_kernel_size=video_kernel_size)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = DecoderVideoResBlock(channels, video_kernel_size=video_kernel_size)


class _UpLevel(nn.Module):
    def __init__(self, blocks, attns, upsample: Optional[nn.Module]):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if attns:
            self.attn = nn.ModuleList(attns)
        if upsample is not None:
            self.upsample = upsample


class VideoDecoder(nn.Module):
    """SVD temporal decoder, time_mode "conv-only" (VideoResBlocks, AE3DConv
    out, plain spatial attention). forward(z (N, z_channels, h, w),
    timesteps) -> (N, out_ch, 8h, 8w); `timesteps` (the decode chunk's frame
    count) must divide N."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 z_channels: int = 4, out_ch: int = 3, resolution: int = 256,
                 video_kernel_size: Sequence[int] = (3, 1, 1),
                 time_mode: str = "conv-only", **unused):
        super().__init__()
        # unused: the reference's double_z / in_channels / dropout / attn_type,
        # which the decoder does not read.
        if time_mode != "conv-only":
            raise NotImplementedError("VideoDecoder port covers time_mode='conv-only'")
        vks = tuple(video_kernel_size)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in, vks)
        levels = []
        for i_level in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(DecoderVideoResBlock(block_in, block_out, vks))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            upsample = Upsample(block_in) if i_level else None
            levels.insert(0, _UpLevel(blocks, attns, upsample))
            curr_res *= 2 if i_level else 1
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = AE3DConvOut(block_in, out_ch, vks)

    def forward(self, z: torch.Tensor, timesteps: Optional[int] = None) -> torch.Tensor:
        t = z.shape[0] if timesteps is None else timesteps
        h = self.conv_in(z)
        h = self.mid.block_1(h, t)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, t)
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(h, t)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)), t)


class AutoencodingEngine(nn.Module):
    """First-stage VAE wrapper, decoder side (`first_stage_model.decoder.*`).
    The encoder and regularizer configs are accepted for config parity; the
    encoder is ported with the conditioner."""

    def __init__(self, decoder_config: dict, encoder_config: Optional[dict] = None,
                 regularizer_config: Optional[dict] = None,
                 loss_config: Optional[dict] = None):
        super().__init__()
        self.decoder = instantiate_from_config(decoder_config)

    def decode(self, z: torch.Tensor, timesteps: int) -> torch.Tensor:
        return self.decoder(z, timesteps)
