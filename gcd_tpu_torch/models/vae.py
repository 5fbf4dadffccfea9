"""KL VAE (port of gcd_tpu/models/vae.py): the image Encoder, the plain 2D
Decoder, the SVD temporal VideoDecoder (time_mode "conv-only"), and the
engines that hold them.

The reference's VAEGroupNorm is GroupNorm32 with eps 1e-6 here (K4 on
CUDA); the VAE ResnetBlocks and norm_out apply SiLU to its bf16 output, as
the JAX package does, while the time_stack norms fuse SiLU in fp32. The only
attention is the mid-block spatial AttnBlock: one head of width 512 over the
latent's tokens, computed with plain matmuls and an fp32 softmax as the JAX
package does (head dim not in {64, 128}). Keys follow the reference:
first_stage_model.{encoder,decoder}.*, and encoder / decoder / quant_conv /
post_quant_conv under AutoencoderKLModeOnly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.layers import GroupNorm32
from gcd_tpu_torch.models.resblock import Upsample
from gcd_tpu_torch.ops.basic import dot_product_attention
from gcd_tpu_torch.utils.config import instantiate_from_config


class ResnetBlock(nn.Module):
    """norm-swish-conv x2 + 1x1 nin_shortcut. `timesteps` is accepted and
    unused, so 2D and video decoders share one block-calling loop."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or channels
        self.norm1 = GroupNorm32(channels, eps=1e-6)
        self.conv1 = nn.Conv2d(channels, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if out_ch != channels:
            self.nin_shortcut = nn.Conv2d(channels, out_ch, 1)

    def forward(self, x: torch.Tensor, timesteps: Optional[int] = None) -> torch.Tensor:
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
        q, k, v = (proj(hn).reshape(n, c, h * w).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v)  # (N, HW, C)
        return x + self.proj_out(out.transpose(1, 2).reshape(n, c, h, w))


class Downsample(nn.Module):
    """Asymmetric (0, 1, 0, 1) pad, then a stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


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
    def __init__(self, block_1: nn.Module, attn_1: nn.Module, block_2: nn.Module):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = block_1, attn_1, block_2


class _Level(nn.Module):
    """One resolution of the encoder (`down.N`) or decoder (`up.N`): blocks,
    optional attentions, optional resampler under `resample_name`."""

    def __init__(self, blocks, attns, resample_name: str, resample: Optional[nn.Module]):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if attns:
            self.attn = nn.ModuleList(attns)
        if resample is not None:
            setattr(self, resample_name, resample)

    def forward(self, h: torch.Tensor, timesteps: Optional[int] = None) -> torch.Tensor:
        for i, block in enumerate(self.block):
            h = block(h, timesteps)
            if hasattr(self, "attn"):
                h = self.attn[i](h)
        return h


class Encoder(nn.Module):
    """f8 image encoder. forward(x (N, in_channels, H, W) in [-1, 1]) ->
    moments (N, 2*z_channels, H/8, W/8) when double_z."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 z_channels: int = 4, double_z: bool = True, in_channels: int = 3,
                 resolution: int = 256, **unused):
        super().__init__()
        # unused: the reference's out_ch / dropout / attn_type, which the
        # encoder does not read.
        curr_res = resolution
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        block_in, levels = ch, []
        for i_level, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            last = i_level == len(ch_mult) - 1
            levels.append(_Level(blocks, attns, "downsample",
                                 None if last else Downsample(block_in)))
            curr_res //= 1 if last else 2
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(ResnetBlock(block_in), AttnBlock(block_in), ResnetBlock(block_in))
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, 2 * z_channels if double_z else z_channels,
                                  3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    """Plain SD image decoder. forward(z (N, z_channels, h, w)) ->
    (N, out_ch, 8h, 8w). Subclasses swap the residual block and the output
    conv; `timesteps` reaches every block."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 z_channels: int = 4, out_ch: int = 3, resolution: int = 256, **unused):
        super().__init__()
        # unused: the reference's double_z / in_channels / dropout / attn_type,
        # which the decoder does not read.
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(self._res_block(block_in, block_in), AttnBlock(block_in),
                        self._res_block(block_in, block_in))
        levels = []
        for i_level in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(self._res_block(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            levels.insert(0, _Level(blocks, attns, "upsample",
                                    Upsample(block_in) if i_level else None))
            curr_res *= 2 if i_level else 1
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = self._out_conv(block_in, out_ch)

    def _res_block(self, channels: int, out_channels: int) -> nn.Module:
        return ResnetBlock(channels, out_channels)

    def _out_conv(self, channels: int, out_channels: int) -> nn.Module:
        return nn.Conv2d(channels, out_channels, 3, padding=1)

    def _head(self, h: torch.Tensor, timesteps: Optional[int]) -> torch.Tensor:
        return self.conv_out(h)

    def forward(self, z: torch.Tensor, timesteps: Optional[int] = None) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_1(h, timesteps)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, timesteps)
        for level in reversed(self.up):
            h = level(h, timesteps)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self._head(F.silu(self.norm_out(h)), timesteps)


class VideoDecoder(Decoder):
    """SVD temporal decoder, time_mode "conv-only" (VideoResBlocks, AE3DConv
    out, plain spatial attention). forward(z (N, z_channels, h, w),
    timesteps) -> (N, out_ch, 8h, 8w); `timesteps` (the decode chunk's frame
    count, N when None) must divide N."""

    def __init__(self, *args, video_kernel_size: Sequence[int] = (3, 1, 1),
                 time_mode: str = "conv-only", **kwargs):
        if time_mode != "conv-only":
            raise NotImplementedError("VideoDecoder port covers time_mode='conv-only'")
        self._vks = tuple(video_kernel_size)  # read by Decoder.__init__'s hooks
        super().__init__(*args, **kwargs)

    def _res_block(self, channels: int, out_channels: int) -> nn.Module:
        return DecoderVideoResBlock(channels, out_channels, self._vks)

    def _out_conv(self, channels: int, out_channels: int) -> nn.Module:
        return AE3DConvOut(channels, out_channels, self._vks)

    def _head(self, h: torch.Tensor, timesteps: Optional[int]) -> torch.Tensor:
        return self.conv_out(h, timesteps)

    def forward(self, z: torch.Tensor, timesteps: Optional[int] = None) -> torch.Tensor:
        return super().forward(z, z.shape[0] if timesteps is None else timesteps)


class DiagonalGaussianDistribution:
    """The VAE posterior over channel-split moments (N, 2z, h, w), logvar
    clamped to [-30, 20] (gcd_tpu/models/vae.py:502-518)."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise, the unit Gaussian `noise` (N, z, h, w) given
        or drawn in fp32 from torch's global generator."""
        if noise is None:
            noise = torch.randn(self.mean.shape, device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean


class DiagonalGaussianRegularizer:
    """The first stage's posterior: a sample (the default, as in training)
    or the mode (gcd_tpu/models/vae.py:527-540). Returns the latent only;
    the KL term is not part of GCD's loss."""

    def __init__(self, sample: bool = True):
        self.sample = sample

    def __call__(self, moments: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        posterior = DiagonalGaussianDistribution(moments)
        return posterior.sample(noise) if self.sample else posterior.mode()


class AutoencodingEngine(nn.Module):
    """First-stage VAE wrapper (`first_stage_model.{encoder,decoder}.*`), no
    quant convs. `encode` goes through the configured regularizer, by
    default a DiagonalGaussianRegularizer that samples the posterior; the
    loss config is accepted for config parity."""

    def __init__(self, encoder_config: dict, decoder_config: dict,
                 regularizer_config: Optional[dict] = None,
                 loss_config: Optional[dict] = None):
        super().__init__()
        self.encoder = instantiate_from_config(encoder_config)
        self.decoder = instantiate_from_config(decoder_config)
        self.regularization = (instantiate_from_config(regularizer_config)
                               if regularizer_config else DiagonalGaussianRegularizer())

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, 3, H, W) -> latents (N, z, H/8, W/8); a posterior sample
        takes `noise` (N, z, H/8, W/8) or draws it from torch's global
        generator."""
        return self.regularization(self.encoder(x), noise)

    def decode(self, z: torch.Tensor, timesteps: int) -> torch.Tensor:
        return self.decoder(z, timesteps)


class AutoencoderKLModeOnly(nn.Module):
    """KL autoencoder with quant / post_quant 1x1 convs whose `encode`
    returns the posterior mode (the conditioner's frame encoder). The
    conditioner never decodes; the 2D decoder is here because the reference
    checkpoints store it, so a state dict loads with strict=True."""

    def __init__(self, embed_dim: int, ddconfig: dict, **unused):
        super().__init__()
        # unused: the reference's lossconfig / monitor.
        dd = {k: v for k, v in ddconfig.items() if k != "lossconfig"}
        mult = 2 if dd.get("double_z", True) else 1
        z_channels = int(dd.get("z_channels", 4))
        self.encoder = Encoder(**dd)
        self.decoder = Decoder(**dd)
        self.quant_conv = nn.Conv2d(mult * z_channels, mult * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return DiagonalGaussianDistribution(self.quant_conv(self.encoder(x))).mode()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
