"""Plain float32 VideoUNet of Stable Video Diffusion with GCD's camera head.

Written from the published model (sgm's `video_model.VideoUNet` with
`SpatialVideoTransformer` and `VideoResBlock`) for the options GCD's
configurations set: linear transformer projections, spatial context for the
temporal blocks, learned_with_images blends, an extra ff_in in the temporal
blocks, a (3, 1, 1) time kernel, the sequential label embedding and the
optional `aux_label_emb`. Parameter names are the checkpoint's, under
`model.diffusion_model.`. x (B*T, C, H, W), timesteps (B*T,), context
(B*T, 1, Ck), y (B*T, adm + aux), indicator (B, T).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gcd_bench.reference.layers import (GroupNorm, QConv2d, QConv3d, QLinear, attention, mlp,
                                        timestep_embedding)


def _blend(mix_factor: torch.Tensor, indicator: torch.Tensor) -> torch.Tensor:
    """learned_with_images: 1 on image-only frames, sigmoid(mix) elsewhere; (B, T)."""
    alpha = torch.sigmoid(mix_factor)[0]
    return torch.where(indicator.bool(), torch.ones_like(alpha), alpha)


class Blender(nn.Module):
    def __init__(self, alpha: float):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv, + the embedding, GroupNorm-SiLU-conv, + skip.
    A 3-tuple kernel makes it the video form over (B, C, T, H, W) with an
    embedding (B, T, E)."""

    def __init__(self, c_in: int, emb: int, c_out: int, kernel=(3, 3)):
        super().__init__()
        conv = QConv2d if len(kernel) == 2 else QConv3d
        pad = tuple(k // 2 for k in kernel)
        self.in_layers = nn.Sequential(GroupNorm(c_in, silu=True), nn.Identity(),
                                       conv(c_in, c_out, kernel, padding=pad))
        self.emb_layers = nn.Sequential(nn.SiLU(), QLinear(emb, c_out))
        self.out_layers = nn.Sequential(GroupNorm(c_out, silu=True), nn.Identity(),
                                        nn.Identity(), conv(c_out, c_out, kernel, padding=pad))
        self.skip_connection = nn.Identity() if c_out == c_in else conv(c_in, c_out, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](self.in_layers[0](x))
        e = self.emb_layers(emb)
        if x.dim() == 5:
            e = e.transpose(1, 2)  # (B, C, T)
        h = h + e.reshape(*e.shape, *([1] * (h.dim() - e.dim())))
        h = self.out_layers[3](self.out_layers[0](h))
        return self.skip_connection(x) + h


class VideoResBlock(ResBlock):
    def __init__(self, c_in: int, emb: int, c_out: int, video_kernel, merge_factor: float):
        super().__init__(c_in, emb, c_out)
        self.time_stack = ResBlock(c_out, emb, c_out, tuple(video_kernel))
        self.time_mixer = Blender(merge_factor)

    def forward(self, x, emb, indicator, t):
        x = super().forward(x, emb)
        bt, c, h, w = x.shape
        b = bt // t
        x_mix = x.reshape(b, t, c, h, w).transpose(1, 2)
        x_vid = self.time_stack(x_mix, emb.reshape(b, t, -1))
        alpha = _blend(self.time_mixer.mix_factor, indicator)[:, None, :, None, None]
        out = alpha * x_mix + (1.0 - alpha) * x_vid
        return out.transpose(1, 2).reshape(bt, c, h, w)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, d_head: int, context_dim=None):
        super().__init__()
        inner = heads * d_head
        ctx = context_dim or dim
        self.heads = heads
        self.to_q = QLinear(dim, inner, bias=False)
        self.to_k = QLinear(ctx, inner, bias=False)
        self.to_v = QLinear(ctx, inner, bias=False)
        self.to_out = nn.Sequential(QLinear(inner, dim), nn.Identity())

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, n, inner = q.shape
        d = inner // self.heads
        split = [t.reshape(b, t.shape[1], self.heads, d).transpose(1, 2) for t in (q, k, v)]
        out = attention(*split).transpose(1, 2).reshape(b, n, inner)
        return self.to_out(out)


class TemporalAttention(CrossAttention):
    """Self-attention over the T frames at each token position: x (B*T, S, C)."""

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        bt, s, c = x.shape
        b, d = bt // t, c // self.heads

        def frames_last(z):  # (B*T, S, C) -> (B, S, H, T, D)
            return z.reshape(b, t, s, self.heads, d).permute(0, 2, 3, 1, 4)

        out = attention(frames_last(self.to_q(x)), frames_last(self.to_k(x)),
                        frames_last(self.to_v(x)))
        return self.to_out(out.permute(0, 3, 1, 2, 4).reshape(bt, s, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QLinear(dim, 2 * inner)


class FeedForward(nn.Module):
    """x -> [value | gate] -> value * gelu(gate) -> Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  QLinear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](value * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, d_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, d_head, context_dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class VideoTransformerBlock(nn.Module):
    """ff_in, self-attention over the frames, attention to the video's
    context (frame 0's), ff; x (B*T, S, C), context (B, L, Ck)."""

    def __init__(self, dim: int, heads: int, d_head: int, context_dim: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.attn1 = TemporalAttention(dim, heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, d_head, context_dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x: torch.Tensor, context: torch.Tensor, t: int) -> torch.Tensor:
        x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x), t) + x
        bt, s, c = x.shape
        # Every token of a video attends to that video's context.
        per_video = self.attn2(self.norm2(x).reshape(bt // t, t * s, c), context)
        x = per_video.reshape(bt, s, c) + x
        return self.ff(self.norm3(x)) + x


class SpatialVideoTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, d_head: int, context_dim: int, merge_factor: float,
                 max_period: int = 10000):
        super().__init__()
        inner = heads * d_head
        self.max_period = max_period
        self.norm = GroupNorm(ch, eps=1e-6)
        self.proj_in = QLinear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, d_head, context_dim)])
        self.time_stack = nn.ModuleList(
            [VideoTransformerBlock(inner, heads, d_head, context_dim)])
        self.time_pos_embed = mlp(ch, 4 * ch, ch)
        self.time_mixer = Blender(merge_factor)
        self.proj_out = QLinear(inner, ch)

    def forward(self, x, context, indicator, t):
        bt, c, h, w = x.shape
        time_context = context[::t]  # frame 0's row of each video
        tokens = self.proj_in(self.norm(x).reshape(bt, c, h * w).transpose(1, 2))
        frames = torch.arange(t, dtype=torch.float32, device=x.device).repeat(bt // t)
        emb = self.time_pos_embed(timestep_embedding(frames, c, self.max_period))[:, None]
        alpha = _blend(self.time_mixer.mix_factor, indicator).reshape(-1)[:, None, None]
        for block, time_block in zip(self.transformer_blocks, self.time_stack):
            tokens = block(tokens, context)
            mixed = time_block(tokens + emb, time_context, t)
            tokens = alpha * tokens + (1.0 - alpha) * mixed
        out = self.proj_out(tokens).transpose(1, 2).reshape(bt, c, h, w)
        return out + x


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = QConv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = QConv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VideoUNet(nn.Module):
    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions, channel_mult,
                 num_head_channels: int, context_dim: int, adm_in_channels: int,
                 video_kernel_size=(3, 1, 1), aux_emb_dim: int = 0, merge_factor: float = 0.5,
                 use_checkpoint: bool = False, **unused):
        super().__init__()
        mc, emb = model_channels, 4 * model_channels
        self.model_channels, self.adm, self.aux = mc, adm_in_channels, aux_emb_dim
        self.use_checkpoint = use_checkpoint
        self.time_embed = mlp(mc, emb, emb)
        self.label_emb = nn.Sequential(mlp(adm_in_channels, emb, emb))
        if aux_emb_dim:
            self.aux_label_emb = mlp(aux_emb_dim, emb, emb)

        def res(c_in, c_out):
            return VideoResBlock(c_in, emb, c_out, video_kernel_size, merge_factor)

        def attn(ch):
            return SpatialVideoTransformer(ch, ch // num_head_channels, num_head_channels,
                                           context_dim, merge_factor)

        self.input_blocks = nn.ModuleList([nn.ModuleList([QConv2d(in_channels, mc, 3,
                                                                  padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                ds *= 2
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    ds //= 2
                    layers.append(Upsample(ch))
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm(ch, silu=True), nn.Identity(),
                                 QConv2d(ch, out_channels, 3, padding=1))

    def _layer(self, layer, h, emb, context, indicator, t):
        if isinstance(layer, VideoResBlock):
            args = (h, emb, indicator, t)
        elif isinstance(layer, SpatialVideoTransformer):
            args = (h, context, indicator, t)
        else:
            return layer(h)
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def forward(self, x, timesteps, context, y, indicator) -> torch.Tensor:
        t = indicator.shape[1]
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        emb = emb + self.label_emb(y[:, :self.adm])
        if self.aux:
            emb = emb + self.aux_label_emb(y[:, self.adm:])
        h, hs = x, []
        for layers in self.input_blocks:
            for layer in layers:
                h = self._layer(layer, h, emb, context, indicator, t)
            hs.append(h)
        for layer in self.middle_block:
            h = self._layer(layer, h, emb, context, indicator, t)
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            for layer in layers:
                h = self._layer(layer, h, emb, context, indicator, t)
        return self.out[2](self.out[0](h))
