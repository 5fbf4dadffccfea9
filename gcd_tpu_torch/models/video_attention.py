"""Temporal transformer stack (port of gcd_tpu/models/video_attention.py).

VideoTransformerBlock attends over the T frames at every spatial position
with tokens kept in the (B*T, S, C) layout (K2 for self-attention);
SpatialVideoTransformer pairs each spatial BasicTransformerBlock with one,
plus the learned frame-position embedding and the AlphaBlender merge.

Under a frame group (parallel/frames.py) a SpatialVideoTransformer holds
T / F frames of its videos: the spatial blocks run on them, and each
temporal block's input, `tokens + emb` formed with the rows' global frame
indices, is re-laid to all T frames at 1 / F of the positions
(frames_to_rows) and its output back (rows_to_frames); the temporal
blocks' per-video context is frame 0's row of the conditioning, which
covers every frame.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gcd_tpu_torch.models.attention import (
    BasicTransformerBlock,
    CrossAttention,
    TemporalSelfAttention,
)
from gcd_tpu_torch.models.layers import (
    AlphaBlender,
    FeedForward,
    GroupNorm32,
    LayerNormFp32,
)
from gcd_tpu_torch.ops.basic import timestep_embedding
from gcd_tpu_torch.parallel.frames import (
    current_frame_group,
    frames_to_rows,
    local_frames,
    rows_to_frames,
)


class VideoTransformerBlock(nn.Module):
    """Temporal block: [ff_in] -> temporal self-attn -> cross-attn to a
    per-video context -> FF. x (B*T, S, C); context (B, L, Ck). Built
    without a context_dim (the VAE's VideoAttnBlock), attn2 is a second
    temporal self-attention and forward takes context None, as the JAX
    block's attn2 self-attends over the frames when it gets no context."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, ff_in: bool = False):
        super().__init__()
        if ff_in:
            self.norm_in = LayerNormFp32(dim)
            self.ff_in = FeedForward(dim)
        self.attn1 = TemporalSelfAttention(dim, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = (TemporalSelfAttention(dim, n_heads, d_head) if context_dim is None
                      else CrossAttention(dim, n_heads, d_head, context_dim))
        self.norm1 = LayerNormFp32(dim)
        self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], timesteps: int
                ) -> torch.Tensor:
        t = timesteps
        bt, s, c = x.shape
        b = bt // t
        if hasattr(self, "ff_in"):
            x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x), timesteps=t) + x
        if context is None:
            x = self.attn2(self.norm2(x), timesteps=t) + x
            return self.ff(self.norm3(x)) + x
        # Context keys are per video, so attending from the (B, T*S, C) view
        # is the reference's per-pixel temporal cross-attention.
        h = self.attn2(self.norm2(x).reshape(b, t * s, c), context=context)
        if h.shape[1] == 1:
            h = h.repeat_interleave(t, dim=0)  # one-key shortcut: (B*T, 1, C)
        else:
            h = h.reshape(bt, s, c)
        x = h + x
        return self.ff(self.norm3(x)) + x


class SpatialVideoTransformer(nn.Module):
    """Spatial transformer with an interleaved temporal stack
    (use_linear=True, use_spatial_context=True as in GCD's UNet).
    x (B*T, C, H, W), context (B*T, L, Ck), indicator (B, T); under a
    frame group x holds this rank's T / F frames of each video and the
    indicator its columns, while context covers all T."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, ff_in: bool = False,
                 merge_strategy: str = "learned_with_images",
                 merge_factor: float = 0.5, max_time_embed_period: int = 10000):
        super().__init__()
        inner = n_heads * d_head
        self.in_channels = in_channels
        self.max_time_embed_period = max_time_embed_period
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, n_heads, d_head, context_dim, ff_in=ff_in)
            for _ in range(depth))
        self.time_pos_embed = nn.Sequential(
            nn.Linear(in_channels, 4 * in_channels), nn.SiLU(),
            nn.Linear(4 * in_channels, in_channels))
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor, timesteps: int,
                image_only_indicator: torch.Tensor) -> torch.Tensor:
        bt, c, h, w = x.shape
        t = timesteps
        fg = current_frame_group()
        first, frames = (0, t) if fg is None else (fg.offset, fg.local)
        time_context = context[::t]  # one context row per video (frame 0)
        context = local_frames(context, t, fg)

        tokens = self.proj_in(self.norm(x).reshape(bt, c, h * w).transpose(1, 2))

        frame_idx = torch.arange(first, first + frames, dtype=torch.float32,
                                 device=x.device).repeat(bt // frames)
        t_emb = timestep_embedding(frame_idx, c, self.max_time_embed_period).to(x.dtype)
        emb = self.time_pos_embed(t_emb)[:, None, :]  # (B*T, 1, C)

        alpha = self.time_mixer.get_alpha(image_only_indicator)
        if alpha.dim():
            alpha = alpha.reshape(-1)[:, None, None]
        for block, time_block in zip(self.transformer_blocks, self.time_stack):
            tokens = block(tokens, context=context)
            mixed = time_block(frames_to_rows(tokens + emb, fg), context=time_context,
                               timesteps=t)
            tokens = self.time_mixer(tokens, rows_to_frames(mixed, fg), alpha)

        out = self.proj_out(tokens).transpose(1, 2).reshape(bt, c, h, w)
        return out + x
