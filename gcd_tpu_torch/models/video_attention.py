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
blocks' per-video context (frame 0's row of the conditioning, or the
time context) covers every frame.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gcd_tpu_torch.models.attention import (
    BasicTransformerBlock,
    CrossAttention,
    TemporalSelfAttention,
    project_in,
    project_out,
    token_projection,
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
    """Temporal block: [ff_in] -> temporal self-attn -> attention to a
    per-video context -> FF. x (B*T, S, C); context (B, L, Ck).

    `context_dim` says whether the block gets a context: built without one
    (the VAE's VideoAttnBlock, a UNet without a per-video context), the
    layers that attend to the context are temporal self-attentions of the
    block's width instead (K2), as the JAX block's are when it is called
    without a context (its attn2 then self-attends over the frames; sgm
    would size its to_k / to_v by context_dim); such a block refuses a
    context, which the JAX block would attend to. `disable_self_attn` makes
    attn1 such a layer too; `disable_temporal_crossattention` drops norm2
    and attn2."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, ff_in: bool = False,
                 disable_self_attn: bool = False,
                 disable_temporal_crossattention: bool = False):
        super().__init__()

        def to_context():
            return (TemporalSelfAttention(dim, n_heads, d_head) if context_dim is None
                    else CrossAttention(dim, n_heads, d_head, context_dim))

        if ff_in:
            self.norm_in = LayerNormFp32(dim)
            self.ff_in = FeedForward(dim)
        self.disable_self_attn = disable_self_attn
        self.attn1 = to_context() if disable_self_attn else TemporalSelfAttention(
            dim, n_heads, d_head)
        self.ff = FeedForward(dim)
        if not disable_temporal_crossattention:
            self.attn2 = to_context()
        self.norm1 = LayerNormFp32(dim)
        if not disable_temporal_crossattention:
            self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)

    @staticmethod
    def _attend(attn: nn.Module, h: torch.Tensor, context: Optional[torch.Tensor],
                t: int) -> torch.Tensor:
        """A layer that attends to the context (or over the frames, built
        without one)."""
        if isinstance(attn, TemporalSelfAttention):
            if context is not None:
                raise ValueError("a temporal block built without a context width (a "
                                 "VideoUNet's time_context_dim) got a context to attend to")
            return attn(h, timesteps=t)
        if context is None:
            raise ValueError("a temporal block built with a context_dim needs a context")
        bt, s, c = h.shape
        # Context keys are per video, so attending from the (B, T*S, C) view
        # is the reference's per-pixel temporal cross-attention.
        out = attn(h.reshape(bt // t, t * s, c), context=context)
        if out.shape[1] == 1:
            return out.repeat_interleave(t, dim=0)  # one-key shortcut: (B*T, 1, C)
        return out.reshape(bt, s, c)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], timesteps: int
                ) -> torch.Tensor:
        t = timesteps
        if hasattr(self, "ff_in"):
            x = self.ff_in(self.norm_in(x)) + x
        h = self.norm1(x)
        x = (self._attend(self.attn1, h, context, t) if self.disable_self_attn
             else self.attn1(h, timesteps=t)) + x
        if hasattr(self, "attn2"):
            x = self._attend(self.attn2, self.norm2(x), context, t) + x
        return self.ff(self.norm3(x)) + x


class SpatialVideoTransformer(nn.Module):
    """Spatial transformer with an interleaved temporal stack. x (B*T, C, H,
    W), context (B*T, L, Ck), indicator (B, T); under a frame group x holds
    this rank's T / F frames of each video and the indicator its columns,
    while context covers all T.

    The temporal blocks' per-video context is frame 0's row of `context`
    with `use_spatial_context`; otherwise `time_context` ((B, Ck) or (B, L,
    Ck)), for which the blocks are built only when `time_context_dim` is
    given (torch builds the layers before the call; the JAX package sizes
    them from the first call's context), and none without it.
    `use_linear=False` makes proj_in / proj_out 1x1 convs;
    `disable_self_attn` and `disable_temporal_crossattention` reach the
    spatial and temporal blocks as in the JAX package."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, ff_in: bool = False,
                 merge_strategy: str = "fixed", merge_factor: float = 0.5,
                 max_time_embed_period: int = 10000, use_spatial_context: bool = False,
                 use_linear: bool = False, disable_self_attn: bool = False,
                 disable_temporal_crossattention: bool = False,
                 time_context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.in_channels = in_channels
        self.max_time_embed_period = max_time_embed_period
        self.use_spatial_context = use_spatial_context
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = token_projection(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, disable_self_attn)
            for _ in range(depth))
        time_dim = context_dim if use_spatial_context else time_context_dim
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, n_heads, d_head, time_dim, ff_in=ff_in,
                                  disable_self_attn=disable_self_attn,
                                  disable_temporal_crossattention=disable_temporal_crossattention)
            for _ in range(depth))
        self.time_pos_embed = nn.Sequential(
            nn.Linear(in_channels, 4 * in_channels), nn.SiLU(),
            nn.Linear(4 * in_channels, in_channels))
        self.time_mixer = AlphaBlender(merge_factor, merge_strategy)
        self.proj_out = token_projection(inner, in_channels, use_linear)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor], timesteps: int,
                image_only_indicator: torch.Tensor,
                time_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        bt, c, h, w = x.shape
        t = timesteps
        fg = current_frame_group()
        first, frames = (0, t) if fg is None else (fg.offset, fg.local)
        if self.use_spatial_context:
            time_context = context[::t]  # one context row per video (frame 0)
        elif time_context is not None and time_context.dim() == 2:
            time_context = time_context[:, None, :]
        context = None if context is None else local_frames(context, t, fg)

        tokens = project_in(self.proj_in, self.norm(x))

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

        return project_out(self.proj_out, tokens, (h, w)) + x
