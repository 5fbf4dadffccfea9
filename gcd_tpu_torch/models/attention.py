"""Spatial transformer stack (port of gcd_tpu/models/attention.py).

CrossAttention / TemporalSelfAttention / BasicTransformerBlock /
SpatialTransformer. Self-attention with head dim 64 or 128 goes through K1
(ops/flash_attention.py), temporal self-attention through K2
(ops/temporal_attention.py), the GEGLU MLP through K3.

Under tensor parallelism (parallel/tensor.py `cut_unet`) an attention
layer whose heads divide by the tensor size holds its rank's heads of
to_q / to_k / to_v and the matching input columns of to_out.0, and
`tp_group` is set: its inputs enter through `copy_to_tensor_group`, K1 /
K6 / K2 run on the local heads, and to_out.0's partial product is summed
over the group before its bias is added.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gcd_tpu_torch.models.layers import FeedForward, GroupNorm32, LayerNormFp32
from gcd_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
    flash_attention_plain,
)
from gcd_tpu_torch.ops.temporal_attention import temporal_attention
from gcd_tpu_torch.parallel.tensor import copy_to_tensor_group, row_parallel_linear


class _Projections(nn.Module):
    """to_q / to_k / to_v (no bias) and to_out.0, the reference's names;
    `heads` local heads, all of them unless the layer is cut over
    `tp_group`."""

    tp_group = None

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def _enter(self, t: torch.Tensor) -> torch.Tensor:
        """An input of the projections (its gradient summed over the tensor
        group when the layer is cut)."""
        return t if self.tp_group is None else copy_to_tensor_group(t, self.tp_group)

    def _leave(self, out: torch.Tensor) -> torch.Tensor:
        """to_out on the heads' output (summed over the tensor group when
        the layer is cut)."""
        if self.tp_group is None:
            return self.to_out(out)
        return row_parallel_linear(out, self.to_out[0], self.tp_group)


class CrossAttention(_Projections):
    """Multi-head attention; self-attention when `context` is None.
    x (B, S, C), context (B, L, Ck)."""

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if context is not None and context.shape[1] == 1:
            # Softmax over one key is identically 1: every query gets
            # to_out(to_v(ctx)). Returned as (B, 1, C) for the residual add to
            # broadcast; to_q / to_k stay registered so checkpoints load.
            return self._leave(self.to_v(self._enter(context.to(x.dtype))))
        x = self._enter(x)
        ctx = x if context is None else self._enter(context.to(x.dtype))
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if context is None and self.dim_head in KERNEL_HEAD_DIMS:
            out = flash_attention(q, k, v, self.heads)
        else:
            out = flash_attention_plain(q, k, v, self.heads)
        return self._leave(out)


class TemporalSelfAttention(_Projections):
    """Self-attention over the T frames of (B*T, S, C) tokens, in that
    layout end to end (K2). Parameter names match CrossAttention."""

    def forward(self, x: torch.Tensor, timesteps: int) -> torch.Tensor:
        x = self._enter(x)
        out = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                 timesteps, self.heads)
        return self._leave(out)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, each pre-LN + residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, n_heads, d_head, context_dim)
        self.norm1 = LayerNormFp32(dim)
        self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm + linear proj-in, transformer blocks, linear proj-out,
    residual (the use_linear=True form GCD's UNet uses). x (N, C, H, W)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        n, c, h, w = x.shape
        tokens = self.proj_in(self.norm(x).reshape(n, c, h * w).transpose(1, 2))
        for block in self.transformer_blocks:
            tokens = block(tokens, context=context)
        out = self.proj_out(tokens).transpose(1, 2).reshape(n, c, h, w)
        return out + x
