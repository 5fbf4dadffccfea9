"""Spatial transformer stack (port of gcd_tpu/models/attention.py).

CrossAttention / TemporalSelfAttention / BasicTransformerBlock /
SpatialTransformer. Self-attention with head dim 64 or 128 goes through K1
(ops/flash_attention.py), temporal self-attention through K2
(ops/temporal_attention.py), the GEGLU MLP through K3. Cross-attention to a
context of more than one token (a text context) and self-attention at other
head dims take ops/basic.py's dot_product_attention, the counterpart of the
JAX package's `_xla_attention`, which JAX takes there too (q and k lengths
differ, or no flash head dim): normalised in fp32, then cast.

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
from gcd_tpu_torch.ops.basic import dot_product_attention
from gcd_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS, flash_attention
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
            return self._leave(flash_attention(q, k, v, self.heads))
        b, sq, inner = q.shape
        qh, kh, vh = (t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
                      for t in (q, k, v))
        out = dot_product_attention(qh, kh, vh)
        return self._leave(out.transpose(1, 2).reshape(b, sq, inner))


class TemporalSelfAttention(_Projections):
    """Self-attention over the T frames of (B*T, S, C) tokens, in that
    layout end to end (K2). Parameter names match CrossAttention."""

    def forward(self, x: torch.Tensor, timesteps: int) -> torch.Tensor:
        x = self._enter(x)
        out = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                 timesteps, self.heads)
        return self._leave(out)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, each pre-LN + residual.
    With `disable_self_attn` attn1 attends to the context as well."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, n_heads, d_head,
                                    context_dim if disable_self_attn else None)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, n_heads, d_head, context_dim)
        self.norm1 = LayerNormFp32(dim)
        self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.attn1(self.norm1(x), context if self.disable_self_attn else None) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


def token_projection(c_in: int, c_out: int, use_linear: bool) -> nn.Module:
    """A transformer's proj_in / proj_out: a Linear on the tokens
    (use_linear), or a 1x1 conv on the image, the reference's two forms
    under one key."""
    return nn.Linear(c_in, c_out) if use_linear else nn.Conv2d(c_in, c_out, 1)


def project_in(proj: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W, C') tokens through proj_in."""
    if isinstance(proj, nn.Conv2d):
        x = proj(x)
    n, c, h, w = x.shape
    tokens = x.reshape(n, c, h * w).transpose(1, 2)
    return proj(tokens) if isinstance(proj, nn.Linear) else tokens


def project_out(proj: nn.Module, tokens: torch.Tensor, hw) -> torch.Tensor:
    """(N, H*W, C') tokens -> (N, C, H, W) through proj_out."""
    if isinstance(proj, nn.Linear):
        tokens = proj(tokens)
    n, _, c = tokens.shape
    x = tokens.transpose(1, 2).reshape(n, c, *hw)
    return proj(x) if isinstance(proj, nn.Conv2d) else x


class SpatialTransformer(nn.Module):
    """GroupNorm + proj-in (linear, or a 1x1 conv without `use_linear`),
    transformer blocks, proj-out, residual. x (N, C, H, W). Not reached by
    a config: the port's default is the linear form of GCD's UNet."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, use_linear: bool = True,
                 disable_self_attn: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = token_projection(in_channels, inner, use_linear)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, disable_self_attn)
            for _ in range(depth))
        self.proj_out = token_projection(inner, in_channels, use_linear)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        tokens = project_in(self.proj_in, self.norm(x))
        for block in self.transformer_blocks:
            tokens = block(tokens, context=context)
        return project_out(self.proj_out, tokens, x.shape[2:]) + x
