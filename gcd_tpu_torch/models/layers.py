"""Core building blocks (port of gcd_tpu/models/layers.py).

Layout is torch's: images (N, C, H, W), videos (B, C, T, H, W), tokens
(N, S, C). Matmuls and convs run in the parameter dtype (bf16 on the card);
GroupNorm and LayerNorm reduce in fp32 and cast back, the fp32 islands the
published checkpoints depend on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.ops.fused_mlp import geglu_mlp
from gcd_tpu_torch.ops.fused_norm import group_norm
from gcd_tpu_torch.parallel.tensor import copy_to_tensor_group, row_parallel_out


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32 with an optional fused SiLU: K4 on CUDA
    (ops/fused_norm.py). Given a `stats_group` (a time_stack block's frame
    group, parallel/frames.py), x is this rank's share of the positions
    and the statistics are summed over the group's ranks."""

    def __init__(self, channels: int, eps: float = 1e-5, silu: bool = False,
                 num_groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.silu, self.num_groups = eps, silu, num_groups

    def forward(self, x: torch.Tensor, stats_group=None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                          self.silu, stats_group)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32, cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class GEGLUProj(nn.Module):
    """Holds the GEGLU up-projection (C -> 2*inner, value rows then gate
    rows) under the reference's name `proj`."""

    def __init__(self, dim_in: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU transformer MLP (reference FeedForward with glu=True), run as
    one fused call: K3 on CUDA. Keys net.0.proj / net.2 as in the reference.

    Cut over `tp_group` (parallel/tensor.py), rank r holds the r-th share of
    the value rows and of the gate rows of net.0.proj, [value_r | gate_r],
    and the matching input columns of net.2: K3 computes only the rank's
    columns of h and its partial down product, which is summed over the
    group before net.2's bias is added. This is JAX's row cut of net_2
    (gcd_tpu/parallel/mesh.py:106,120); JAX leaves the fused [value | gate]
    projection uncut (each half would land on one shard), but each rank
    needs only its columns of both halves, so the port cuts it as well."""

    tp_group = None

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLUProj(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim_out or dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up, down = self.net[0].proj, self.net[2]
        if self.tp_group is None:
            return geglu_mlp(x, up.weight, up.bias, down.weight, down.bias)
        x = copy_to_tensor_group(x, self.tp_group)
        partial = geglu_mlp(x, up.weight, up.bias, down.weight, torch.zeros_like(down.bias))
        return row_parallel_out(partial, down.bias, self.tp_group, x.dtype)


class AlphaBlender(nn.Module):
    """Learned mix of a spatial and a temporal branch
    (merge_strategy "learned" or "learned_with_images", the ones GCD's
    configs use): alpha * x_spatial + (1 - alpha) * x_temporal."""

    def __init__(self, alpha: float = 0.5, merge_strategy: str = "learned_with_images"):
        super().__init__()
        if merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(f"unsupported merge strategy {merge_strategy!r}")
        self.merge_strategy = merge_strategy
        self.mix_factor = nn.Parameter(torch.full((1,), float(alpha)))

    def get_alpha(self, image_only_indicator: Optional[torch.Tensor]) -> torch.Tensor:
        """Scalar alpha, or (B, T) for learned_with_images."""
        mix = torch.sigmoid(self.mix_factor)
        if self.merge_strategy == "learned":
            return mix[0]
        if image_only_indicator is None:
            raise ValueError("learned_with_images needs image_only_indicator")
        return torch.where(image_only_indicator.bool(), torch.ones_like(mix[0]), mix[0])

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
        """`alpha` is get_alpha(...) already shaped to broadcast."""
        alpha = alpha.to(x_spatial.dtype)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal
