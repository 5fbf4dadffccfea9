"""Tensor parallelism: Megatron's cut of the attention and feed-forward
projections, written by hand (the port's counterpart of the tensor axis of
gcd_tpu/parallel/mesh.py, where GSPMD inserts the collectives).

The kernels take plain tensors through ctypes, and FeedForward never calls
nn.Linear.forward, so DTensor's `parallelize_module` styles cannot reach
them. Instead `cut_unet` slices a built UNet's weights in place to the
rank's share (parallel/mesh.py's placements) and gives each cut module its
tensor group; the modules then run

    x -> copy_to_tensor_group -> [rank's columns / heads] ->
        row projection without bias -> reduce_from_tensor_group -> + bias

so every rank of the group holds the same activations between blocks, one
all-reduce a cut layer in the forward and one in the backward, as Megatron's
f and g operators. The reduction is taken in fp32 and the replicated bias
added after it, in fp32, before the one rounding to the activation dtype
(JAX keeps the row bias replicated, mesh.py:120-125).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.parallel.mesh import FF_DOWN, REPLICATED, Placement, shard_blocks


class _CopyToTensorGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTensorGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTensorGroup.apply(x, group)


def reduce_from_tensor_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTensorGroup.apply(x, group)


def row_parallel_out(partial: torch.Tensor, bias: Optional[torch.Tensor], group,
                     dtype: torch.dtype) -> torch.Tensor:
    """The rank's partial product of a row-cut projection summed over the
    group in fp32, plus the replicated bias, rounded once to `dtype`."""
    out = reduce_from_tensor_group(partial.float(), group)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def row_parallel_linear(h: torch.Tensor, linear: nn.Linear, group) -> torch.Tensor:
    """`linear` (a row-cut nn.Linear: the rank's input columns, the whole
    bias) on the rank's share h of its input."""
    return row_parallel_out(F.linear(h, linear.weight), linear.bias, group, h.dtype)


@torch.no_grad()
def cut_unet(unet: nn.Module, placements: Dict[str, Placement], rank: int, size: int,
             group) -> Dict[str, int]:
    """Slice `unet`'s parameters that `placements` cuts over the tensor axis
    (by name under the UNet; a name it lacks is replicated) to rank
    `rank`'s share of `size`, in place (new contiguous Parameters of
    the same dtype and requires_grad), divide the heads of each cut
    attention layer by `size` and give each cut attention layer and
    feed-forward the tensor `group`. Returns {module name: heads or inner
    size before the cut} of the cut modules."""
    cut = {}
    for name, m in unet.named_modules():
        prefix = f"{name}." if name else ""
        if hasattr(m, "to_q") and hasattr(m, "heads"):
            if placements.get(f"{prefix}to_q.weight", REPLICATED).tensor_dim is not None:
                cut[name] = m.heads
                m.heads //= size
                m.tp_group = group
        elif hasattr(m, "net") and hasattr(m.net[0], "proj"):
            if placements.get(f"{prefix}{FF_DOWN}.weight", REPLICATED).tensor_dim is not None:
                cut[name] = m.net[2].in_features
                m.tp_group = group
    for name, p in list(unet.named_parameters()):
        pl = placements.get(name, REPLICATED)
        if pl.tensor_dim is None:
            continue
        module_name, _, leaf = name.rpartition(".")
        module = unet.get_submodule(module_name)
        share = shard_blocks(p.detach(), pl.tensor_dim, pl.tensor_blocks, rank, size)
        module._parameters[leaf] = nn.Parameter(share, requires_grad=p.requires_grad)
        if isinstance(module, nn.Linear) and leaf == "weight":
            module.out_features, module.in_features = share.shape
        if leaf in ("lora_a", "lora_b"):  # a LoRA adapter: the other factor stays whole
            module.tp_group = group
            module.tp_whole = "lora_b" if leaf == "lora_a" else "lora_a"
    return cut

