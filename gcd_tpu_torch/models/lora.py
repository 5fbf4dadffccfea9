"""LoRA adapters for `ft_strategy: time_lora` (port of gcd_tpu/models/lora.py;
the reference wraps every nn.Linear under a "time" name with a rank-16
peft adapter, diffusion.py:134-155).

The targets are the UNet's nn.Linear modules with a "time" segment in their
name (the time_stack attention and feed-forward projections, the
time_stack's emb_layers, time_pos_embed and time_embed): JAX's
`lora_target_paths`, the rank-2 Dense kernels whose flax path holds
"time", in the port's key space. Each target becomes a LoRALinear holding
`lora_a` (in, r) and `lora_b` (r, out), JAX's layout, beside its frozen
base `weight`, so the base keeps its reference key and the adapters are
`<module>.lora_a` / `.lora_b` (io/convert.py carries JAX's `params["lora"]`
tree onto them unchanged).

The merge is in weight space, as `apply_lora`: the module's `weight` reads
as base + (A @ B)^T, computed anew at every read. K3 and K2's projections
therefore receive the merged weight, autograd takes its gradient to A and
B, and a rematerialised block's recompute reads the same merge, never a
weight kept from an earlier step.

Under tensor parallelism (parallel/tensor.py) the adapter of a cut
projection is cut with it: B (r, out) on `out` for a column cut, A (in, r)
on `in` for a row cut, the other factor whole (its gradient summed over
the group, `copy_to_tensor_group`), so each rank merges its share of the
merged full weight and `merge_lora_state_dict` on the gathered checkpoint
gives the same full weight.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from gcd_tpu_torch.parallel.tensor import copy_to_tensor_group

RANK = 16
MATCH = "time"
ADAPTER_SUFFIXES = (".lora_a", ".lora_b")


def merged_weight(weight: torch.Tensor, lora_a: torch.Tensor,
                  lora_b: torch.Tensor) -> torch.Tensor:
    """weight (out, in) + (lora_a @ lora_b)^T in weight's dtype, contiguous."""
    return weight + torch.mm(lora_b.t(), lora_a.t()).to(weight.dtype)


class LoRALinear(nn.Linear):
    """An nn.Linear whose `weight` is its base merged with its adapter. The
    base stays the registered parameter `weight`. Sharded by FSDP, the base
    is a DTensor shard outside the forward, and `weight` reads as that
    parameter itself (FSDP2 reads its parameters back by name); inside the
    forward FSDP registers the gathered base, which merges as above."""

    # Set when the projection is cut over a tensor group: the name of the
    # factor every rank holds whole, whose gradient is the sum of the ranks'.
    tp_group = None
    tp_whole = None

    @property
    def weight(self) -> torch.Tensor:
        base = self._parameters["weight"]
        if isinstance(base, DTensor):
            return base
        a, b = self.lora_a, self.lora_b
        if self.tp_group is not None:
            if self.tp_whole == "lora_a":
                a = copy_to_tensor_group(a, self.tp_group)
            else:
                b = copy_to_tensor_group(b, self.tp_group)
        return merged_weight(base, a, b)


def is_adapter(name: str) -> bool:
    return name.endswith(ADAPTER_SUFFIXES)


def lora_target_names(module: nn.Module) -> List[str]:
    """Names of the nn.Linear modules of `module` with a segment holding MATCH."""
    return [name for name, m in module.named_modules()
            if type(m) is nn.Linear and any(MATCH in seg for seg in name.split("."))]


def add_lora(module: nn.Module) -> List[str]:
    """Turn the targets of `module` into LoRALinear with (uninitialised)
    rank-RANK adapters, on the targets' device and dtype; returns their
    names."""
    names = lora_target_names(module)
    for name in names:
        linear = module.get_submodule(name)
        base = linear._parameters["weight"]
        linear.__class__ = LoRALinear
        linear.register_parameter("lora_a", nn.Parameter(base.new_empty(
            (linear.in_features, RANK))))
        linear.register_parameter("lora_b", nn.Parameter(base.new_empty(
            (RANK, linear.out_features))))
    return names


@torch.no_grad()
def init_adapters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """LoRA's initialisation (init_lora_params): A ~ N(0, 1 / in), B = 0, so
    the adapted module starts equal to its base."""
    for m in module.modules():
        if isinstance(m, LoRALinear):
            m.lora_a.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
            m.lora_b.zero_()


def merge_lora_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict with every adapter pair merged into its base weight
    (merged_weight) and the adapter keys dropped; `sd` itself is unchanged.
    A dict without adapters comes back as it is."""
    heads = [k[:-len(".lora_a")] for k in sd if k.endswith(".lora_a")]
    if not heads:
        return sd
    out = {k: v for k, v in sd.items() if not is_adapter(k)}
    for head in heads:
        out[f"{head}.weight"] = merged_weight(sd[f"{head}.weight"], sd[f"{head}.lora_a"],
                                              sd[f"{head}.lora_b"])
    return out
