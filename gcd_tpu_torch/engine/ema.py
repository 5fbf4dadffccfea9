"""Exponential moving average of the UNet's parameters (port of
gcd_tpu/engine/ema.py; the reference is sgm/modules/ema.py LitEma).

The shadow is fp32, one tensor per UNet parameter, updated after every
training step with the warm-up decay min(decay, (1 + n) / (10 + n)), n the
update's number counted from 1, as s - (1 - decay) * (s - p): the JAX
formula, its decay taken in float32 as JAX computes it. The update runs as
three `torch._foreach_*` calls per chunk of about CHUNK_ELEMENTS elements,
so it launches a few multi-tensor kernels a chunk (no Python loop over the
~2,000 tensors) and its temporary (s - p) never exceeds one chunk.

`lit_ema_state_dict` / `load_lit_ema_state_dict` write and read the shadow
under LitEma's names (`model_ema.` + the parameter name without
`model.` and without its dots, with `num_updates` and `decay`), the names
io/checkpoint.py `extract_ema_state_dict` reads back.

Under a mesh (engine/trainer.py) each shadow tensor follows its source's
placement: an fsdp shard or a tensor-parallel share, updated in place from
the rank's master shard; the trainer gathers the shadow whole for a
checkpoint and cuts it again on a load.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcd_tpu_torch.io.checkpoint import EMA_PREFIX

# (parameter name, tensor) -> tensor: a share made whole, or the reverse.
Convert = Callable[[str, torch.Tensor], torch.Tensor]
# Elements of one chunk of the update (256 MiB of fp32 temporary at most).
CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]   # the fp32 shadow by parameter name
    num_updates: int
    decay: float
    chunks: List[Tuple[int, int]]     # [lo, hi) index ranges of the update's chunks


def _chunks(numels: Sequence[int]) -> List[Tuple[int, int]]:
    out, lo, size = [], 0, 0
    for i, n in enumerate(numels):
        if size and size + n > CHUNK_ELEMENTS:
            out.append((lo, i))
            lo, size = i, 0
        size += n
    if lo < len(numels):
        out.append((lo, len(numels)))
    return out


@torch.no_grad()
def ema_init(params: Dict[str, torch.Tensor], decay: float = 0.9999) -> EmaState:
    """A shadow equal to `params` (fp32 copies), no update yet."""
    shadow = {name: p.detach().float().clone() for name, p in params.items()}
    return EmaState(shadow, 0, float(decay), _chunks([p.numel() for p in shadow.values()]))


def update_weight(state: EmaState) -> float:
    """1 - decay of the next update, in float32 as JAX computes it."""
    n = np.float32(state.num_updates + 1)
    decay = np.minimum(np.float32(state.decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
    return float(np.float32(1.0) - decay)


@torch.no_grad()
def ema_update(state: EmaState, new_params: Sequence[torch.Tensor]) -> EmaState:
    """One update towards `new_params` (in the shadow's order; any float
    dtype), in place; returns `state`."""
    one_minus = update_weight(state)
    shadow = list(state.params.values())
    for lo, hi in state.chunks:
        diff = torch._foreach_sub(shadow[lo:hi], list(new_params[lo:hi]))
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(shadow[lo:hi], diff)
        del diff
    state.num_updates += 1
    return state


def lit_ema_key(name: str) -> str:
    """LitEma's key of parameter `name` (`model.diffusion_model.x.0.w` ->
    `model_ema.diffusion_modelx0w`)."""
    return EMA_PREFIX + name[len("model."):].replace(".", "")


def lit_ema_state_dict(state: EmaState, whole: Optional[Convert] = None
                       ) -> Dict[str, torch.Tensor]:
    """The shadow under LitEma's names, with its two bookkeeping buffers;
    `whole(name, shadow)` makes each whole first (the trainer gathers a
    mesh's shares)."""
    out = {lit_ema_key(name): whole(name, s) if whole else s
           for name, s in state.params.items()}
    out[EMA_PREFIX + "num_updates"] = torch.tensor(state.num_updates, dtype=torch.int32)
    out[EMA_PREFIX + "decay"] = torch.tensor(state.decay, dtype=torch.float32)
    return out


@torch.no_grad()
def load_lit_ema_state_dict(state: EmaState, sd: Dict[str, torch.Tensor],
                            share: Optional[Convert] = None) -> None:
    """Copy a lit_ema_state_dict() into `state`, each tensor through
    `share(name, whole)` when given (a mesh's share); raises on a missing
    key."""
    for name, s in state.params.items():
        saved = sd[lit_ema_key(name)]
        s.copy_(share(name, saved) if share else saved)
    state.num_updates = int(sd[EMA_PREFIX + "num_updates"])
    state.decay = float(sd[EMA_PREFIX + "decay"])
