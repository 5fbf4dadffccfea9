"""Build a DiffusionEngine from a config and put it on a device.

    engine = load_engine("configs/infer_kubric.yaml")            # card, bf16
    engine = load_engine(path, state_dict=sd)                    # released weights
    engine = load_engine(path, device="cpu", dtype=torch.float32)

The engine is built on the meta device (no memory, no init compute) and
materialised on the target device in `dtype`. There is no CPU fallback: with
no CUDA device the default raises, and the CPU is used only when asked for.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from gcd_tpu_torch.engine.engine import DiffusionEngine
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

# Random weights when no state dict is given: N(0, RANDOM_STD) on every
# parameter, from a generator seeded with RANDOM_SEED on the target device.
RANDOM_STD = 0.02
RANDOM_SEED = 1


def load_engine(config_path: str, device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16,
                state_dict: Optional[Dict[str, torch.Tensor]] = None) -> DiffusionEngine:
    """The engine of `config_path`'s `model` section on `device` (CUDA when
    None), in eval mode. `state_dict` (the reference checkpoint's key space)
    is loaded with strict=True; without one the weights are seeded random."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_engine: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    with torch.device("meta"):
        engine = instantiate_from_config(load_config(config_path)["model"])
    engine = engine.to(dtype).to_empty(device=device).eval()
    if state_dict is not None:
        engine.load_state_dict(state_dict, strict=True)
    else:
        gen = torch.Generator(device).manual_seed(RANDOM_SEED)
        with torch.no_grad():
            for p in engine.parameters():
                p.normal_(0.0, RANDOM_STD, generator=gen)
    return engine
