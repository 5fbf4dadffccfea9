"""Build a DiffusionEngine from a config and put it on a device.

    engine = load_engine("configs/infer_kubric.yaml")            # card, bf16
    engine = load_engine(path, state_dict=sd)                    # released weights, strict
    engine = load_engine(path, device="cpu", dtype=torch.float32)

The engine is built on the meta device (no memory, no init compute) and
materialised on the target device in `dtype`. There is no CPU fallback: with
no CUDA device the default raises, and the CPU is used only when asked for.
The weights of the 2D ResBlocks' 3x3 convs are built in channels_last memory,
the layout K7 reads in place (models/resblock.py); the dtype cast, the
materialisation and load_state_dict's copies all keep it. LoRA adapters
(`ft_strategy: time_lora`) start at LoRA's own initialisation, B = 0
(models/lora.py), unless the state dict holds them.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from gcd_tpu_torch.engine.engine import DiffusionEngine
from gcd_tpu_torch.models.lora import init_adapters
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config

# Random weights when no state dict is given: N(0, RANDOM_STD) on every
# parameter, from a generator seeded with RANDOM_SEED on the target device.
RANDOM_STD = 0.02
RANDOM_SEED = 1


def load_engine(config_path: str, device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16,
                state_dict: Optional[Dict[str, torch.Tensor]] = None) -> DiffusionEngine:
    """The engine of `config_path`'s `model` section (engine_from_config),
    with `state_dict` loaded strictly."""
    return engine_from_config(load_config(config_path)["model"], device, dtype, state_dict)


def engine_from_config(model_config: Dict, device: Optional[Union[str, torch.device]] = None,
                       dtype: torch.dtype = torch.bfloat16,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       strict: bool = True) -> DiffusionEngine:
    """The engine of a config's `model` section on `device` (CUDA when
    None), in eval mode. Without `state_dict` the weights are seeded random
    (the adapters LoRA's initialisation).
    `state_dict` (the reference checkpoint's key space) is loaded with
    `strict`. Only a released checkpoint (engine/bundle.py) loads non-strictly:
    the keys it lacks keep the seeded random weights, the keys the engine
    lacks are ignored, and both are printed and kept as
    `engine.missing_keys` / `unexpected_keys`, as gcd_tpu's
    load_torch_checkpoint reports them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_engine: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    with torch.device("meta"):
        engine = instantiate_from_config(model_config)
    engine = engine.to(dtype).to_empty(device=device).eval()
    if state_dict is None or not strict:
        gen = torch.Generator(device).manual_seed(RANDOM_SEED)
        with torch.no_grad():
            for p in engine.parameters():
                p.normal_(0.0, RANDOM_STD, generator=gen)
        init_adapters(engine, gen)
    if state_dict is not None:
        result = engine.load_state_dict(state_dict, strict=strict)
        engine.missing_keys, engine.unexpected_keys = result.missing_keys, result.unexpected_keys
        if not strict:
            print(f"Restored with {len(result.missing_keys)} missing and "
                  f"{len(result.unexpected_keys)} unexpected keys")
            if result.missing_keys:
                print(f"First 10 missing: {result.missing_keys[:10]}")
            if result.unexpected_keys:
                print(f"First 5 unexpected: {sorted(result.unexpected_keys)[:5]}")
    return engine
