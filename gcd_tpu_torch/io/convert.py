"""Weight bridge: flax parameter tree -> torch state dict.

Re-keys and re-orients with the JAX package's numpy-only converter
(gcd_tpu/io/convert.py: flax_path_to_torch_key, torch_layout_from_flax):
Linear (in, out) -> (out, in), conv HWIO -> OIHW, DHWIO -> OIDHW. The port's
modules use the reference's parameter names, so the result loads with
`load_state_dict(..., strict=True)`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gcd_tpu.io.convert import (
    _iter_tree_paths,
    flax_path_to_torch_key,
    torch_layout_from_flax,
)


def state_dict_from_flax(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """`params`: nested dicts of numpy arrays (a flax `params` tree).
    Returns {prefix + torch key: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _iter_tree_paths(params):
        key, kind = flax_path_to_torch_key(path)
        arr = np.ascontiguousarray(torch_layout_from_flax(np.asarray(leaf), kind))
        out[prefix + key] = torch.from_numpy(arr)
    return out
