"""Shared helpers for the gcd_tpu_torch parity tests (tests/test_torch_*.py).

A flax module's parameter tree is filled with seeded numpy values (no flax
init compile), carried into the port's torch module with
gcd_tpu_torch.io.convert.state_dict_from_flax and loaded with strict=True,
so every parameter of the torch module is checked to have a flax source.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import jax
import numpy as np
import torch

from gcd_tpu_torch.io.convert import state_dict_from_flax

# Same tiny sizes as tests/test_parity_torch.py.
TINY_UNET = dict(
    in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1,
    attention_resolutions=[2, 1], channel_mult=[1, 2], num_head_channels=16,
    transformer_depth=1, context_dim=24, use_linear_in_transformer=True,
    extra_ff_mix_layer=True, use_spatial_context=True,
    merge_strategy="learned_with_images", video_kernel_size=[3, 1, 1],
    num_classes="sequential", adm_in_channels=20, aux_emb_dim=6,
)
TINY_DD = dict(
    ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16],
    z_channels=4, double_z=True, in_channels=3, out_ch=3, resolution=32,
    dropout=0.0,
)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def fill_params(tree: Mapping, seed: int) -> Dict[str, Any]:
    """Seeded numpy values for a flax param tree of shapes: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1), other
    leaves (mix factors) N(0, 0.5). Nothing is zero, so no branch of the
    forward is vacuous."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            val = node[key]
            if isinstance(val, Mapping):
                out[key] = walk(val)
                continue
            shape = tuple(val.shape)
            if key == "kernel":
                arr = rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape)
            elif key == "scale":
                arr = 1.0 + 0.1 * rng.normal(size=shape)
            elif key == "bias":
                arr = 0.1 * rng.normal(size=shape)
            else:
                arr = 0.5 * rng.normal(size=shape)
            out[key] = arr.astype(np.float32)
        return out

    return walk(tree)


def flax_params(module, seed: int, *args, **kwargs) -> Dict[str, Any]:
    """Seeded values for `module`'s params at the given call signature."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))["params"]
    return fill_params(shapes, seed)


def load_port(module: torch.nn.Module, params: Dict[str, Any]) -> torch.nn.Module:
    """Load a flax param tree into a port module, strict=True."""
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)
