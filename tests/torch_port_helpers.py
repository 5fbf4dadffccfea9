"""Shared helpers for the gcd_tpu_torch parity tests (tests/test_torch_*.py).

A flax module's parameter tree is filled with seeded numpy values (no flax
init compile), carried into the port's torch module with
gcd_tpu_torch.io.convert.state_dict_from_flax and loaded with strict=True,
so every parameter of the torch module is checked to have a flax source.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gcd_tpu_torch.io.convert import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The whole tiny engine: tiny UNet, VAE and conditioner (CLIP width 32).
TINY_CONFIG = os.path.join(REPO, "configs", "smoke_kubric_tiny.yaml")

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


def tiny_batch(t: int, h: int, w: int, seed: int) -> Dict[str, np.ndarray]:
    """A JAX-layout inference batch (engine.py example_batch) of one t-frame
    video: frames in [-1, 1], the noised copy in cond_frames."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1.0, 1.0, (t, h, w, 3)).astype(np.float32)
    return {
        "cond_frames": (frames + 0.02 * rng.normal(size=frames.shape)).astype(np.float32),
        "cond_frames_without_noise": frames,
        "cond_aug": np.full((t,), 0.02, np.float32),
        "fps_id": np.full((t,), 5.0, np.float32),
        "motion_bucket_id": np.full((t,), 127.0, np.float32),
        "scaled_relative_angles": rng.normal(size=(t, 3)).astype(np.float32),
        "image_only_indicator": np.zeros((1, t), np.float32),
    }


def kl_decoder_state_dict(ddconfig: Mapping, seed: int,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """The 2D decoder and post_quant_conv that an AutoencoderKLModeOnly holds
    and the JAX conditioner does not: seeded values through the JAX
    Decoder's param tree."""
    from gcd_tpu.models.vae import Decoder as JDecoder

    dd = {k: v for k, v in ddconfig.items() if k not in ("attn_type", "lossconfig")}
    z = dd["z_channels"]
    side = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
    dec = flax_params(JDecoder(**dd), seed, jnp.zeros((1, side, side, z)))
    post = fill_params({"kernel": np.zeros((1, 1, z, z)), "bias": np.zeros((z,))}, seed + 1)
    return state_dict_from_flax({"decoder": dec, "post_quant_conv": post}, prefix)


def conditioner_extras(emb_models: Sequence[Mapping], seed: int,
                       prefix: str = "conditioner.") -> Dict[str, torch.Tensor]:
    """kl_decoder_state_dict for every frame-encoder embedder of a config."""
    out: Dict[str, torch.Tensor] = {}
    for i, cfg in enumerate(emb_models):
        if cfg["target"].endswith("VideoPredictionEmbedderWithEncoder"):
            dd = cfg["params"]["encoder_config"]["params"]["ddconfig"]
            out.update(kl_decoder_state_dict(dd, seed + i, f"{prefix}embedders.{i}.encoder."))
    return out


def engine_params(jeng, batch: Mapping, seed: int) -> Dict[str, Any]:
    """Seeded flax trees {model, conditioner, first_stage} for a JAX
    DiffusionEngine at the batch's shapes."""
    t = batch["image_only_indicator"].shape[1]
    bt, hh, ww, _ = batch["cond_frames"].shape
    h, w = hh // 8, ww // 8
    net = jeng.network
    zeros = jnp.zeros
    model = flax_params(net, seed, zeros((bt, h, w, net.in_channels)), zeros((bt,)),
                        zeros((bt, 1, net.context_dim)),
                        zeros((bt, net.adm_in_channels + net.aux_emb_dim)),
                        num_video_frames=t, image_only_indicator=zeros((bt // t, t)))
    cond = flax_params(jeng.conditioner, seed + 1, jax.tree_util.tree_map(jnp.asarray, batch))
    enc = flax_params(jeng.first_stage_model.encoder, seed + 2, zeros((1, hh, ww, 3)))
    dec = flax_params(jeng.first_stage_model.decoder, seed + 3, zeros((t, h, w, 4)),
                      timesteps=t)
    return {"model": model, "conditioner": cond, "first_stage": {"encoder": enc, "decoder": dec}}


def engine_state_dict(params: Mapping, emb_models: Sequence[Mapping],
                      seed: int) -> Dict[str, torch.Tensor]:
    """engine_params carried into the reference key space, plus the
    conditioner's stored 2D decoders."""
    sd = state_dict_from_flax(params["model"], "model.diffusion_model.")
    sd.update(state_dict_from_flax(params["conditioner"], "conditioner."))
    sd.update(conditioner_extras(emb_models, seed))
    sd.update(state_dict_from_flax(params["first_stage"], "first_stage_model."))
    return sd
