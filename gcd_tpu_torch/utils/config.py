"""YAML configs with `target:` / `params:` instantiation, for the port.

The include + deep-merge loader is that of gcd_tpu/utils/config.py:92-130
(which cannot be imported here: gcd_tpu.utils pulls in jax). Target strings
resolve through a registry of the reference's `sgm.*` names for the classes
the port has, so configs/*.yaml drive it unchanged; any other target must be
an importable `gcd_tpu_torch.*` path.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Dict

import yaml

# Reference target -> port class, imported on first use.
REGISTRY = {
    "sgm.models.diffusion.DiffusionEngine":
        "gcd_tpu_torch.engine.engine.DiffusionEngine",
    "sgm.modules.diffusionmodules.video_model.VideoUNet":
        "gcd_tpu_torch.models.unet.VideoUNet",
    "sgm.models.autoencoder.AutoencodingEngine":
        "gcd_tpu_torch.models.vae.AutoencodingEngine",
    "sgm.models.autoencoder.AutoencoderKLModeOnly":
        "gcd_tpu_torch.models.vae.AutoencoderKLModeOnly",
    "sgm.modules.diffusionmodules.model.Encoder":
        "gcd_tpu_torch.models.vae.Encoder",
    "sgm.modules.diffusionmodules.model.Decoder":
        "gcd_tpu_torch.models.vae.Decoder",
    "sgm.modules.autoencoding.temporal_ae.VideoDecoder":
        "gcd_tpu_torch.models.vae.VideoDecoder",
    "sgm.modules.GeneralConditioner":
        "gcd_tpu_torch.models.embedders.GeneralConditioner",
    "sgm.modules.encoders.modules.GeneralConditioner":
        "gcd_tpu_torch.models.embedders.GeneralConditioner",
    "sgm.modules.encoders.modules.FrozenOpenCLIPImageEmbedder":
        "gcd_tpu_torch.models.embedders.FrozenOpenCLIPImageEmbedder",
    "sgm.modules.encoders.modules.FrozenOpenCLIPImagePredictionEmbedder":
        "gcd_tpu_torch.models.embedders.FrozenOpenCLIPImagePredictionEmbedder",
    "sgm.modules.encoders.modules.ConcatTimestepEmbedderND":
        "gcd_tpu_torch.models.embedders.ConcatTimestepEmbedderND",
    "sgm.modules.encoders.modules.VideoPredictionEmbedderWithEncoder":
        "gcd_tpu_torch.models.embedders.VideoPredictionEmbedderWithEncoder",
    "sgm.modules.encoders.modules.CameraEmbedder":
        "gcd_tpu_torch.models.embedders.CameraEmbedder",
    "sgm.modules.encoders.modules.SphericalEmbedder":
        "gcd_tpu_torch.models.embedders.SphericalEmbedder",
    "sgm.modules.diffusionmodules.denoiser.Denoiser":
        "gcd_tpu_torch.diffusion.denoiser.Denoiser",
    "sgm.modules.diffusionmodules.denoiser_scaling.VScalingWithEDMcNoise":
        "gcd_tpu_torch.diffusion.scaling.VScalingWithEDMcNoise",
    "sgm.modules.diffusionmodules.discretizer.EDMDiscretization":
        "gcd_tpu_torch.diffusion.discretization.EDMDiscretization",
    "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider":
        "gcd_tpu_torch.diffusion.guiders.LinearPredictionGuider",
    "sgm.modules.diffusionmodules.sampling.EulerEDMSampler":
        "gcd_tpu_torch.diffusion.sampling.EulerEDMSampler",
}


def get_obj_from_str(target: str):
    path = REGISTRY.get(target, target)
    if not path.startswith("gcd_tpu_torch."):
        raise KeyError(f"target {target!r} has no port in gcd_tpu_torch")
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: Dict[str, Any], **extra_kwargs):
    """Instantiate config['target'] with config['params'] (+ extra_kwargs)."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config. A top-level `include: [relative paths]` pulls in
    base files recursively, merged left to right, with the including file's
    own content merged last."""
    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}
    includes = cfg.pop("include", None)
    if includes:
        base_dir = os.path.dirname(os.path.abspath(path))
        merged: Dict[str, Any] = {}
        for rel in includes:
            inc = rel if os.path.isabs(rel) else os.path.join(base_dir, rel)
            merged = deep_merge(merged, load_config(inc))
        cfg = deep_merge(merged, cfg)
    return cfg


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Dicts merge key by key; anything else (lists included) is replaced."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out
