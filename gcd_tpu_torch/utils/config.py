"""YAML configs with `target:` / `params:` instantiation, for the port.

The include + deep-merge loader, the left-to-right merge with CLI dotlist
overrides, the dotted-path helpers and the config snapshot are those of
gcd_tpu/utils/config.py:92-190 (which cannot be imported here:
gcd_tpu.utils pulls in jax). Target strings
resolve through a registry of the reference's `sgm.*` names for the classes
the port has, so configs/*.yaml drive it unchanged; any other target must be
an importable `gcd_tpu_torch.*` path.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Dict, List

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
    "sgm.models.autoencoder.AutoencodingEngineLegacy":
        "gcd_tpu_torch.models.vae.AutoencodingEngineLegacy",
    "sgm.models.autoencoder.AutoencoderKL":
        "gcd_tpu_torch.models.vae.AutoencodingEngineLegacy",
    "sgm.models.autoencoder.IdentityFirstStage":
        "gcd_tpu_torch.models.vae.IdentityFirstStage",
    "sgm.modules.autoencoding.regularizers.quantize.VectorQuantizer":
        "gcd_tpu_torch.models.vq.VectorQuantizer",
    "sgm.modules.autoencoding.regularizers.quantize.VectorQuantizerWithInputProjection":
        "gcd_tpu_torch.models.vq.VectorQuantizerWithInputProjection",
    "sgm.modules.autoencoding.regularizers.quantize.GumbelQuantizer":
        "gcd_tpu_torch.models.vq.GumbelQuantizer",
    "sgm.modules.autoencoding.regularizers.quantize.EMAVectorQuantizer":
        "gcd_tpu_torch.models.vq.EMAVectorQuantizer",
    "sgm.modules.autoencoding.lpips.model.model.NLayerDiscriminator":
        "gcd_tpu_torch.models.discriminator.NLayerDiscriminator",
    "sgm.modules.autoencoding.losses.discriminator_loss.GeneralLPIPSWithDiscriminator":
        "gcd_tpu_torch.models.discriminator.GeneralLPIPSWithDiscriminator",
    "sgm.modules.autoencoding.losses.GeneralLPIPSWithDiscriminator":
        "gcd_tpu_torch.models.discriminator.GeneralLPIPSWithDiscriminator",
    "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer":
        "gcd_tpu_torch.models.vae.DiagonalGaussianRegularizer",
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
    **{f"sgm.modules.encoders.modules.{name}": f"gcd_tpu_torch.models.embedders.{name}"
       for name in ("IdentityEncoder", "ClassEmbedder", "SpatialRescaler", "GaussianEncoder",
                    "LowScaleEncoder", "FrozenT5Embedder", "FrozenByT5Embedder",
                    "FrozenCLIPEmbedder", "FrozenOpenCLIPEmbedder",
                    "FrozenOpenCLIPEmbedder2")},
    "sgm.modules.diffusionmodules.denoiser.Denoiser":
        "gcd_tpu_torch.diffusion.denoiser.Denoiser",
    "sgm.modules.diffusionmodules.denoiser.DiscreteDenoiser":
        "gcd_tpu_torch.diffusion.denoiser.DiscreteDenoiser",
    "sgm.modules.diffusionmodules.denoiser_scaling.VScalingWithEDMcNoise":
        "gcd_tpu_torch.diffusion.scaling.VScalingWithEDMcNoise",
    "sgm.modules.diffusionmodules.denoiser_scaling.EDMScaling":
        "gcd_tpu_torch.diffusion.scaling.EDMScaling",
    "sgm.modules.diffusionmodules.denoiser_scaling.EpsScaling":
        "gcd_tpu_torch.diffusion.scaling.EpsScaling",
    "sgm.modules.diffusionmodules.denoiser_scaling.VScaling":
        "gcd_tpu_torch.diffusion.scaling.VScaling",
    "sgm.modules.diffusionmodules.denoiser_scaling.DumbScaling":
        "gcd_tpu_torch.diffusion.scaling.DumbScaling",
    "sgm.modules.diffusionmodules.discretizer.EDMDiscretization":
        "gcd_tpu_torch.diffusion.discretization.EDMDiscretization",
    "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization":
        "gcd_tpu_torch.diffusion.discretization.LegacyDDPMDiscretization",
    "sgm.modules.diffusionmodules.guiders.LinearPredictionGuider":
        "gcd_tpu_torch.diffusion.guiders.LinearPredictionGuider",
    "sgm.modules.diffusionmodules.guiders.IdentityGuider":
        "gcd_tpu_torch.diffusion.guiders.IdentityGuider",
    "sgm.modules.diffusionmodules.guiders.VanillaCFG":
        "gcd_tpu_torch.diffusion.guiders.VanillaCFG",
    "sgm.modules.diffusionmodules.sampling.EulerEDMSampler":
        "gcd_tpu_torch.diffusion.sampling.EulerEDMSampler",
    "sgm.modules.diffusionmodules.sampling.EDMSampler":
        "gcd_tpu_torch.diffusion.sampling.EDMSampler",
    "sgm.modules.diffusionmodules.sampling.HeunEDMSampler":
        "gcd_tpu_torch.diffusion.sampling.HeunEDMSampler",
    "sgm.modules.diffusionmodules.sampling.EulerAncestralSampler":
        "gcd_tpu_torch.diffusion.sampling.EulerAncestralSampler",
    "sgm.modules.diffusionmodules.sampling.DPMPP2SAncestralSampler":
        "gcd_tpu_torch.diffusion.sampling.DPMPP2SAncestralSampler",
    "sgm.modules.diffusionmodules.sampling.DPMPP2MSampler":
        "gcd_tpu_torch.diffusion.sampling.DPMPP2MSampler",
    "sgm.modules.diffusionmodules.sampling.LinearMultistepSampler":
        "gcd_tpu_torch.diffusion.sampling.LinearMultistepSampler",
    "sgm.modules.autoencoding.losses.lpips.LatentLPIPS":
        "gcd_tpu_torch.models.lpips.LatentLPIPS",
    "sgm.modules.encoders.modules.InceptionV3":
        "gcd_tpu_torch.models.inception.InceptionV3",
    "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss":
        "gcd_tpu_torch.diffusion.loss.StandardDiffusionLoss",
    "sgm.modules.diffusionmodules.sigma_sampling.EDMSampling":
        "gcd_tpu_torch.diffusion.sigma_sampling.EDMSampling",
    "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling":
        "gcd_tpu_torch.diffusion.sigma_sampling.DiscreteSampling",
    "sgm.modules.diffusionmodules.loss_weighting.UnitWeighting":
        "gcd_tpu_torch.diffusion.weighting.UnitWeighting",
    "sgm.modules.diffusionmodules.denoiser_weighting.UnitWeighting":
        "gcd_tpu_torch.diffusion.weighting.UnitWeighting",
    "sgm.modules.diffusionmodules.loss_weighting.EDMWeighting":
        "gcd_tpu_torch.diffusion.weighting.EDMWeighting",
    "sgm.modules.diffusionmodules.denoiser_weighting.EDMWeighting":
        "gcd_tpu_torch.diffusion.weighting.EDMWeighting",
    "sgm.modules.diffusionmodules.loss_weighting.VWeighting":
        "gcd_tpu_torch.diffusion.weighting.VWeighting",
    "sgm.modules.diffusionmodules.denoiser_weighting.VWeighting":
        "gcd_tpu_torch.diffusion.weighting.VWeighting",
    "sgm.modules.diffusionmodules.loss_weighting.EpsWeighting":
        "gcd_tpu_torch.diffusion.weighting.EpsWeighting",
    "sgm.modules.diffusionmodules.denoiser_weighting.EpsWeighting":
        "gcd_tpu_torch.diffusion.weighting.EpsWeighting",
    "sgm.data.kubric_arbit.KubricSynthViewModule":
        "gcd_tpu_torch.data.kubric.KubricSynthViewModule",
    "sgm.data.pardom_arbit.ParallelDomainSynthViewModule":
        "gcd_tpu_torch.data.pardom.ParallelDomainSynthViewModule",
    "sgm.lr_scheduler.LambdaWarmUpCosineScheduler":
        "gcd_tpu_torch.engine.lr_schedule.LambdaWarmUpCosineScheduler",
    "sgm.lr_scheduler.LambdaWarmUpCosineScheduler2":
        "gcd_tpu_torch.engine.lr_schedule.LambdaWarmUpCosineScheduler2",
    "sgm.lr_scheduler.LambdaLinearScheduler":
        "gcd_tpu_torch.engine.lr_schedule.LambdaLinearScheduler",
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


def merge_configs(configs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Left-to-right deep merge, as OmegaConf.merge (main.py:722-726)."""
    out: Dict[str, Any] = {}
    for cfg in configs:
        out = deep_merge(out, cfg)
    return out


def _parse_value(raw: str) -> Any:
    val = yaml.safe_load(raw)
    if isinstance(val, str):
        # YAML 1.1 misses bare scientific notation like `1e-4`.
        try:
            return float(val)
        except ValueError:
            return val
    return val


def from_dotlist(dotlist: List[str]) -> Dict[str, Any]:
    """``["a.b.c=1", "x=[2,3]"]`` as a nested dict (the CLI override syntax)."""
    out: Dict[str, Any] = {}
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist item without '=': {item!r}")
        key, raw = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return out


def apply_dotlist(cfg: Dict[str, Any], dotlist: List[str]) -> Dict[str, Any]:
    return merge_configs([cfg, from_dotlist(dotlist)])


def config_to_dict(cfg: Any) -> Any:
    """A deep copy (OmegaConf.to_container's place for plain dicts)."""
    return copy.deepcopy(cfg)


def save_config(cfg: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def set_by_path(cfg: Dict[str, Any], path: str, value: Any) -> None:
    """Set a dotted path in place, making the dicts on the way."""
    node = cfg
    parts = path.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def get_by_path(cfg: Dict[str, Any], path: str, default: Any = None) -> Any:
    """The value at a dotted path, or `default` where the path ends early."""
    node = cfg
    for p in path.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node
