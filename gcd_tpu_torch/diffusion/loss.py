"""GCD's training objective (port of gcd_tpu/diffusion/loss.py).

The EDM denoising loss with GCD's three modifications:
  (a) sigma harmonization: one sigma per video, broadcast over its frames;
  (b) per-class pixel weights for ParallelDomain persons / vehicles, matched
      in RGB and area-downsampled to the latent grid;
  (c) the focal top-k schedule, annealing from the mean loss to the mean of
      the top `focus_top` fraction over `focus_steps`, blended 0.9 / 0.1.

Latents, noise and the network's input and output are in the JAX package's
channels-last layout (B*T, h, w, C). The random numbers (the sigma
sampler's `rand`, the noise, the offset noise) are the `draws` dict, or are
drawn from a torch.Generator by `draw`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from gcd_tpu_torch.diffusion.denoiser import _append_dims
from gcd_tpu_torch.utils.config import instantiate_from_config

# ParallelDomain ontology colours (RGB uint8) of the up-weighted classes.
PERSON_RGB = [[220, 20, 180], [64, 64, 64], [128, 128, 128], [192, 192, 192],
              [220, 20, 60]]
VEHICLE_RGB = [[0, 60, 100], [0, 0, 142], [0, 0, 90], [32, 32, 32], [119, 11, 32],
               [0, 0, 230], [128, 230, 128], [0, 0, 70], [0, 64, 64]]


def _area_downsample(mask: torch.Tensor, out_hw) -> torch.Tensor:
    """Area (average) downsample of (N, H, W, C) to (N, h, w, C) where the
    grid divides; elsewhere the antialiased linear resize of
    jax.image.resize(..., "linear"), as gcd_tpu/diffusion/loss.py falls
    back to it."""
    n, h, w, c = mask.shape
    oh, ow = out_hw
    if h % oh or w % ow:
        return linear_resize(mask, (oh, ow))
    return mask.reshape(n, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))


def linear_weights(size_in: int, size_out: int) -> np.ndarray:
    """(size_in, size_out) float32 weights of an antialiased linear resize
    along one axis: the weight rule of jax.image.scale_and_translate
    (compute_weight_mat) with the triangle kernel, scale size_out / size_in
    and no translation. Downsampling widens the kernel by the inverse
    scale; each output's weights are normalised to sum to 1, and an output
    whose sample falls outside the input gets none."""
    inv_scale = 1.0 / (size_out / size_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = (np.arange(size_out, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(size_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), 1 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def linear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, H, W, C) -> (N, h, w, C): jax.image.resize(x, (N, h, w, C),
    "linear") with its default antialiasing, as separable fp32 products
    (an axis of unchanged size is left as it is, as there)."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    out = x.float()
    if oh != h:
        wh = torch.from_numpy(linear_weights(h, oh)).to(x.device)
        out = torch.einsum("nhwc,hp->npwc", out, wh)
    if ow != w:
        ww = torch.from_numpy(linear_weights(w, ow)).to(x.device)
        out = torch.einsum("nhwc,wq->nhqc", out, ww)
    return out.to(x.dtype)


class StandardDiffusionLoss:
    def __init__(self, sigma_sampler_config: Dict, loss_weighting_config: Dict,
                 loss_type: str = "l2", offset_noise_level: float = 0.0,
                 harmonize_sigmas: bool = True,
                 batch2model_keys: Optional[Union[str, List[str]]] = None,
                 pd_person_weight: float = 1.0, pd_vehicle_weight: float = 1.0,
                 focus_top: float = 1.0, focus_steps: int = -1):
        if loss_type not in ("l2", "l1"):
            raise ValueError(f"unsupported loss_type {loss_type!r}")
        self.loss_type = loss_type
        self.offset_noise_level = float(offset_noise_level)
        self.harmonize_sigmas = bool(harmonize_sigmas)
        self.sigma_sampler = instantiate_from_config(sigma_sampler_config)
        self.loss_weighting = instantiate_from_config(loss_weighting_config)
        if isinstance(batch2model_keys, str):
            batch2model_keys = [batch2model_keys]
        self.batch2model_keys = set(batch2model_keys or [])
        self.pd_person_weight = float(pd_person_weight)
        self.pd_vehicle_weight = float(pd_vehicle_weight)
        self.focus_top = float(focus_top)
        self.focus_steps = int(focus_steps)

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The loss's random numbers for latents x (B*T, h, w, C): "sigma_rand"
        for the sigma sampler, "noise" like x, and "offset" (B*T, C) when
        offset noise is on."""
        bt, c = x.shape[0], x.shape[-1]
        draws = {"sigma_rand": self.sigma_sampler.draw(bt, generator, x.device),
                 "noise": torch.randn(x.shape, generator=generator, device=x.device)}
        if self.offset_noise_level > 0.0:
            draws["offset"] = torch.randn((bt, c), generator=generator, device=x.device)
        return draws

    def loss_from_cond(self, network: Callable, denoiser: Callable, cond: Dict,
                       x: torch.Tensor, batch: Dict, global_step: int,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """x: (B*T, h, w, C) latents; `network(x, c_noise, cond, **inputs)`
        takes the channels-last layout and the batch2model_keys of `batch`.
        Returns the per-sample loss, (B*T,) fp32."""
        extra = {k: batch[k] for k in self.batch2model_keys.intersection(batch)}
        draws = draws if draws is not None else self.draw(x, generator)
        x = x.float()
        bt = x.shape[0]
        sigmas = self.sigma_sampler(draws["sigma_rand"])
        if self.harmonize_sigmas:
            t = int(batch["num_video_frames"])
            sigmas = sigmas.reshape(bt // t, t)[:, :1].expand(bt // t, t).reshape(bt)
        noise = draws["noise"].float()
        if self.offset_noise_level > 0.0:
            noise = noise + self.offset_noise_level * draws["offset"].float()[:, None, None, :]
        noised_input = x + noise * _append_dims(sigmas, x.dim())
        model_output = denoiser(lambda xin, c_noise, c: network(xin, c_noise, c, **extra),
                                noised_input, sigmas, cond)
        w = self.loss_weighting(sigmas)
        return self.get_loss(model_output, x, w, batch, global_step)

    def _focal_fraction(self, global_step: int) -> np.float32:
        """The fraction of each sample's values the focal term keeps, in
        float32 as the JAX package computes it."""
        if self.focus_steps <= 0:
            return np.float32(1.0)
        progress = np.clip(np.float32(global_step) / np.float32(self.focus_steps),
                           np.float32(0.0), np.float32(1.0))
        return (np.float32(1.0) - progress) + np.float32(self.focus_top) * progress

    def get_loss(self, model_output: torch.Tensor, target: torch.Tensor, w: torch.Tensor,
                 batch: Dict, global_step: int) -> torch.Tensor:
        diff = model_output.float() - target.float()
        bt = target.shape[0]
        loss_raw = diff ** 2 if self.loss_type == "l2" else diff.abs()

        classes = []
        if self.pd_person_weight > 1.0:
            classes += [(c, self.pd_person_weight) for c in PERSON_RGB]
        if self.pd_vehicle_weight > 1.0:
            classes += [(c, self.pd_vehicle_weight) for c in VEHICLE_RGB]
        loss_bias = loss_bias_mean = 0.0
        if classes:
            gt_rgb = batch["jpg"].float()  # (B*T, H, W, 3) in [-1, 1]
            loss_bias = torch.zeros_like(loss_raw)
            for rgb, weight in classes:
                ref = torch.tensor(rgb, dtype=torch.float32, device=gt_rgb.device) / 127.5 - 1.0
                mask = ((gt_rgb - ref).abs().mean(dim=-1, keepdim=True) < 0.02).float()
                mask = _area_downsample(mask, target.shape[1:3])
                loss_bias = loss_bias + loss_raw * mask * (weight - 1.0)
            loss_bias_mean = loss_bias.reshape(bt, -1).mean(dim=1)

        loss_flat = (loss_raw + loss_bias * 0.5).reshape(bt, -1)
        n = loss_flat.shape[1]
        loss_mean = loss_flat.mean(dim=1)
        cur_top = self._focal_fraction(global_step)
        if self.focus_top < 1.0 and self.focus_steps > 0 and cur_top < 1.0:
            keep = int(np.clip(int(np.float32(n) * cur_top), 1, n))
            loss_top = loss_flat.topk(keep, dim=1).values.mean(dim=1)
            loss_focal = loss_top * 0.9 + loss_mean * 0.1
        else:
            loss_focal = loss_mean
        return (loss_focal + loss_bias_mean * 0.5) * w.reshape(bt, -1)[:, 0]
