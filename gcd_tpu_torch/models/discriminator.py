"""PatchGAN discriminator and the LPIPS + GAN first-stage training loss
(port of gcd_tpu/models/discriminator.py). No GCD run trains its VAE; the
loss is part of the sgm surface for first-stage training.

Layout is torch's: images (N, C, H, W), or (B, C, T, H, W) for a loss with
dims > 2. Parameter names are the reference's (`main.{i}.*`, `logvar`).

BatchNorm follows flax's `nn.BatchNorm(momentum=0.9)`, which the JAX
package uses, not torch's BatchNorm2d: a training pass normalises with the
batch mean and the *biased* batch variance, computed as E[x^2] - E[x]^2
clipped at 0, and folds that same biased variance into the running
variance (torch's folds the unbiased one, so plain BatchNorm2d drifts from
JAX after one step). The running statistics live in the reference's
buffers (`running_mean`, `running_var`, `num_batches_tracked`) and update
in place, where the JAX module returns a new "batch_stats" collection.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.models.lpips import LPIPS
from gcd_tpu_torch.utils.config import instantiate_from_config


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


class ActNorm(nn.Module):
    """(x + loc) * scale per channel. As in the JAX package, its
    data-dependent initialisation is the caller's."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(channels))
        self.scale = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self.loc[:, None, None]) * self.scale[:, None, None]


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's statistics (module docstring): `momentum` is
    the weight of the running value, 0.9 as in the JAX package."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__(channels, eps=eps)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """Pix2Pix PatchGAN discriminator (gcd_tpu/models/discriminator.py:
    32-100): 4x4 convs, stride 2 but for the last two, LeakyReLU(0.2),
    BatchNorm (or ActNorm, with conv biases) after every conv but the first
    and the last. forward(x (N, input_nc, H, W)) -> patch logits
    (N, 1, H', W'); BatchNorm uses batch statistics in training mode."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()

        def norm(channels):
            return ActNorm(channels) if use_actnorm else FlaxBatchNorm2d(channels)

        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 2 if n < n_layers else 1, 1,
                                 bias=use_actnorm),
                       norm(ndf * nf), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * nf, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


Grads = Union[torch.Tensor, Sequence[torch.Tensor], Dict[str, torch.Tensor]]


def adaptive_weight_from_grads(nll_grads: Grads, g_grads: Grads,
                               discriminator_weight: float = 1.0) -> torch.Tensor:
    """The adaptive discriminator weight ||d nll|| / (||d g|| + 1e-4),
    clamped to [0, 1e4], times `discriminator_weight`, detached
    (gcd_tpu/models/discriminator.py:103-114): the caller supplies both
    gradients with respect to the decoder's last layer (a tensor, a
    sequence or a dict of tensors each)."""
    def norm(grads):
        if isinstance(grads, torch.Tensor):
            grads = [grads]
        elif isinstance(grads, dict):
            grads = list(grads.values())
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))

    d_weight = (norm(nll_grads) / (norm(g_grads) + 1e-4)).clamp(0.0, 1e4)
    return d_weight.detach() * discriminator_weight


class GeneralLPIPSWithDiscriminator(nn.Module):
    """Two-phase autoencoder loss (gcd_tpu/models/discriminator.py:117-322).

    forward(inputs, reconstructions, optimizer_idx=0 | 1, global_step, ...)
    -> (loss, log). Phase 0 (the generator) is the L1 + LPIPS negative
    log-likelihood under the learned `logvar`, plus the regularization
    terms, plus d_weight * disc_factor * -mean(D(reconstructions)); phase 1
    (the discriminator) is disc_factor * the hinge or vanilla loss of D on
    the detached inputs and reconstructions. The GAN terms count once
    global_step >= disc_start in training mode, always outside it. In
    training mode the discriminator runs on batch statistics and updates its
    running ones (phase 1: the real pass, then the fake), and phase 0 needs
    the adaptive `d_weight` (adaptive_weight_from_grads); outside it
    d_weight defaults to 1. The loss holds no LPIPS weights (a meta-device
    LPIPS runs on them): a perceptual_weight > 0 takes LPIPS's state dict
    (models/lpips.py's keys) as `lpips_params`, as the JAX loss takes its
    variables per call."""

    def __init__(self, disc_start: int, logvar_init: float = 0.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_loss: str = "hinge",
                 scale_input_to_tgt_size: bool = False, dims: int = 2,
                 learn_logvar: bool = False,
                 regularization_weights: Optional[Dict[str, float]] = None,
                 additional_log_keys=None, discriminator_config: Optional[Dict] = None):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"unknown disc_loss {disc_loss!r}")
        if scale_input_to_tgt_size:
            raise ValueError("scale_input_to_tgt_size is not supported (no sgm config sets it)")
        self.dims, self.disc_start = dims, disc_start
        self.perceptual_weight, self.disc_factor = perceptual_weight, disc_factor
        self.discriminator_weight = disc_weight
        self.disc_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.regularization_weights = dict(regularization_weights or {})
        self.additional_log_keys = set(additional_log_keys or [])
        self.additional_log_keys.update(self.regularization_weights)
        self.logvar = nn.Parameter(torch.full((), float(logvar_init)),
                                   requires_grad=learn_logvar)
        self.discriminator = (
            NLayerDiscriminator(disc_in_channels, n_layers=disc_num_layers)
            if discriminator_config is None else instantiate_from_config(discriminator_config))

    def get_nll_loss(self, rec_loss: torch.Tensor, weights: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(nll summed over a sample, averaged over the batch; the same of
        weights * nll)."""
        nll = rec_loss / torch.exp(self.logvar) + self.logvar
        weighted = nll if weights is None else weights * nll
        return nll.sum() / nll.shape[0], weighted.sum() / weighted.shape[0]

    def forward(self, inputs: torch.Tensor, reconstructions: torch.Tensor, *,
                optimizer_idx: int, global_step: int,
                regularization_log: Optional[Dict[str, torch.Tensor]] = None,
                split: str = "train", weights: Optional[torch.Tensor] = None,
                d_weight=None, lpips_params: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.dims > 2:  # (B, C, T, H, W) -> (B*T, C, H, W): LPIPS per frame
            inputs, reconstructions = (z.transpose(1, 2).flatten(0, 1)
                                       for z in (inputs, reconstructions))
        regularization_log = regularization_log or {}
        rec_loss = (inputs - reconstructions).abs()
        if self.perceptual_weight > 0:
            if lpips_params is None:
                raise ValueError("perceptual_weight > 0 requires lpips_params (LPIPS's "
                                 "state dict), or construct the loss with perceptual_weight=0")
            with torch.device("meta"):
                lpips = LPIPS()
            p = torch.func.functional_call(lpips, lpips_params, (inputs, reconstructions))
            rec_loss = rec_loss + self.perceptual_weight * p.reshape(-1, 1, 1, 1)
        active = float(global_step >= self.disc_start) if self.training else 1.0

        if optimizer_idx == 0:
            nll_loss, weighted_nll = self.get_nll_loss(rec_loss, weights)
            g_loss = -self.discriminator(reconstructions).mean()
            if d_weight is None:
                if self.training:
                    raise ValueError("the training generator phase needs the adaptive "
                                     "d_weight: adaptive_weight_from_grads of the nll and "
                                     "g losses' gradients at the decoder's last layer")
                d_weight = 1.0
            d_weight = torch.as_tensor(d_weight, dtype=torch.float32, device=inputs.device)
            loss = weighted_nll + d_weight * active * self.disc_factor * g_loss
            log = {}
            for k, v in regularization_log.items():
                if k in self.regularization_weights:
                    loss = loss + self.regularization_weights[k] * v
                if k in self.additional_log_keys:
                    log[f"{split}/{k}"] = v.detach().mean()
            log.update({f"{split}/loss/total": loss.detach(),
                        f"{split}/loss/nll": nll_loss.detach(),
                        f"{split}/loss/rec": rec_loss.detach().mean(),
                        f"{split}/loss/g": g_loss.detach(),
                        f"{split}/scalars/logvar": self.logvar.detach(),
                        f"{split}/scalars/d_weight": d_weight})
            return loss, log
        if optimizer_idx == 1:
            logits_real = self.discriminator(inputs.detach())
            logits_fake = self.discriminator(reconstructions.detach())
            d_loss = self.disc_factor * self.disc_loss(logits_real, logits_fake) * active
            return d_loss, {f"{split}/loss/disc": d_loss.detach(),
                            f"{split}/logits/real": logits_real.detach().mean(),
                            f"{split}/logits/fake": logits_fake.detach().mean()}
        raise NotImplementedError(f"Unknown optimizer_idx {optimizer_idx}")
