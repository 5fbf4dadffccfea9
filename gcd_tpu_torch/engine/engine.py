"""DiffusionEngine, inference side (port of gcd_tpu/engine/engine.py).

Holds the VideoUNet (`model.diffusion_model`), the denoiser, the sampler and
the first-stage VAE decoder (`first_stage_model.decoder`), built from the
reference-layout YAML (configs/infer_kubric.yaml). `sample_video_from_cond`
is the body of the JAX engine's `sample_video` after the conditioner:
CFG-doubled Euler-EDM sampling, then chunked decode. Its public layout is the
JAX package's channels-last one: conditioning and noise in (B*T, h, w, C),
frames out as (B*T, H, W, 3) in [0, 1]; modules run channels-first inside.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from gcd_tpu_torch.utils.config import instantiate_from_config


class _ModelWrapper(nn.Module):
    """Carries the UNet under the reference's `model.diffusion_model` name."""

    def __init__(self, diffusion_model: nn.Module):
        super().__init__()
        self.diffusion_model = diffusion_model


def _channels_first(v: torch.Tensor) -> torch.Tensor:
    return v.permute(0, 3, 1, 2) if v.dim() == 4 else v


class DiffusionEngine(nn.Module):
    def __init__(self, network_config: Dict, denoiser_config: Dict,
                 first_stage_config: Dict, sampler_config: Dict,
                 scale_factor: float = 1.0,
                 en_and_decode_n_samples_a_time: Optional[int] = None, **unused):
        super().__init__()
        # unused: the conditioner (ported next), training and checkpoint
        # settings of the reference's engine config.
        self.model = _ModelWrapper(instantiate_from_config(network_config))
        self.first_stage_model = instantiate_from_config(first_stage_config)
        self.denoiser = instantiate_from_config(denoiser_config)
        self.sampler = instantiate_from_config(sampler_config)
        self.scale_factor = float(scale_factor)
        self.en_and_decode_n_samples_a_time = en_and_decode_n_samples_a_time

    def network_fn(self, x: torch.Tensor, c_noise: torch.Tensor, cond: Dict,
                   num_video_frames: int,
                   image_only_indicator: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's OpenAIWrapper: concat-cond joins the channels,
        crossattn -> context, vector -> y. Returns fp32."""
        unet = self.model.diffusion_model
        dtype = unet.time_embed[0].weight.dtype
        xin = torch.cat([x.to(dtype), cond["concat"].to(dtype)], dim=1)
        return unet(xin, c_noise, cond["crossattn"], cond.get("vector"),
                    num_video_frames=num_video_frames,
                    image_only_indicator=image_only_indicator).float()

    def decode_first_stage(self, z: torch.Tensor,
                           decoding_t: Optional[int] = None) -> torch.Tensor:
        """Latents (N, 4, h, w) -> frames (N, 3, 8h, 8w), decoded in chunks
        whose size is also the decoder's temporal extent."""
        decoder = self.first_stage_model.decoder
        z = (z / self.scale_factor).to(decoder.conv_in.weight.dtype)
        n = decoding_t or self.en_and_decode_n_samples_a_time or z.shape[0]
        return torch.cat([self.first_stage_model.decode(chunk, chunk.shape[0])
                          for chunk in z.split(n)])

    @torch.no_grad()
    def sample_video_from_cond(self, c: Dict, uc: Dict, noise: torch.Tensor,
                               num_steps: Optional[int] = None,
                               decoding_t: Optional[int] = None) -> torch.Tensor:
        """c / uc: {"crossattn": (B*T, 1, Ck), "vector": (B*T, V),
        "concat": (B*T, h, w, 4)}; noise: (B*T, h, w, 4) unit Gaussian.
        Returns sampled frames (B*T, 8h, 8w, 3) in [0, 1], fp32."""
        t = self.sampler.guider.num_frames
        c = {k: _channels_first(v) for k, v in c.items()}
        uc = {k: _channels_first(v) for k, v in uc.items()}
        x = _channels_first(noise).float()
        ioi2 = torch.zeros(2 * (x.shape[0] // t), t, device=x.device)  # uc | c

        def denoiser_fn(xx, sigma, cond):
            def network(xin, c_noise, cc):
                return self.network_fn(xin, c_noise, cc, t, ioi2[:xin.shape[0] // t])

            return self.denoiser(network, xx, sigma, cond)

        z = self.sampler(denoiser_fn, x, c, uc, num_steps=num_steps)
        frames = self.decode_first_stage(z, decoding_t)
        return ((frames.float() + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)
