"""DiffusionEngine, inference side (port of gcd_tpu/engine/engine.py).

Holds the conditioner (`conditioner.*`), the VideoUNet
(`model.diffusion_model`), the denoiser, the sampler and the first-stage VAE
(`first_stage_model.{encoder,decoder}`), built from the reference-layout
YAML (configs/infer_kubric.yaml). `sample_video(batch)` is the JAX engine's
`sample_video`: conditioner (c and uc), CFG-doubled Euler-EDM sampling, then
chunked decode; `sample_video_from_cond` is the part after the conditioner.
Its public layout is the JAX package's channels-last one: frames in
(B*T, H, W, 3), conditioning and latents in (B*T, h, w, C); modules run
channels-first inside. `load_engine` (engine/build.py) puts an engine on the
card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from gcd_tpu_torch.utils.config import instantiate_from_config

# The unconditional branch of sample_video zeroes the image embeddings.
UC_ZERO_KEYS = ("cond_frames", "cond_frames_without_noise")


class _ModelWrapper(nn.Module):
    """Carries the UNet under the reference's `model.diffusion_model` name."""

    def __init__(self, diffusion_model: nn.Module):
        super().__init__()
        self.diffusion_model = diffusion_model


def _channels_first(v: torch.Tensor) -> torch.Tensor:
    return v.permute(0, 3, 1, 2) if v.dim() == 4 else v


def _unit_interval(frames: torch.Tensor) -> torch.Tensor:
    return ((frames.float() + 1.0) / 2.0).clamp(0.0, 1.0)


class DiffusionEngine(nn.Module):
    def __init__(self, network_config: Dict, denoiser_config: Dict,
                 first_stage_config: Dict, sampler_config: Dict,
                 conditioner_config: Optional[Dict] = None,
                 scale_factor: float = 1.0,
                 en_and_decode_n_samples_a_time: Optional[int] = None, **unused):
        super().__init__()
        # unused: the training and checkpoint settings of the reference's
        # engine config.
        self.conditioner = instantiate_from_config(
            conditioner_config or {"target": "sgm.modules.GeneralConditioner",
                                   "params": {"emb_models": []}})
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

    def apply_conditioner(self, batch: Dict,
                          force_zero_embeddings: Optional[Sequence[str]] = None) -> Dict:
        """The conditioner on a batch dict: {"crossattn", "vector", "concat"}."""
        return self.conditioner(batch, force_zero_embeddings)

    def get_unconditional_conditioning(
            self, batch: Dict, force_uc_zero_embeddings: Optional[Sequence[str]] = None
    ) -> Tuple[Dict, Dict]:
        """(c, uc), uc with the `force_uc_zero_embeddings` keys zeroed."""
        return self.conditioner.get_unconditional_conditioning(batch, force_uc_zero_embeddings)

    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Frames (N, H, W, 3) in [-1, 1] -> scaled latents (N, H/8, W/8, 4),
        encoded in chunks of en_and_decode_n_samples_a_time. The posterior's
        mode: the JAX package samples it for training, which arrives with the
        training slice."""
        vae = self.first_stage_model
        x = x.permute(0, 3, 1, 2).to(vae.encoder.conv_in.weight.dtype)
        n = self.en_and_decode_n_samples_a_time or x.shape[0]
        z = torch.cat([vae.encode(chunk) for chunk in x.split(n)])
        return (z * self.scale_factor).permute(0, 2, 3, 1)

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
    def sample_latents(self, c: Dict, uc: Dict, noise: torch.Tensor,
                       num_steps: Optional[int] = None,
                       image_only_indicator: Optional[torch.Tensor] = None) -> torch.Tensor:
        """c / uc: {"crossattn": (B*T, 1, Ck), "vector": (B*T, V),
        "concat": (B*T, h, w, 4)}; noise: (B*T, h, w, 4) unit Gaussian;
        image_only_indicator (B, T), zeros when None. Returns the sampled
        latents (B*T, 4, h, w), fp32."""
        t = self.sampler.guider.num_frames
        c = {k: _channels_first(v) for k, v in c.items()}
        uc = {k: _channels_first(v) for k, v in uc.items()}
        x = _channels_first(noise).float()
        if image_only_indicator is None:
            image_only_indicator = torch.zeros(x.shape[0] // t, t, device=x.device)
        ioi2 = torch.cat([image_only_indicator, image_only_indicator])  # uc | c

        def denoiser_fn(xx, sigma, cond):
            def network(xin, c_noise, cc):
                return self.network_fn(xin, c_noise, cc, t, ioi2[:xin.shape[0] // t])

            return self.denoiser(network, xx, sigma, cond)

        return self.sampler(denoiser_fn, x, c, uc, num_steps=num_steps)

    @torch.no_grad()
    def sample_video_from_cond(self, c: Dict, uc: Dict, noise: torch.Tensor,
                               num_steps: Optional[int] = None,
                               decoding_t: Optional[int] = None) -> torch.Tensor:
        """sample_latents, then decode: sampled frames (B*T, 8h, 8w, 3) in
        [0, 1], fp32."""
        z = self.sample_latents(c, uc, noise, num_steps)
        return _unit_interval(self.decode_first_stage(z, decoding_t)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def sample_video(self, batch: Dict, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, num_steps: Optional[int] = None,
                     decoding_t: Optional[int] = None,
                     return_latents: bool = False) -> Dict[str, torch.Tensor]:
        """Novel-view video from raw frames and a camera move.

        `batch` is the JAX package's (engine.py example_batch): "cond_frames"
        and "cond_frames_without_noise" (B*T, H, W, 3) in [-1, 1], "cond_aug",
        "fps_id", "motion_bucket_id" (B*T,), "scaled_relative_angles"
        (B*T, 3), "image_only_indicator" (B, T), optionally "jpg". The latent
        noise is `noise` (B*T, H/8, W/8, 4), or drawn from `generator`.
        Returns {"cond_video", "sampled_video"[, "gt_video", "sampled_z"]},
        frames (B*T, H, W, 3) in [0, 1], fp32."""
        c, uc = self.get_unconditional_conditioning(batch, UC_ZERO_KEYS)
        frames = batch["cond_frames"]
        if noise is None:
            bt, h, w, _ = frames.shape
            noise = torch.randn((bt, h // 8, w // 8, 4), generator=generator,
                                device=frames.device)
        z = self.sample_latents(c, uc, noise, num_steps, batch["image_only_indicator"])
        out = {"cond_video": _unit_interval(frames),
               "sampled_video": _unit_interval(
                   self.decode_first_stage(z, decoding_t)).permute(0, 2, 3, 1)}
        if return_latents:
            out["sampled_z"] = z.permute(0, 2, 3, 1)
        if "jpg" in batch:
            out["gt_video"] = _unit_interval(batch["jpg"])
        return out
