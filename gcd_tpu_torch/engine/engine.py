"""DiffusionEngine (port of gcd_tpu/engine/engine.py).

Holds the conditioner (`conditioner.*`), the VideoUNet
(`model.diffusion_model`), the denoiser, the sampler, the first-stage VAE
(`first_stage_model.{encoder,decoder}`) and the training loss, built from
the reference-layout YAML (configs/*.yaml). `sample_video(batch)` is the JAX
engine's `sample_video`: conditioner (c and uc), the config's sampler
(CFG-doubled 25-step Euler-EDM in GCD's configs; any sampler, guider and
denoiser of diffusion/), then chunked decode; `sample_video_from_cond` is
the part after the conditioner. `sample_video` and `sample_latents` take a
`denoise` in place of the engine's own one-card `denoise`, and
`sample_video` a `condition` and a `decode` (engine/serving.py splits the
three over a mesh). `loss(batch, global_step)` is the JAX engine's `loss`: the
sampled first-stage encoding without grad, the conditioner in training mode,
then StandardDiffusionLoss, on the random numbers `draw` makes;
`trainable_parameter_names` is its `trainable_mask` by parameter name;
`example_batch` its shape-correct batch. Under `ft_strategy:
time_lora` the UNet's "time" projections carry LoRA adapters merged into
their weights at every read (models/lora.py), so `network_fn`, the loss
and the sampler all run the merged weights, as the JAX engine's
`effective_model_params`.
The public layout is the JAX package's
channels-last one: frames in (B*T, H, W, 3), conditioning and latents in
(B*T, h, w, C); modules run channels-first inside. `load_engine`
(engine/build.py) puts an engine on the card, `load_trainer`
(engine/trainer.py) a trainer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
from torch import nn

from gcd_tpu_torch.models.lora import add_lora, is_adapter
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


# ft_strategy "dummy" trains this one parameter of the UNet.
DUMMY_TRAINABLE = "output_blocks.11.1.time_mixer.mix_factor"
# Which UNet parameters each ft_strategy trains, by name under the UNet:
# all, those holding "time", the one blend factor, or the LoRA adapters.
FT_STRATEGIES = {"everything": lambda key: True, "time": lambda key: "time" in key,
                 "dummy": lambda key: DUMMY_TRAINABLE in key, "time_lora": is_adapter}


class DiffusionEngine(nn.Module):
    def __init__(self, network_config: Dict, denoiser_config: Dict,
                 first_stage_config: Dict, sampler_config: Dict,
                 conditioner_config: Optional[Dict] = None,
                 loss_fn_config: Optional[Dict] = None,
                 optimizer_config: Optional[Dict] = None,
                 scheduler_config: Optional[Dict] = None,
                 ft_strategy: str = "everything",
                 base_learning_rate: Optional[float] = None,
                 use_ema: bool = False, ema_decay_rate: float = 0.9999,
                 scale_factor: float = 1.0,
                 en_and_decode_n_samples_a_time: Optional[int] = None, **unused):
        super().__init__()
        # unused: the reference's checkpoint, autocast and logging settings.
        # The optimizer, scheduler and EMA settings are read by
        # engine/trainer.py.
        self.loss_fn = instantiate_from_config(loss_fn_config) if loss_fn_config else None
        self.optimizer_config = optimizer_config or {"target": "torch.optim.AdamW"}
        self.scheduler_config = scheduler_config
        self.ft_strategy = ft_strategy
        self.base_learning_rate = base_learning_rate
        self.use_ema = bool(use_ema)
        self.ema_decay_rate = float(ema_decay_rate)
        self.conditioner = instantiate_from_config(
            conditioner_config or {"target": "sgm.modules.GeneralConditioner",
                                   "params": {"emb_models": []}})
        self.model = _ModelWrapper(instantiate_from_config(network_config))
        if ft_strategy == "time_lora":
            add_lora(self.model.diffusion_model)
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
                          force_zero_embeddings: Optional[Sequence[str]] = None,
                          train: bool = False, generator: Optional[torch.Generator] = None,
                          ucg_keep: Optional[Dict[int, torch.Tensor]] = None) -> Dict:
        """The conditioner on a batch dict: {"crossattn", "vector", "concat"};
        `train` applies the conditioning dropout (GeneralConditioner)."""
        return self.conditioner(batch, force_zero_embeddings, train, generator, ucg_keep)

    def get_unconditional_conditioning(
            self, batch: Dict, force_uc_zero_embeddings: Optional[Sequence[str]] = None,
            generator: Optional[torch.Generator] = None) -> Tuple[Dict, Dict]:
        """(c, uc), uc with the `force_uc_zero_embeddings` keys zeroed; an
        embedder that draws random numbers draws from `generator`."""
        return self.conditioner.get_unconditional_conditioning(
            batch, force_uc_zero_embeddings, generator=generator)

    def _first_stage_dtype(self, x: torch.Tensor) -> torch.dtype:
        """The first stage's weight dtype; x's own for one without weights
        (IdentityFirstStage)."""
        weight = next(self.first_stage_model.parameters(), None)
        return x.dtype if weight is None else weight.dtype

    def encode_first_stage(self, x: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Frames (N, H, W, 3) in [-1, 1] -> scaled latents (N, H/8, W/8, 4),
        encoded in chunks of en_and_decode_n_samples_a_time: a sample of the
        posterior, mean + std * noise, with the unit Gaussian `noise`
        (N, H/8, W/8, 4), or one drawn from torch's global generator (the
        mode, a quantizer's z_q or the frames themselves for the first
        stages that do not sample)."""
        vae = self.first_stage_model
        x = x.permute(0, 3, 1, 2).to(self._first_stage_dtype(x))
        n = self.en_and_decode_n_samples_a_time or x.shape[0]
        chunks = x.split(n)
        noises = (noise.permute(0, 3, 1, 2).split(n) if noise is not None
                  else [None] * len(chunks))
        z = torch.cat([vae.encode(c, e) for c, e in zip(chunks, noises)])
        return (z * self.scale_factor).permute(0, 2, 3, 1)

    def decode_first_stage(self, z: torch.Tensor,
                           decoding_t: Optional[int] = None) -> torch.Tensor:
        """Latents (N, 4, h, w) -> frames (N, 3, 8h, 8w), decoded in chunks
        whose size is also the decoder's temporal extent."""
        z = (z / self.scale_factor).to(self._first_stage_dtype(z))
        n = decoding_t or self.en_and_decode_n_samples_a_time or z.shape[0]
        return torch.cat([self.first_stage_model.decode(chunk, chunk.shape[0])
                          for chunk in z.split(n)])

    def loss(self, batch: Dict, global_step: int, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict] = None) -> torch.Tensor:
        """Per-sample training loss, (B*T,) fp32 (gcd_tpu engine.py `loss`).

        `batch` is sample_video's plus "jpg", the target frames
        (B*T, H, W, 3) in [-1, 1]. The random numbers are `draws` --
        "posterior" (B*T, H/8, W/8, 4) for the first-stage sample,
        "ucg_keep" {embedder index: (B*T, its outputs) keep masks} for the
        conditioning dropout, and the loss's "sigma_rand", "noise" and "offset"
        (StandardDiffusionLoss.draw) -- or, when None, `draw` makes them
        from `generator`. A key missing from `draws` is drawn from torch's
        global generator."""
        frames = batch["jpg"]
        if draws is None:
            draws = self.draw(frames.shape[0], tuple(frames.shape[1:3]), generator,
                              frames.device)
        t = int(batch["image_only_indicator"].shape[1])
        with torch.no_grad():
            z = self.encode_first_stage(frames, draws.get("posterior")).float()
        cond = self.apply_conditioner(batch, train=True, ucg_keep=draws.get("ucg_keep"))
        cond = {k: _channels_first(v) for k, v in cond.items()}

        def network(xin, c_noise, c, image_only_indicator=None, **unused):
            out = self.network_fn(xin.permute(0, 3, 1, 2), c_noise, c, t, image_only_indicator)
            return out.permute(0, 2, 3, 1)

        loss_draws = draws if "noise" in draws else None
        return self.loss_fn.loss_from_cond(network, self.denoiser, cond, z,
                                           dict(batch, num_video_frames=t), global_step,
                                           None, loss_draws)

    def draw(self, frames: int, frame_hw: Tuple[int, int],
             generator: Optional[torch.Generator],
             device: Union[str, torch.device]) -> Dict:
        """The random numbers of `loss` for a batch of `frames` frames of
        frame_hw, drawn from `generator` (the one definition of their order
        and shapes): the posterior noise chunk by chunk (when the first
        stage samples), the conditioning-dropout keep masks of the embedders
        with a ucg_rate (GeneralConditioner.draw_keep), then the loss's. A data-parallel
        rank draws those of the global batch and keeps its own rows
        (engine/trainer.py), so any number of ranks makes the same step."""
        h, w = frame_hw[0] // 8, frame_hw[1] // 8
        z = self.first_stage_model.latent_channels
        draws: Dict = {}
        if getattr(self.first_stage_model.regularization, "sample", False):
            chunk = self.en_and_decode_n_samples_a_time or frames
            draws["posterior"] = torch.cat([
                torch.randn((min(chunk, frames - i), z, h, w), generator=generator,
                            device=device)
                for i in range(0, frames, chunk)]).permute(0, 2, 3, 1)
        keep = self.conditioner.draw_keep(frames, generator, device)
        if keep:
            draws["ucg_keep"] = keep
        draws.update(self.loss_fn.draw(torch.empty((frames, h, w, z), device=device),
                                       generator))
        return draws

    def trainable_parameter_names(self) -> Set[str]:
        """Names of the parameters a training step updates (gcd_tpu engine.py
        `trainable_mask`): the UNet's by `ft_strategy` (FT_STRATEGIES;
        under "time_lora" only the adapters, the base frozen), the
        conditioner's embedders marked is_trainable, never the first stage."""
        unet_prefix, emb_prefix = "model.diffusion_model.", "conditioner.embedders."
        if self.ft_strategy not in FT_STRATEGIES:
            raise NotImplementedError(f"ft_strategy {self.ft_strategy!r}")
        names = set()
        for name, _ in self.named_parameters():
            if name.startswith(unet_prefix):
                keep = FT_STRATEGIES[self.ft_strategy](name[len(unet_prefix):])
            elif name.startswith(emb_prefix):
                keep = self.conditioner.is_trainable[int(name.split(".")[2])]
            else:
                keep = False
            if keep:
                names.add(name)
        return names

    @staticmethod
    def example_batch(img_hw: Tuple[int, int] = (256, 384), t: int = 14, b: int = 1,
                      device: Optional[Union[str, torch.device]] = None) -> Dict:
        """A shape-correct batch of `b` clips of `t` frames (gcd_tpu engine.py
        example_batch): zero frames, the default conditioning scalars, zero
        camera moves; the server warms up on it."""
        h, w = img_hw
        bt = b * t

        def full(shape, value=0.0):
            return torch.full(shape, value, device=device)

        return {"jpg": full((bt, h, w, 3)), "cond_frames": full((bt, h, w, 3)),
                "cond_frames_without_noise": full((bt, h, w, 3)),
                "cond_aug": full((bt,), 0.02), "motion_bucket_id": full((bt,), 127.0),
                "fps_id": full((bt,), 5.0), "image_only_indicator": full((b, t)),
                "scaled_relative_angles": full((bt, 3)),
                "scaled_relative_pose": full((bt, 3, 4)), "num_video_frames": t}

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, cond: Dict,
                image_only_indicator: torch.Tensor,
                rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        """D(x, sigma) of the UNet, channels-first: x (B*T, 4, h, w), sigma
        (B*T,), cond's rows and the indicator (B, T) of the same B videos.
        `rows` picks the rows the network returns, when it returns only some
        (a frame-sharded UNet, parallel/frames.py)."""
        t = image_only_indicator.shape[1]

        def network(xin, c_noise, cc):
            return self.network_fn(xin, c_noise, cc, t, image_only_indicator)

        return self.denoiser(network, x, sigma, cond, rows)

    def latent_noise(self, frames: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The sampler's unit Gaussian noise (B*T, H/8, W/8, 4) for frames
        (B*T, H, W, 3), drawn from `generator`."""
        bt, h, w, _ = frames.shape
        return torch.randn((bt, h // 8, w // 8, 4), generator=generator, device=frames.device)

    def step_noise(self, noise: torch.Tensor, num_steps: Optional[int] = None,
                   generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """The sampler's per-step unit Gaussian noise (steps, B*T, 4, h, w),
        channels-first, drawn from `generator`, for the latent noise `noise`
        (B*T, h, w, 4); None for a sampler that draws none
        (`needs_step_noise`)."""
        if not self.sampler.needs_step_noise:
            return None
        bt, h, w, c = noise.shape
        steps = len(self.sampler.sigmas(num_steps)) - 1
        return torch.randn((steps, bt, c, h, w), generator=generator, device=noise.device)

    @torch.no_grad()
    def sample_latents(self, c: Dict, uc: Dict, noise: torch.Tensor,
                       num_steps: Optional[int] = None,
                       image_only_indicator: Optional[torch.Tensor] = None,
                       denoise: Optional[Callable] = None,
                       step_noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """c / uc: {"crossattn": (B*T, 1, Ck), "vector": (B*T, V),
        "concat": (B*T, h, w, 4)}; noise: (B*T, h, w, 4) unit Gaussian;
        image_only_indicator (B, T), whose T is the clips' frame count
        (JAX's static_num_frames); when None, zeros of the guider's
        num_frames, or of one clip of all B*T rows for a guider without
        one. The per-step noise of a sampler that draws it is `step_noise`,
        or is drawn from `generator`. Returns the
        sampled latents (B*T, 4, h, w), fp32. `denoise` (the signature of
        `self.denoise`, which it defaults to) evaluates the UNet."""
        c = {k: _channels_first(v) for k, v in c.items()}
        uc = {k: _channels_first(v) for k, v in uc.items()}
        x = _channels_first(noise).float()
        if image_only_indicator is None:
            t = getattr(self.sampler.guider, "num_frames", x.shape[0])
            image_only_indicator = torch.zeros(x.shape[0] // t, t, device=x.device)
        if step_noise is None:
            step_noise = self.step_noise(noise, num_steps, generator)
        return self.sampler(self.sampling_denoiser(image_only_indicator, denoise), x, c, uc,
                            num_steps=num_steps, step_noise=step_noise)

    def sampling_denoiser(self, image_only_indicator: torch.Tensor,
                          denoise: Optional[Callable] = None) -> Callable:
        """The sampler's `denoiser(x, sigma, cond)` over `denoise` (the
        signature of `self.denoise`, which it defaults to), for the videos
        whose indicator is (B, T) `image_only_indicator`: it takes both
        halves' indicators on a guided step, the conditional half's on a
        plain one (guidance_interval)."""
        t = image_only_indicator.shape[1]
        ioi2 = torch.cat([image_only_indicator, image_only_indicator])  # uc | c
        denoise = denoise or self.denoise

        def denoiser_fn(xx, sigma, cond):
            return denoise(xx, sigma, cond, ioi2[-(xx.shape[0] // t):])

        return denoiser_fn

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
                     decoding_t: Optional[int] = None, return_latents: bool = False,
                     denoise: Optional[Callable] = None, condition: Optional[Callable] = None,
                     decode: Optional[Callable] = None,
                     step_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Novel-view video from raw frames and a camera move.

        `batch` is the JAX package's (engine.py example_batch): "cond_frames"
        and "cond_frames_without_noise" (B*T, H, W, 3) in [-1, 1], "cond_aug",
        "fps_id", "motion_bucket_id" (B*T,), "scaled_relative_angles"
        (B*T, 3), "image_only_indicator" (B, T), optionally "jpg". The latent
        noise is `noise` (B*T, H/8, W/8, 4), or drawn from `generator`
        (`latent_noise`) after the draws of any conditioner embedder that
        draws random numbers (none in GCD's configs); a sampler's per-step noise is `step_noise`, or
        drawn from `generator` after the latent noise (`step_noise`).
        `denoise` as sample_latents takes it;
        `condition(batch) -> (c, uc)` and `decode(z) -> frames` in place of
        the conditioner's get_unconditional_conditioning and of
        decode_first_stage (engine/serving.py splits all three over a mesh).
        Returns {"cond_video", "sampled_video"[, "gt_video", "sampled_z"]},
        frames (B*T, H, W, 3) in [0, 1], fp32."""
        if condition is None:
            c, uc = self.get_unconditional_conditioning(batch, UC_ZERO_KEYS, generator)
        else:
            c, uc = condition(batch)
        frames = batch["cond_frames"]
        if noise is None:
            noise = self.latent_noise(frames, generator)
        z = self.sample_latents(c, uc, noise, num_steps, batch["image_only_indicator"],
                                denoise, step_noise, generator)
        decoded = self.decode_first_stage(z, decoding_t) if decode is None else decode(z)
        out = {"cond_video": _unit_interval(frames),
               "sampled_video": _unit_interval(decoded).permute(0, 2, 3, 1)}
        if return_latents:
            out["sampled_z"] = z.permute(0, 2, 3, 1)
        if "jpg" in batch:
            out["gt_video"] = _unit_interval(batch["jpg"])
        return out

    def validation_metrics(self, batch: Dict, generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           decoding_t: Optional[int] = None,
                           lpips: Optional[nn.Module] = None) -> Dict[str, float]:
        """sample_video on a batch with targets ("jpg"), then the frames'
        mean PSNR and SSIM against them on the host (utils/metrics.py):
        {"val/psnr", "val/ssim"}; with an `lpips` network
        (models/lpips.py LPIPS, on the frames' device) also "val/lpips",
        its distance between each frame and its target, in [-1, 1], mean
        over the frames."""
        from gcd_tpu_torch.utils.metrics import psnr, ssim

        out = self.sample_video(batch, generator, noise, decoding_t=decoding_t)
        pred = out["sampled_video"].float().cpu().numpy()
        gt = out["gt_video"].float().cpu().numpy()
        metrics = {"val/psnr": float(np.mean([psnr(p, g) for p, g in zip(pred, gt)])),
                   "val/ssim": float(np.mean([ssim(p, g) for p, g in zip(pred, gt)]))}
        if lpips is not None:
            with torch.no_grad():
                d = lpips(out["sampled_video"].permute(0, 3, 1, 2) * 2.0 - 1.0,
                          out["gt_video"].permute(0, 3, 1, 2) * 2.0 - 1.0)
            metrics["val/lpips"] = float(d.mean())
        return metrics
