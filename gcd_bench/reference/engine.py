"""The plain reference of a GCD engine: conditioner, CFG-guided Euler-EDM
sampler with the v-parameterised denoiser, chunked temporal decode, and the
training loss, built from a configuration's `model` section.

It follows the published method (sgm's DiffusionEngine with GCD's loss:
one sigma per video, the focal top-k schedule) in float32 with TF32 off,
and shares no code with the program: it is handed the same inputs, weights
and random numbers as the program and computes its outputs again.
Tensors are on one device; frames and latents are channels-last at the
interface, (B*T, H, W, 3) and (B*T, h, w, 4), as the program takes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gcd_bench.reference.clip import ClipImageEmbedder
from gcd_bench.reference.layers import QLinear, timestep_embedding
from gcd_bench.reference.unet import VideoUNet
from gcd_bench.reference.vae import FirstStage, ModeOnlyAE, posterior

CLIP = "FrozenOpenCLIPImagePredictionEmbedder"
SCALAR = "ConcatTimestepEmbedderND"
FRAMES = "VideoPredictionEmbedderWithEncoder"
CAMERA = "SphericalEmbedder"
# The unconditional branch zeroes the image embeddings (sgm's sampling scripts).
UC_ZERO_KEYS = ("cond_frames", "cond_frames_without_noise")


def _params(cfg: Dict) -> Dict:
    return dict(cfg.get("params") or {})


class ScalarEmbedder(nn.Module):
    """Sinusoidal embedding of a per-frame scalar: (N,) -> (N, outdim)."""

    def __init__(self, outdim: int = 256, **unused):
        super().__init__()
        self.outdim = outdim

    def forward(self, x):
        return timestep_embedding(x.reshape(-1), self.outdim)


class FrameEncoder(nn.Module):
    """The VAE mode of the conditioning frames: (N, H, W, 3) -> (N, h, w, 4)."""

    def __init__(self, encoder_config: Dict, **unused):
        super().__init__()
        p = _params(encoder_config)
        self.encoder = ModeOnlyAE(p["embed_dim"], p["ddconfig"])

    def forward(self, frames):
        return self.encoder.encode(frames.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SphericalEmbedder(nn.Module):
    """Fourier features (x1, x2, x4) of the azimuth and elevation deltas and
    the radius delta -> Linear(13, embed_dim)."""

    def __init__(self, embed_dim: int = 128, **unused):
        super().__init__()
        self.proj = QLinear(13, embed_dim)

    def forward(self, x):
        feats = []
        for v in (x[:, 0], x[:, 1]):
            for m in (1.0, 2.0, 4.0):
                feats += [torch.cos(v * m), torch.sin(v * m)]
        return self.proj(torch.stack(feats + [x[:, 2]], dim=-1))


EMBEDDERS = {CLIP: lambda p: ClipImageEmbedder(**_params(p["open_clip_embedding_config"])),
             SCALAR: lambda p: ScalarEmbedder(**p), FRAMES: lambda p: FrameEncoder(**p),
             CAMERA: lambda p: SphericalEmbedder(**p)}
# Where each embedder's output goes: crossattn tokens, the vector, or the
# concatenated latent channels.
ROUTE = {CLIP: "crossattn", SCALAR: "vector", FRAMES: "concat", CAMERA: "vector"}


class Conditioner(nn.Module):
    def __init__(self, emb_models: List[Dict]):
        super().__init__()
        names = [e["target"].rsplit(".", 1)[-1] for e in emb_models]
        unknown = sorted(set(names) - set(EMBEDDERS))
        if unknown:
            raise NotImplementedError(f"the reference has no embedder {unknown}")
        self.embedders = nn.ModuleList(EMBEDDERS[n](_params(e)) for n, e in zip(names, emb_models))
        self.routes = [ROUTE[n] for n in names]
        self.keys = [e["input_key"] for e in emb_models]
        self.trainable = [bool(e.get("is_trainable", False)) for e in emb_models]
        self.ucg_rates = [float(e.get("ucg_rate", 0.0)) for e in emb_models]

    def forward(self, batch: Dict, zero: Tuple[str, ...] = (),
                keep: Optional[Dict[int, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """{"crossattn", "vector", "concat"} (concat channels-first); the
        outputs of the `zero` inputs zeroed; with `keep`, embedder i's rows
        kept where keep[i] is true."""
        out: Dict[str, torch.Tensor] = {}
        for i, (key, emb, route) in enumerate(zip(self.keys, self.embedders, self.routes)):
            with torch.set_grad_enabled(self.trainable[i] and torch.is_grad_enabled()):
                e = emb(batch[key].float())
            if keep is not None and i in keep:
                e = e * keep[i].reshape(-1, *[1] * (e.dim() - 1)).to(e.dtype)
            if key in zero:
                e = torch.zeros_like(e)
            out[route] = torch.cat([out[route], e], dim=-1) if route in out else e
        out["concat"] = out["concat"].permute(0, 3, 1, 2)
        return out


class _Wrapper(nn.Module):
    def __init__(self, unet: nn.Module):
        super().__init__()
        self.diffusion_model = unet


def edm_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0) -> np.ndarray:
    """Karras' rho schedule, float32, with the final 0."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return np.concatenate([((hi + ramp * (lo - hi)) ** rho).astype(np.float32),
                           np.zeros(1, np.float32)])


class Reference(nn.Module):
    """The engine of a configuration's `model` section; parameter names are
    the checkpoint's."""

    def __init__(self, model: Dict):
        super().__init__()
        p = _params(model)
        net = _params(p["network_config"])
        self.model = _Wrapper(VideoUNet(**net))
        fs = _params(p["first_stage_config"])
        enc = _params(fs["encoder_config"])
        self.first_stage_model = FirstStage(enc, _params(fs["decoder_config"]).get(
            "video_kernel_size", (3, 1, 1)))
        self.conditioner = Conditioner(_params(p["conditioner_config"])["emb_models"])
        self.scale_factor = float(p.get("scale_factor", 1.0))
        self.chunk = p.get("en_and_decode_n_samples_a_time")
        sp = _params(p["sampler_config"])
        self.num_steps = int(sp["num_steps"])
        self.sigma_max = float(_params(sp["discretization_config"]).get("sigma_max", 80.0))
        g = _params(sp["guider_config"])
        self.cfg_scale = np.linspace(g.get("min_scale", 1.0), g["max_scale"],
                                     g["num_frames"]).astype(np.float32)
        lp = _params(p["loss_fn_config"]) if p.get("loss_fn_config") else {}
        sig = _params(lp.get("sigma_sampler_config", {}))
        self.p_mean, self.p_std = float(sig.get("p_mean", 1.0)), float(sig.get("p_std", 1.6))
        self.sigma_data = float(_params(lp.get("loss_weighting_config", {})).get("sigma_data",
                                                                                 1.0))
        self.focus_top = float(lp.get("focus_top", 1.0))
        self.focus_steps = int(lp.get("focus_steps", -1))

    # The denoiser: v-parameterisation with EDM's noise input.
    def denoise(self, x, sigma, cond, indicator):
        s = sigma.reshape(-1, 1, 1, 1)
        c_skip, c_out = 1.0 / (s ** 2 + 1.0), -s / torch.sqrt(s ** 2 + 1.0)
        c_in = 1.0 / torch.sqrt(s ** 2 + 1.0)
        xin = torch.cat([x * c_in, cond["concat"]], dim=1)
        out = self.model.diffusion_model(xin, 0.25 * torch.log(sigma), cond["crossattn"],
                                         cond["vector"], indicator)
        return out * c_out + x * c_skip

    def chunks(self, n: int) -> List[slice]:
        size = self.chunk or n
        return [slice(i, min(i + size, n)) for i in range(0, n, size)]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (N, 4, h, w) -> frames (N, H, W, 3) in [0, 1], decoded in
        chunks whose length is also the decoder's temporal extent."""
        z = z / self.scale_factor
        dec = self.first_stage_model.decoder
        frames = torch.cat([dec(z[c], z[c].shape[0]) for c in self.chunks(z.shape[0])])
        return ((frames + 1.0) / 2.0).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    @torch.no_grad()
    def sample(self, batch: Dict, noise: torch.Tensor) -> torch.Tensor:
        """The sampled frames (B*T, H, W, 3) of `batch` from the unit
        Gaussian latent noise (B*T, h, w, 4)."""
        indicator = batch["image_only_indicator"].float()
        t = indicator.shape[1]
        c = self.conditioner(batch)
        uc = self.conditioner(batch, zero=UC_ZERO_KEYS)
        cond = {k: torch.cat([uc[k], c[k]]) for k in c}
        ind2 = torch.cat([indicator, indicator])
        sigmas = torch.from_numpy(edm_sigmas(self.num_steps, sigma_max=self.sigma_max)).to(
            noise.device)
        scale = torch.from_numpy(self.cfg_scale).to(noise.device)
        x = noise.permute(0, 3, 1, 2).float() * torch.sqrt(1.0 + sigmas[0] ** 2)
        for i in range(self.num_steps):
            s = sigmas[i].expand(2 * x.shape[0])
            d_u, d_c = self.denoise(torch.cat([x, x]), s, cond, ind2).chunk(2)
            shape = (x.shape[0] // t, t) + tuple(x.shape[1:])
            guided = d_u.reshape(shape) + scale.reshape(1, t, 1, 1, 1) * (
                d_c.reshape(shape) - d_u.reshape(shape))
            x = x + (sigmas[i + 1] - sigmas[i]) * (x - guided.reshape(x.shape)) / sigmas[i]
        return self.decode(x)

    def encode(self, frames: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Scaled posterior samples (N, 4, h, w) of frames (N, H, W, 3) with
        the unit Gaussian `noise` (N, h, w, 4)."""
        enc = self.first_stage_model.encoder
        x, e = frames.permute(0, 3, 1, 2).float(), noise.permute(0, 3, 1, 2).float()
        z = torch.cat([posterior(enc(x[c]), e[c]) for c in self.chunks(x.shape[0])])
        return z * self.scale_factor

    def loss(self, batch: Dict, draws: Dict, step: int) -> torch.Tensor:
        """The mean training loss of `batch` (with "jpg") on the random
        numbers `draws` at optimizer step `step`."""
        indicator = batch["image_only_indicator"].float()
        t = indicator.shape[1]
        with torch.no_grad():
            z = self.encode(batch["jpg"], draws["posterior"])
        cond = self.conditioner(batch, keep=draws.get("ucg_keep"))
        sigma = torch.exp(self.p_mean + self.p_std * draws["sigma_rand"].float())
        sigma = sigma.reshape(-1, t)[:, :1].expand(-1, t).reshape(-1)  # one sigma a video
        noised = z + draws["noise"].permute(0, 3, 1, 2).float() * sigma.reshape(-1, 1, 1, 1)
        out = self.denoise(noised, sigma, cond, indicator)
        w = (sigma ** 2 + self.sigma_data ** 2) / (sigma * self.sigma_data) ** 2
        per_value = ((out - z) ** 2).reshape(z.shape[0], -1)
        mean = per_value.mean(dim=1)
        frac = 1.0
        if self.focus_steps > 0:
            progress = min(max(step / self.focus_steps, 0.0), 1.0)
            frac = (1.0 - progress) + self.focus_top * progress
        if self.focus_top < 1.0 and frac < 1.0:
            n = per_value.shape[1]
            keep = min(max(int(n * frac), 1), n)
            per_sample = per_value.topk(keep, dim=1).values.mean(dim=1) * 0.9 + mean * 0.1
        else:
            per_sample = mean
        return (per_sample * w).mean()

    def trainable_parameters(self) -> Dict[str, nn.Parameter]:
        """What `ft_strategy: everything` trains: the whole UNet and the
        embedders marked trainable."""
        out = {}
        for name, p in self.named_parameters():
            if name.startswith("model.diffusion_model."):
                out[name] = p
            elif name.startswith("conditioner.embedders."):
                if self.conditioner.trainable[int(name.split(".")[2])]:
                    out[name] = p
        return out
