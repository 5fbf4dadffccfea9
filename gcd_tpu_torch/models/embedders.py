"""Conditioner and embedders (port of gcd_tpu/models/embedders.py).

GeneralConditioner runs every embedder over its batch key and routes each
output by rank into the cond dict, concatenating along the last axis:
    rank 2 -> "vector", rank 3 -> "crossattn", rank 4 -> "concat".
The camera embedder is last in GCD's configs, so its output is the tail of
"vector", which VideoUNet routes into `aux_label_emb`.

Batch tensors and outputs keep the JAX package's layouts (frames
(N, H, W, 3) in [-1, 1], concat latents (N, h, w, C)); the CLIP tower and the
VAE encoder run channels-first inside. Every embedder is deterministic;
those not marked `is_trainable` run without grad (the JAX package's
stop_gradient). With `train=True` each embedder's output is zeroed per frame
with probability `ucg_rate` (the conditioning dropout of training), from
explicit keep masks or a torch.Generator.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from gcd_tpu_torch.models.clip import CLIPVisionTower, clip_preprocess
from gcd_tpu_torch.ops.basic import timestep_embedding
from gcd_tpu_torch.utils.config import instantiate_from_config

COND_KEYS_BY_NDIM = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}


class FrozenOpenCLIPImageEmbedder(nn.Module):
    """CLIP ViT-H/14 image embedding: (N, H, W, 3) in [-1, 1] ->
    (N, output_dim). Keys model.visual.* (the open_clip model object). The
    clip_* arguments shrink the tower (tests, tiny configs)."""

    def __init__(self, arch: str = "ViT-H-14", version: str = "laion2b_s32b_b79k",
                 device: str = "cuda", max_length: int = 77, freeze: bool = True,
                 antialias: bool = True, ucg_rate: float = 0.0,
                 unsqueeze_dim: bool = False, repeat_to_max_len: bool = False,
                 num_image_crops: int = 0, output_tokens: bool = False,
                 init_device: Optional[str] = None, clip_width: int = 1280,
                 clip_layers: int = 32, clip_heads: int = 16, clip_patch_size: int = 14,
                 clip_image_size: int = 224, clip_output_dim: int = 1024):
        super().__init__()
        # arch / version / device / max_length / freeze / init_device name the
        # reference's open_clip download; the tower's shape is the clip_* set.
        unsupported = {"output_tokens": output_tokens, "unsqueeze_dim": unsqueeze_dim,
                       "repeat_to_max_len": repeat_to_max_len,
                       "num_image_crops": num_image_crops, "ucg_rate": ucg_rate}
        for name, value in unsupported.items():
            if value:
                raise NotImplementedError(f"FrozenOpenCLIPImageEmbedder: {name}={value!r} "
                                          "is not implemented (GCD uses the default)")
        self.antialias, self.image_size = antialias, clip_image_size
        self.model = nn.ModuleDict({"visual": CLIPVisionTower(
            clip_width, clip_layers, clip_heads, clip_patch_size, clip_image_size,
            clip_output_dim)})

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = clip_preprocess(image.permute(0, 3, 1, 2), self.image_size, self.antialias)
        return self.model["visual"](x)


class FrozenOpenCLIPImagePredictionEmbedder(nn.Module):
    """(B*T, H, W, 3) -> (B*n_copies, n_cond_frames, output_dim) crossattn
    tokens."""

    def __init__(self, open_clip_embedding_config: Dict, n_cond_frames: int = 1,
                 n_copies: int = 1):
        super().__init__()
        params = dict(open_clip_embedding_config.get("params") or {})
        params.pop("freeze", None)
        self.open_clip = FrozenOpenCLIPImageEmbedder(**params)
        self.n_cond_frames, self.n_copies = n_cond_frames, n_copies

    def forward(self, vid: torch.Tensor) -> torch.Tensor:
        z = self.open_clip(vid)
        z = z.reshape(z.shape[0] // self.n_cond_frames, self.n_cond_frames, z.shape[-1])
        return z.repeat_interleave(self.n_copies, dim=0)


class ConcatTimestepEmbedderND(nn.Module):
    """Sinusoidal embedding of each scalar of (N,) or (N, D), concatenated:
    (N, D * outdim), fp32."""

    def __init__(self, outdim: int = 256):
        super().__init__()
        self.outdim = outdim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            x = x[:, None]
        b, dims = x.shape
        return timestep_embedding(x.reshape(-1), self.outdim).reshape(b, dims * self.outdim)


class VideoPredictionEmbedderWithEncoder(nn.Module):
    """VAE-encodes the (noised) conditioning frames, all in one call, into
    concat latents: (B*T, H, W, 3) -> (B*n_copies, H/8, W/8, T_cond * C)
    with the posterior's mode. GCD adds the cond_aug noise in the data
    pipeline, so there is no sigma sampler here."""

    def __init__(self, encoder_config: Dict, n_cond_frames: int = 1, n_copies: int = 1,
                 is_ae: bool = False, scale_factor: float = 1.0,
                 disable_encoder_autocast: bool = False,
                 en_and_decode_n_samples_a_time: Optional[int] = None,
                 sigma_sampler_config: Optional[Dict] = None,
                 sigma_cond_config: Optional[Dict] = None):
        super().__init__()
        # is_ae / disable_encoder_autocast / en_and_decode_n_samples_a_time
        # steer the reference's autocast and chunking; frames are encoded in
        # one call in the parameter dtype, as in the JAX package.
        if sigma_sampler_config is not None:
            raise NotImplementedError("GCD adds cond_aug noise in the data pipeline; "
                                      "a sigma sampler here is not implemented")
        self.encoder = instantiate_from_config(encoder_config)
        self.n_cond_frames, self.n_copies = n_cond_frames, n_copies
        self.scale_factor = float(scale_factor)

    def forward(self, vid: torch.Tensor) -> torch.Tensor:
        x = vid.permute(0, 3, 1, 2).to(self.encoder.quant_conv.weight.dtype)
        z = self.encoder.encode(x) * self.scale_factor  # (B*T, C, h, w)
        bt, c, h, w = z.shape
        z = z.reshape(bt // self.n_cond_frames, self.n_cond_frames * c, h, w)
        return z.permute(0, 2, 3, 1).repeat_interleave(self.n_copies, dim=0)


class CameraEmbedder(nn.Module):
    """Linear(12 -> embed_dim) over the flattened 3x4 relative pose.
    `zero_init` only concerns training from scratch."""

    def __init__(self, embed_dim: int = 128, zero_init: bool = False):
        super().__init__()
        self.proj = nn.Linear(12, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-2:]) != (3, 4):
            raise ValueError(f"CameraEmbedder: expected (..., 3, 4), got {tuple(x.shape)}")
        return self.proj(x.reshape(*x.shape[:-2], 12).to(self.proj.weight.dtype))


class SphericalEmbedder(nn.Module):
    """Fourier features (1, 2, 4 x) of the azimuth and elevation deltas plus
    the raw radius delta -> Linear(13 -> embed_dim). `zero_init` only
    concerns training from scratch."""

    def __init__(self, embed_dim: int = 128, zero_init: bool = False):
        super().__init__()
        self.proj = nn.Linear(13, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 3:
            raise ValueError(f"SphericalEmbedder: expected (..., 3), got {tuple(x.shape)}")

        def fourier(v):
            return [f(v * m) for m in (1.0, 2.0, 4.0) for f in (torch.cos, torch.sin)]

        feats = fourier(x[..., 0]) + fourier(x[..., 1]) + [x[..., 2]]
        return self.proj(torch.stack(feats, dim=-1).to(self.proj.weight.dtype))


class GeneralConditioner(nn.Module):
    """Runs the embedders of `emb_models` (reference config entries with
    target / params / input_key / is_trainable / ucg_rate) and assembles
    {vector, crossattn, concat}."""

    def __init__(self, emb_models: Sequence[Dict] = ()):
        super().__init__()
        self.embedders = nn.ModuleList(instantiate_from_config(cfg) for cfg in emb_models)
        self.input_keys = [cfg["input_key"] for cfg in emb_models]
        self.is_trainable = [bool(cfg.get("is_trainable", False)) for cfg in emb_models]
        self.ucg_rates = [float(cfg.get("ucg_rate", 0.0)) for cfg in emb_models]

    def _embed(self, batch: Dict, train: bool = False,
               generator: Optional[torch.Generator] = None,
               ucg_keep: Optional[Dict[int, torch.Tensor]] = None
               ) -> List[Tuple[str, torch.Tensor]]:
        out = []
        for i, (key, emb) in enumerate(zip(self.input_keys, self.embedders)):
            with nullcontext() if self.is_trainable[i] else torch.no_grad():
                e = emb(batch[key])
            if train and self.ucg_rates[i] > 0.0:
                keep = (ucg_keep or {}).get(i)
                if keep is None:
                    keep = torch.rand(e.shape[0], generator=generator,
                                      device=e.device) < 1.0 - self.ucg_rates[i]
                e = keep.to(e.dtype).reshape(-1, *[1] * (e.dim() - 1)) * e
            out.append((key, e))
        return out

    @staticmethod
    def _route(embs: List[Tuple[str, torch.Tensor]],
               force_zero_embeddings: Optional[Sequence[str]]) -> Dict[str, torch.Tensor]:
        zero = set(force_zero_embeddings or ())
        out: Dict[str, torch.Tensor] = {}
        for key, emb in embs:
            if key in zero:
                emb = torch.zeros_like(emb)
            name = COND_KEYS_BY_NDIM[emb.dim()]
            out[name] = torch.cat([out[name], emb], dim=-1) if name in out else emb
        return out

    def forward(self, batch: Dict, force_zero_embeddings: Optional[Sequence[str]] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                ucg_keep: Optional[Dict[int, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """With `train`, embedder i's output is kept per frame where
        `ucg_keep[i]` ((N,), 1 keeps, 0 zeroes) says, or with probability
        1 - ucg_rate drawn from `generator`."""
        return self._route(self._embed(batch, train, generator, ucg_keep),
                           force_zero_embeddings)

    def get_unconditional_conditioning(
            self, batch: Dict, force_uc_zero_embeddings: Optional[Sequence[str]] = None,
            force_cond_zero_embeddings: Optional[Sequence[str]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(c, uc) from one pass of the embedders: they are frozen and
        deterministic, so this equals the reference's second pass over the
        same batch with the uc keys zeroed."""
        embs = self._embed(batch)
        return (self._route(embs, force_cond_zero_embeddings),
                self._route(embs, force_uc_zero_embeddings))
