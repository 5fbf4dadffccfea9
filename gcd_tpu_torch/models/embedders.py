"""Conditioner and embedders (port of gcd_tpu/models/embedders.py).

GeneralConditioner runs every embedder over its batch key and routes each
output (each element of a tuple output) by rank into the cond dict,
concatenating along the last axis:
    rank 2 -> "vector", rank 3 -> "crossattn", rank 4 / 5 -> "concat".
The camera embedder is last in GCD's configs, so its output is the tail of
"vector", which VideoUNet routes into `aux_label_emb`.

Batch tensors and outputs keep the JAX package's layouts (frames
(N, H, W, 3) in [-1, 1], concat latents (N, h, w, C)); the CLIP towers and
the VAE encoders run channels-first inside. Those not marked `is_trainable`
run without grad (the JAX package's stop_gradient). With `train=True` each
embedder's output is zeroed per frame with probability `ucg_rate` (the
conditioning dropout of training), from explicit keep masks or a
torch.Generator. GaussianEncoder and LowScaleEncoder draw random numbers
(`stochastic`): from a generator, or the draws passed in.

The text embedders (T5, ByT5, CLIP, OpenCLIP) take int tokens (B, S), or
strings: ByT5's byte tokens need no assets; CLIP's BPE and T5's
sentencepiece tokenizers load from transformers' local files only, imported
when a string comes, and raise the JAX package's RuntimeError where they are
absent.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gcd_tpu_torch.io.convert import hf_clip_text_to_openclip_sd
from gcd_tpu_torch.models.clip import CLIPVisionTower, clip_preprocess
from gcd_tpu_torch.models.text_towers import (
    CLIPTextTower,
    T5Encoder,
    byt5_tokenize,
)
from gcd_tpu_torch.models.vae import AutoencodingEngineLegacy, DiagonalGaussianDistribution
from gcd_tpu_torch.models.vae import Encoder as VAEEncoder
from gcd_tpu_torch.ops.basic import timestep_embedding
from gcd_tpu_torch.utils.config import instantiate_from_config
from gcd_tpu_torch.utils.resize import resize

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


class IdentityEncoder(nn.Module):
    def forward(self, x):
        return x


class ClassEmbedder(nn.Module):
    """Class-id embedding table: ids (N,) -> (N, embed_dim), or (N, 1,
    embed_dim) with `add_sequence_dim`. Key embedding.weight."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, add_sequence_dim: bool = False):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)
        self.n_classes, self.add_sequence_dim = n_classes, add_sequence_dim

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        emb = self.embedding(c.long())
        return emb[:, None, :] if self.add_sequence_dim else emb

    def get_unconditional_conditioning_value(self) -> int:
        return self.n_classes - 1


# SpatialRescaler's method -> jax.image.resize's (utils/resize.py), as
# gcd_tpu/models/embedders.py maps them; "nearest" samples half-pixel
# centres, torch's nearest-exact.
_RESCALE_METHODS = {"bilinear": "linear", "trilinear": "linear", "area": "linear",
                    "linear": "linear", "triangle": "linear", "bicubic": "cubic",
                    "cubic": "cubic", "tricubic": "cubic", "nearest": "nearest"}


def resize_nhwc(x: torch.Tensor, out_hw: Tuple[int, int], method: str) -> torch.Tensor:
    """jax.image.resize of (N, H, W, C) to out_hw: "linear" / "cubic" with
    its antialiasing (utils/resize.py), or "nearest"."""
    if method == "nearest":
        return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                             mode="nearest-exact").permute(0, 2, 3, 1)
    return resize(x, out_hw, method)


class SpatialRescaler(nn.Module):
    """n_stages resizes of (N, H, W, C) by `multiplier`, then an optional
    channel_mapper conv (out_channels, or remap_output keeping the
    channels); `wrap_video` folds a (B, T, H, W, C) video's frames into the
    batch and back."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear",
                 multiplier: float = 0.5, in_channels: int = 3,
                 out_channels: Optional[int] = None, bias: bool = False,
                 wrap_video: bool = False, kernel_size: int = 1, remap_output: bool = False):
        super().__init__()
        if method not in _RESCALE_METHODS:
            raise NotImplementedError(f"SpatialRescaler method {method!r}")
        self.n_stages, self.method, self.multiplier = n_stages, _RESCALE_METHODS[method], multiplier
        self.wrap_video = wrap_video
        if out_channels is not None or remap_output:
            self.channel_mapper = nn.Conv2d(in_channels, out_channels or in_channels,
                                            kernel_size, padding=kernel_size // 2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        video = self.wrap_video and x.dim() == 5
        if video:
            b, t = x.shape[:2]
            x = x.reshape(b * t, *x.shape[2:])
        for _ in range(self.n_stages):
            h, w = x.shape[1:3]
            x = resize_nhwc(x, (int(h * self.multiplier), int(w * self.multiplier)),
                            self.method)
        if hasattr(self, "channel_mapper"):
            conv = self.channel_mapper
            x = conv(x.permute(0, 3, 1, 2).to(conv.weight.dtype)).permute(0, 2, 3, 1)
        return x.reshape(b, t, *x.shape[1:]) if video else x


def _ddconfig(dd: Optional[Dict]) -> Dict:
    return {k: v for k, v in (dd or {}).items() if k not in ("attn_type", "lossconfig")}


def _posterior_sample(moments: torch.Tensor, noise: Optional[torch.Tensor],
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """mean + std * noise of the channel-split moments (N, 2z, h, w): the
    unit Gaussian `noise` given as (N, h, w, z), or drawn from `generator`."""
    posterior = DiagonalGaussianDistribution(moments)
    if noise is None:
        n, c, h, w = posterior.mean.shape
        noise = torch.randn(n, h, w, c, generator=generator, device=moments.device)
    return posterior.sample(noise.permute(0, 3, 1, 2))


class GaussianEncoder(VAEEncoder):
    """The VAE encoder with a sampled diagonal-Gaussian posterior:
    (N, H, W, 3) -> (N, h*w, z) (or (N, h, w, z) without flatten_output).
    The encoder's keys sit at the root, as in the reference (which
    subclasses the encoder); `weight` scales the reference's KL term and
    is kept for config parity."""

    stochastic = True

    def __init__(self, weight: float = 1.0, flatten_output: bool = True,
                 ddconfig: Optional[Dict] = None):
        super().__init__(**_ddconfig(ddconfig))
        self.weight, self.flatten_output = float(weight), flatten_output

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        moments = super().forward(x.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype))
        z = _posterior_sample(moments, noise, generator).permute(0, 2, 3, 1)
        n, h, w, c = z.shape
        return z.reshape(n, h * w, c) if self.flatten_output else z


class LowScaleEncoder(nn.Module):
    """Noise-augmented low-resolution conditioning (SD-upscaler style): the
    KL autoencoder of `model_config` (under `model.`) encodes x (N, H, W,
    3), its posterior is sampled and scaled, a DDPM noise level in [0,
    max_noise_level) per sample q-samples it, and a nearest resize brings
    it to output_size: returns ((N, s, s, z), noise_level (N,)). The draws
    (posterior noise (N, h, w, z), noise_level, q_noise (N, h, w, z)) come
    in that order from `generator`, or as given. The reference's schedule
    buffers are kept for its keys; the forward reads the schedule in fp32
    from the float64 betas, as the JAX package does."""

    stochastic = True
    num_outputs = 2

    def __init__(self, model_config: Dict, linear_start: float = 1e-4,
                 linear_end: float = 2e-2, timesteps: int = 1000, max_noise_level: int = 250,
                 output_size: Optional[int] = 64, scale_factor: float = 1.0):
        super().__init__()
        params = dict(model_config.get("params") or {})
        self.model = AutoencodingEngineLegacy(int(params.get("embed_dim", 4)),
                                              _ddconfig(params.get("ddconfig")))
        self.max_noise_level, self.output_size = int(max_noise_level), output_size
        self.scale_factor = float(scale_factor)
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas, axis=0)
        self._sqrt_acp = np.sqrt(acp).astype(np.float32)
        self._sqrt_1macp = np.sqrt(1.0 - acp).astype(np.float32)
        buffers = {"betas": betas, "alphas_cumprod": acp,
                   "alphas_cumprod_prev": np.append(1.0, acp[:-1]),
                   "sqrt_alphas_cumprod": np.sqrt(acp),
                   "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - acp),
                   "log_one_minus_alphas_cumprod": np.log(1.0 - acp),
                   "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / acp),
                   "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / acp - 1)}
        for name, value in buffers.items():
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                noise_level: Optional[torch.Tensor] = None,
                q_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        vae = self.model
        moments = vae.quant_conv(vae.encoder(x.permute(0, 3, 1, 2).to(
            vae.quant_conv.weight.dtype)))
        z = _posterior_sample(moments, noise, generator) * self.scale_factor
        b = z.shape[0]
        if noise_level is None:
            noise_level = torch.randint(0, self.max_noise_level, (b,), generator=generator,
                                        device=z.device)
        if q_noise is None:
            q_noise = torch.randn(z.shape[0], *z.shape[2:], z.shape[1], generator=generator,
                                  device=z.device)
        idx = noise_level.long().cpu().numpy()
        sa, s1 = (torch.from_numpy(t[idx]).to(z.device, z.dtype).reshape(b, 1, 1, 1)
                  for t in (self._sqrt_acp, self._sqrt_1macp))
        z = (sa * z + s1 * q_noise.permute(0, 3, 1, 2).to(z.dtype)).permute(0, 2, 3, 1)
        if self.output_size is not None:
            z = resize_nhwc(z, (self.output_size, self.output_size), "nearest")
        return z, noise_level

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, h, w, z) latents -> (N, 8h, 8w, 3) frames."""
        z = (z / self.scale_factor).permute(0, 3, 1, 2).to(self.model.quant_conv.weight.dtype)
        return self.model.decode(z).permute(0, 2, 3, 1)


# (d_model, d_ff, num_layers, num_heads, d_kv, vocab, gated_ff), the JAX
# package's table (gcd_tpu/models/embedders.py _T5_ARCHS).
T5_ARCHS = {
    "google/t5-v1_1-small": (512, 1024, 8, 6, 64, 32128, True),
    "google/t5-v1_1-base": (768, 2048, 12, 12, 64, 32128, True),
    "google/t5-v1_1-large": (1024, 2816, 24, 16, 64, 32128, True),
    "google/t5-v1_1-xl": (2048, 5120, 24, 32, 64, 32128, True),
    "google/t5-v1_1-xxl": (4096, 10240, 24, 64, 64, 32128, True),
    "google/byt5-small": (1472, 3584, 12, 6, 64, 384, True),
    "google/byt5-base": (1536, 3968, 18, 12, 64, 384, True),
    "google/byt5-large": (1536, 3840, 36, 16, 64, 384, True),
}

# (width, layers, heads, output_dim, quick_gelu) (_CLIP_TEXT_ARCHS).
CLIP_TEXT_ARCHS = {
    "openai/clip-vit-large-patch14": (768, 12, 12, None, True),
    "openai/clip-vit-base-patch32": (512, 12, 8, None, True),
    "ViT-L-14": (768, 12, 12, 768, False),
    "ViT-H-14": (1024, 24, 16, 1024, False),
    "ViT-bigG-14": (1280, 32, 20, 1280, False),
}

TextInput = Union[torch.Tensor, np.ndarray, Sequence[str]]


def tokenize_hf(texts: Sequence[str], name_or_path: str, cls: str,
                max_length: int) -> torch.Tensor:
    """Tokens (B, max_length) int32 from a transformers tokenizer found in
    its local files (no download)."""
    try:
        import transformers

        tok = getattr(transformers, cls).from_pretrained(name_or_path, local_files_only=True)
    except Exception as e:
        raise RuntimeError(
            f"{cls} assets for '{name_or_path}' are not available locally and "
            "cannot be downloaded (no egress). Pass pre-tokenized int arrays "
            "of shape (B, max_length) instead of strings.") from e
    enc = tok(list(texts), truncation=True, max_length=max_length, padding="max_length",
              return_tensors="np")
    return torch.from_numpy(enc["input_ids"].astype(np.int32))


def _tokens(text: TextInput, tokenize, device: torch.device) -> torch.Tensor:
    if isinstance(text, np.ndarray):
        text = torch.from_numpy(text)
    if not isinstance(text, torch.Tensor):
        text = tokenize(text)
    return text.to(device)


class _T5EmbedderBase(nn.Module):
    """Tokens or strings -> the T5 encoder's last hidden state (B, S,
    d_model), fp32; the tower under `transformer.` (transformers'
    T5EncoderModel names). The architecture is `version`'s (T5_ARCHS, else
    t5-v1_1-xxl's) with the given overrides; `device` names the reference's
    placement. `freeze` detaches the output."""

    default_version = "google/t5-v1_1-xxl"

    def __init__(self, version: Optional[str] = None, device: str = "cuda",
                 max_length: int = 77, freeze: bool = True, d_model: Optional[int] = None,
                 d_ff: Optional[int] = None, num_layers: Optional[int] = None,
                 num_heads: Optional[int] = None, d_kv: Optional[int] = None,
                 vocab_size: Optional[int] = None):
        super().__init__()
        self.version = version or self.default_version
        self.max_length, self.freeze = max_length, freeze
        dm, ff, nl, nh, dk, vocab, gated = T5_ARCHS.get(self.version,
                                                        T5_ARCHS["google/t5-v1_1-xxl"])
        self.transformer = T5Encoder(vocab_size or vocab, d_model or dm, d_kv or dk, d_ff or ff,
                                     num_layers or nl, num_heads or nh, gated_ff=gated)

    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, text: TextInput) -> torch.Tensor:
        tokens = _tokens(text, self.tokenize, self.transformer.shared.weight.device)
        with torch.no_grad() if self.freeze else nullcontext():
            return self.transformer(tokens)


class FrozenT5Embedder(_T5EmbedderBase):
    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        return tokenize_hf(texts, self.version, "T5Tokenizer", self.max_length)


class FrozenByT5Embedder(_T5EmbedderBase):
    default_version = "google/byt5-base"

    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        return byt5_tokenize(texts, self.max_length)


def _openclip_text_keys(module, state_dict, prefix, *unused) -> None:
    """A load_state_dict pre-hook: a transformers CLIPTextModel checkpoint
    under `transformer.` (the reference's keys) re-keyed to the tower's
    open_clip names, as the JAX package converts it."""
    head = prefix + "transformer."
    if not any(k.startswith(head + "text_model.") for k in state_dict):
        return
    hf = {k[len(head):]: state_dict.pop(k) for k in list(state_dict) if k.startswith(head)}
    state_dict.update({head + k: v for k, v in hf_clip_text_to_openclip_sd(hf).items()})


class FrozenCLIPEmbedder(nn.Module):
    """transformers' CLIPTextModel semantics under `transformer.`: layer
    "last" gives the final-LayerNorm'd states (B, S, W), "pooled" the eot
    embedding (B, 1, W), "hidden" the pre-norm states after block
    `layer_idx` (index 0 the embeddings); `always_return_pooled` adds the
    (B, W) pooled output. The tower is `version`'s (CLIP_TEXT_ARCHS, else
    clip-vit-large-patch14's) with the given overrides, a CLIPTextTower
    under open_clip's names, to which a CLIPTextModel checkpoint's keys are
    re-keyed as they load (_openclip_text_keys)."""

    def __init__(self, version: str = "openai/clip-vit-large-patch14", device: str = "cuda",
                 max_length: int = 77, freeze: bool = True, layer: str = "last",
                 layer_idx: Optional[int] = None, always_return_pooled: bool = False,
                 width: Optional[int] = None, layers: Optional[int] = None,
                 heads: Optional[int] = None, vocab_size: int = 49408):
        super().__init__()
        if layer not in ("last", "pooled", "hidden") or (layer == "hidden"
                                                          and layer_idx is None):
            raise ValueError(f"FrozenCLIPEmbedder layer {layer!r}, layer_idx {layer_idx!r}")
        w, n, h, _, quick_gelu = CLIP_TEXT_ARCHS.get(
            version, CLIP_TEXT_ARCHS["openai/clip-vit-large-patch14"])
        self.version, self.max_length, self.freeze = version, max_length, freeze
        self.layer, self.layer_idx = layer, layer_idx
        self.always_return_pooled = always_return_pooled
        self.num_outputs = 2 if always_return_pooled else 1
        self.transformer = CLIPTextTower(vocab_size, width or w, layers or n, heads or h,
                                         max_length, None, quick_gelu)
        self.register_load_state_dict_pre_hook(_openclip_text_keys)

    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        return tokenize_hf(texts, self.version, "CLIPTokenizer", self.max_length)

    def forward(self, text: TextInput):
        device = self.transformer.ln_final.weight.device
        tokens = _tokens(text, self.tokenize, device)
        with torch.no_grad() if self.freeze else nullcontext():
            out = self.transformer(tokens)
        z = {"last": out["normed"], "pooled": out["pooled"][:, None, :]}.get(self.layer)
        if z is None:
            z = out["hidden"][self.layer_idx]
        return (z, out["pooled"]) if self.always_return_pooled else z


class OpenCLIPTextModel(CLIPTextTower):
    """open_clip's CLIP with its visual tower deleted, as the reference's
    text embedders hold it: the text tower plus the unused `logit_scale`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.logit_scale = nn.Parameter(torch.full((), math.log(1 / 0.07)))


class _OpenCLIPTextBase(nn.Module):
    """The open_clip text tower under `model.`, `arch`'s (CLIP_TEXT_ARCHS,
    else ViT-H-14's) with the given overrides; strings tokenised by the
    CLIP BPE (open_clip.tokenize's vocabulary)."""

    def __init__(self, arch: str = "ViT-H-14", version: str = "laion2b_s32b_b79k",
                 device: str = "cuda", max_length: int = 77, freeze: bool = True,
                 layer: str = "last", width: Optional[int] = None,
                 layers: Optional[int] = None, heads: Optional[int] = None,
                 output_dim: Optional[int] = None, vocab_size: int = 49408):
        super().__init__()
        w, n, h, d, quick_gelu = CLIP_TEXT_ARCHS.get(arch, CLIP_TEXT_ARCHS["ViT-H-14"])
        self.max_length, self.freeze, self.layer = max_length, freeze, layer
        self.model = OpenCLIPTextModel(vocab_size, width or w, layers or n, heads or h,
                                       max_length, output_dim or d, quick_gelu)

    def tower(self, text: TextInput) -> Dict[str, object]:
        tokens = _tokens(text, lambda t: tokenize_hf(
            t, "openai/clip-vit-large-patch14", "CLIPTokenizer", self.max_length),
            self.model.token_embedding.weight.device)
        with torch.no_grad() if self.freeze else nullcontext():
            return self.model(tokens)


class FrozenOpenCLIPEmbedder(_OpenCLIPTextBase):
    """layer "last": ln_final of the last block's states; "penultimate":
    ln_final of the states entering it. (B, S, W)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.layer not in ("last", "penultimate"):
            raise ValueError(f"FrozenOpenCLIPEmbedder layer {self.layer!r}")

    def forward(self, text: TextInput) -> torch.Tensor:
        out = self.tower(text)
        return out["normed" if self.layer == "last" else "normed_penultimate"]


class FrozenOpenCLIPEmbedder2(_OpenCLIPTextBase):
    """`legacy`: ln_final of the chosen states, as FrozenOpenCLIPEmbedder.
    Otherwise the raw (pre-ln_final) states of the last block ("last",
    "pooled") or of the one before it ("penultimate"), plus with
    `always_return_pooled` the projected eot embedding (B, output_dim)."""

    def __init__(self, *args, always_return_pooled: bool = False, legacy: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if self.layer not in ("last", "penultimate", "pooled"):
            raise ValueError(f"FrozenOpenCLIPEmbedder2 layer {self.layer!r}")
        if legacy and always_return_pooled:
            raise ValueError("FrozenOpenCLIPEmbedder2: legacy does not return the pooled output")
        self.always_return_pooled, self.legacy = always_return_pooled, legacy
        self.num_outputs = 2 if always_return_pooled else 1

    def forward(self, text: TextInput):
        out = self.tower(text)
        if self.legacy:
            return out["normed" if self.layer == "last" else "normed_penultimate"]
        z = out["penultimate" if self.layer == "penultimate" else "last"]
        return (z, out["pooled"]) if self.always_return_pooled else z


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

    @property
    def stochastic(self) -> bool:
        """Whether an embedder draws random numbers (then c and uc take a
        pass each, as in the JAX package)."""
        return any(getattr(e, "stochastic", False) for e in self.embedders)

    def draw_keep(self, frames: int, generator: Optional[torch.Generator] = None,
                  device: Union[str, torch.device, None] = None) -> Dict[int, torch.Tensor]:
        """The conditioning-dropout keep masks of a training batch of
        `frames` rows, one per output of each embedder with a ucg_rate, in
        the embedders' order: (frames, K) for K outputs (`num_outputs`,
        else 1), column j the j-th output's, each kept with probability
        1 - ucg_rate."""
        return {i: torch.rand(frames, getattr(self.embedders[i], "num_outputs", 1),
                              generator=generator, device=device) < 1.0 - rate
                for i, rate in enumerate(self.ucg_rates) if rate > 0.0}

    def _embed(self, batch: Dict, train: bool = False,
               generator: Optional[torch.Generator] = None,
               ucg_keep: Optional[Dict[int, torch.Tensor]] = None
               ) -> List[Tuple[str, torch.Tensor]]:
        """(input key, output) of every embedder output, a tuple output's
        elements in order; a stochastic embedder draws from `generator`.
        With `train` each output of an embedder with a ucg_rate is kept by
        its own mask (draw_keep's layout), as the JAX package draws them."""
        out = []
        for i, (key, emb) in enumerate(zip(self.input_keys, self.embedders)):
            kwargs = {"generator": generator} if getattr(emb, "stochastic", False) else {}
            with nullcontext() if self.is_trainable[i] else torch.no_grad():
                outs = emb(batch[key], **kwargs)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            keep = None
            if train and self.ucg_rates[i] > 0.0:
                keep = (ucg_keep or {}).get(i)
                if keep is None:
                    keep = torch.rand(outs[0].shape[0], len(outs), generator=generator,
                                      device=outs[0].device) < 1.0 - self.ucg_rates[i]
                keep = keep.reshape(keep.shape[0], -1)
                if keep.shape[1] != len(outs):
                    raise ValueError(f"embedder {i}: {keep.shape[1]} keep masks for "
                                     f"{len(outs)} outputs")
            for j, e in enumerate(outs):
                if keep is not None:
                    e = keep[:, j].to(e.dtype).reshape(-1, *[1] * (e.dim() - 1)) * e
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
            if emb.dim() not in COND_KEYS_BY_NDIM:
                raise ValueError(f"an embedder output of rank {emb.dim()} (input {key!r}) "
                                 "has no conditioning key")
            name = COND_KEYS_BY_NDIM[emb.dim()]
            out[name] = torch.cat([out[name], emb], dim=-1) if name in out else emb
        return out

    def forward(self, batch: Dict, force_zero_embeddings: Optional[Sequence[str]] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                ucg_keep: Optional[Dict[int, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """With `train`, embedder i's outputs are kept per frame where
        `ucg_keep[i]` says (1 keeps, 0 zeroes): (N,) for one output, (N, K)
        for K (draw_keep's layout); or each with probability 1 - ucg_rate
        drawn from `generator`."""
        return self._route(self._embed(batch, train, generator, ucg_keep),
                           force_zero_embeddings)

    def get_unconditional_conditioning(
            self, batch: Dict, force_uc_zero_embeddings: Optional[Sequence[str]] = None,
            force_cond_zero_embeddings: Optional[Sequence[str]] = None,
            batch_uc: Optional[Dict] = None, generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(c, uc): c from `batch`, uc from `batch_uc` (else `batch`) with
        the uc keys zeroed. Deterministic embedders over one batch (every
        GCD config) take one pass, which equals the reference's second pass;
        otherwise each takes its own, c's first, the stochastic embedders
        drawing anew from `generator`."""
        if batch_uc is None and not self.stochastic:
            embs = self._embed(batch)
            return (self._route(embs, force_cond_zero_embeddings),
                    self._route(embs, force_uc_zero_embeddings))
        c = self(batch, force_cond_zero_embeddings, generator=generator)
        return c, self(batch if batch_uc is None else batch_uc, force_uc_zero_embeddings,
                       generator=generator)
