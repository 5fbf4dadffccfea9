"""LPIPS perceptual metric, VGG16 variant (port of gcd_tpu/models/lpips.py).

VGG16 features at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each
unit-normalised over its channels, squared differences weighted by the
absolute lin weights, spatial mean, summed over the five taps. The
reference's parameter names: the trunk is torchvision's `features` cut in
five slices that keep its indices (`net.slice1.0.weight` ...
`net.slice5.28.bias`), the lins are `lin{i}.model.1.weight` (1, C, 1, 1).

No weights ship with the repository and none are downloaded:
`lpips_state_dict` reads a torchvision VGG16 state dict and, optionally,
the lpips package's `vgg.pth` lin weights from local files, as
gcd_tpu/models/lpips.py load_lpips_params does. The convolutions run in
fp32 with TF32 off (`fp32_convolutions`), as JAX's default dtype is fp32.

`LatentLPIPS` is the latent L2 plus the LPIPS of decoded latents; like the
JAX class, it takes the decoder's and LPIPS's weights per call.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from gcd_tpu_torch.utils.config import instantiate_from_config
from gcd_tpu_torch.utils.resize import resize

# Channel counts of the tapped VGG16 stages.
VGG_STAGES = [64, 128, 256, 512, 512]
# torchvision VGG16 `features` conv indices per stage; each reference slice
# starts with the max pool before its first conv (except the first).
VGG_CONV_IDX = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
# The LPIPS ScalingLayer (float32 values of lpips.py's constants).
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


@contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full fp32 (TF32 off, which torch turns on for
    them by default) inside the block; restored after it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class VGG16Features(nn.Module):
    """The VGG16 trunk: five slices, the tap after each."""

    def __init__(self):
        super().__init__()
        channels = 3
        for stage, conv_ids in enumerate(VGG_CONV_IDX):
            layers = nn.Sequential()
            if stage:
                layers.add_module(str(conv_ids[0] - 1), nn.MaxPool2d(2, 2))
            for ci in conv_ids:
                layers.add_module(str(ci), nn.Conv2d(channels, VGG_STAGES[stage], 3, padding=1))
                layers.add_module(str(ci + 1), nn.ReLU())
                channels = VGG_STAGES[stage]
            self.add_module(f"slice{stage + 1}", layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, 3, H, W) in [-1, 1] -> the five taps, NCHW."""
        # Per channel with Python scalars: no host-to-device copy (a sync).
        x = torch.stack([(x[:, c].float() - SHIFT[c]) / SCALE[c] for c in range(3)], dim=1)
        taps = []
        for stage in range(len(VGG_CONV_IDX)):
            x = getattr(self, f"slice{stage + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """A tap's lin weights (`model.1.weight`, (1, C, 1, 1)), applied as
    |w|: the channel sum of diff * |w|."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, diff: torch.Tensor) -> torch.Tensor:
        return (diff * self.model[1].weight.abs()).sum(dim=1)


class LPIPS(nn.Module):
    """forward(a, b): images (N, 3, H, W) in [-1, 1] -> distances (N,),
    fp32. Both images go through the trunk as one batch."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, channels in enumerate(VGG_STAGES):
            self.add_module(f"lin{i}", NetLinLayer(channels))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with fp32_convolutions():
            taps = self.net(torch.cat([a, b]))
        total = 0.0
        for i, tap in enumerate(taps):
            unit = tap / torch.sqrt((tap ** 2).sum(dim=1, keepdim=True) + 1e-10)
            ua, ub = unit.chunk(2)
            total = total + getattr(self, f"lin{i}")((ua - ub) ** 2).mean(dim=(1, 2))
        return total


def lpips_state_dict(vgg_path: str, lins_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """LPIPS's state dict from local files: `vgg_path` a torchvision VGG16
    state dict (`features.{i}.weight/bias`; or a dict holding one under
    "state_dict"), `lins_path` the lpips `vgg.pth` lin weights
    (`lin{i}.model.1.weight`), the lins ones when it is None. Read with
    torch.load on the CPU."""
    sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out: Dict[str, torch.Tensor] = {}
    for stage, conv_ids in enumerate(VGG_CONV_IDX):
        for ci in conv_ids:
            for leaf in ("weight", "bias"):
                out[f"net.slice{stage + 1}.{ci}.{leaf}"] = sd[f"features.{ci}.{leaf}"].float()
    lins = torch.load(lins_path, map_location="cpu", weights_only=True) if lins_path else {}
    for i, channels in enumerate(VGG_STAGES):
        key = f"lin{i}.model.1.weight"
        out[key] = lins[key].float() if lins_path else torch.ones(1, channels, 1, 1)
    return out


def load_lpips(vgg_path: str, lins_path: Optional[str] = None,
               device: Optional[torch.device] = None) -> LPIPS:
    """LPIPS with `lpips_state_dict`'s weights (strict), in eval mode, on
    `device`: the card when None (raises without CUDA; pass "cpu" to run
    on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_lpips: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    model = LPIPS()
    model.load_state_dict(lpips_state_dict(vgg_path, lins_path), strict=True)
    return model.to(device).eval()


class _Decode(nn.Module):
    """forward(z) = the first stage's decode of z (NCHW latents), so that
    torch.func.functional_call can run it on given weights."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.decode(z, z.shape[0])  # a video decoder takes the frame count


class LatentLPIPS:
    """Latent-space L2 plus the LPIPS of decoded latents.

    As in the JAX class, the decoder and LPIPS hold no weights here (they
    are built on the meta device): `__call__` takes the decoder's state
    dict (`decoder_config`'s module's keys) and LPIPS's, and raises when a
    perceptual term is on and either is missing. Latents (N, C, h, w) and
    images (N, 3, H, W), images in [-1, 1]. The scale flags resize with
    jax.image.resize's bicubic (utils/resize.py: Keys a = -0.5, low-passed
    when it shrinks), as JAX resizes."""

    def __init__(self, decoder_config: Dict, perceptual_weight: float = 1.0,
                 latent_weight: float = 1.0, scale_input_to_tgt_size: bool = False,
                 scale_tgt_to_input_size: bool = False,
                 perceptual_weight_on_inputs: float = 0.0):
        if scale_input_to_tgt_size and scale_tgt_to_input_size:
            raise ValueError("LatentLPIPS: scale_input_to_tgt_size and scale_tgt_to_input_size "
                             "exclude each other")
        with torch.device("meta"):
            self.decoder = _Decode(instantiate_from_config(decoder_config))
            self.perceptual = LPIPS()
        self.perceptual_weight = perceptual_weight
        self.latent_weight = latent_weight
        self.scale_input_to_tgt_size = scale_input_to_tgt_size
        self.scale_tgt_to_input_size = scale_tgt_to_input_size
        self.perceptual_weight_on_inputs = perceptual_weight_on_inputs

    def __call__(self, latent_inputs: torch.Tensor, latent_predictions: torch.Tensor,
                 image_inputs: Optional[torch.Tensor] = None, split: str = "train",
                 decoder_params: Optional[Dict[str, torch.Tensor]] = None,
                 lpips_params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, log), as the reference's forward."""
        log = {}
        loss = (latent_inputs - latent_predictions) ** 2
        log[f"{split}/latent_l2_loss"] = loss.mean()
        if (self.perceptual_weight > 0.0 or self.perceptual_weight_on_inputs > 0.0) and (
                decoder_params is None or lpips_params is None):
            raise ValueError("LatentLPIPS with perceptual terms needs decoder_params and "
                             "lpips_params")

        def decode(z):
            return torch.func.functional_call(
                self.decoder, {f"model.{k}": v for k, v in decoder_params.items()}, (z,))

        def perceptual(a, b):
            return torch.func.functional_call(self.perceptual, lpips_params, (a, b))

        recons = None
        if self.perceptual_weight > 0.0:
            recons = decode(latent_predictions)
            p = perceptual(decode(latent_inputs), recons)
            loss = self.latent_weight * loss.mean() + self.perceptual_weight * p.mean()
            log[f"{split}/perceptual_loss"] = p.mean()
        if self.perceptual_weight_on_inputs > 0.0:
            if image_inputs is None:
                raise ValueError("LatentLPIPS: perceptual_weight_on_inputs needs image_inputs")
            if recons is None:
                recons = decode(latent_predictions)
            if self.scale_input_to_tgt_size:
                image_inputs = _bicubic(image_inputs, recons.shape[2:])
            elif self.scale_tgt_to_input_size:
                recons = _bicubic(recons, image_inputs.shape[2:])
            p2 = perceptual(image_inputs, recons)
            loss = loss + self.perceptual_weight_on_inputs * p2.mean()
            log[f"{split}/perceptual_loss_on_inputs"] = p2.mean()
        return loss, log


def _bicubic(x: torch.Tensor, hw) -> torch.Tensor:
    """(N, C, H, W) resized to hw with jax.image.resize's bicubic."""
    return resize(x.permute(0, 2, 3, 1), tuple(hw), "cubic").permute(0, 3, 1, 2)
