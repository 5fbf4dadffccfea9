"""Model FLOPs from the configuration's widths: the reference's forward
passes at the cell's shapes on the meta device, counted by
torch.utils.flop_counter (matrix products and convolutions; elementwise
work is not counted).

  clip_flops:  one clip sampled: the conditioner on its T frames, each
               sampler step's UNet evaluation on the CFG-doubled 2T rows,
               the decode of its T frames;
  train_flops: one step on B clips: 3x the UNet's forward (forward and
               backward, no credit for recomputation), plus the frozen
               encodes the loss runs once (the target frames' VAE encoder,
               the conditioner).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def _meta_reference(model_cfg: Dict):
    from gcd_bench.reference.engine import Reference

    with torch.device("meta"):
        return Reference(model_cfg).eval().requires_grad_(False)


def _count(fn) -> int:
    with torch.device("meta"), torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _batch(clips: int, frames: int, h: int, w: int) -> Dict[str, torch.Tensor]:
    n = clips * frames
    with torch.device("meta"):
        return {"cond_frames": torch.empty(n, h, w, 3), "cond_frames_without_noise":
                torch.empty(n, h, w, 3), "cond_aug": torch.empty(n), "fps_id": torch.empty(n),
                "motion_bucket_id": torch.empty(n), "scaled_relative_angles": torch.empty(n, 3),
                "image_only_indicator": torch.zeros(clips, frames), "jpg": torch.empty(n, h, w, 3)}


def _unet(ref, rows: int, clips: int, frames: int, h: int, w: int) -> int:
    batch = _batch(clips, frames, h, w)
    cond = {}

    def conditioner():
        cond.update(ref.conditioner(batch))

    conditioner()  # shapes of the conditioning, uncounted here
    reps = rows // (clips * frames)
    c = {k: torch.cat([v] * reps) for k, v in cond.items()}
    indicator = torch.cat([batch["image_only_indicator"]] * reps)
    with torch.device("meta"):
        x = torch.empty(rows, 4, h // 8, w // 8)
        sigma = torch.ones(rows)
    return _count(lambda: ref.denoise(x, sigma, c, indicator))


def clip_flops(config: Dict) -> float:
    ref = _meta_reference(config["model"])
    t, h, w = int(config["frames"]), int(config["height"]), int(config["width"])
    batch = _batch(1, t, h, w)
    cond = _count(lambda: ref.conditioner(batch))
    with torch.device("meta"):
        z = torch.empty(t, 4, h // 8, w // 8)
    decode = _count(lambda: ref.decode(z))
    return float(cond + ref.num_steps * _unet(ref, 2 * t, 1, t, h, w) + decode)


def train_flops(config: Dict, clips: int) -> float:
    ref = _meta_reference(config["model"])
    t, h, w = int(config["frames"]), int(config["height"]), int(config["width"])
    batch = _batch(clips, t, h, w)
    with torch.device("meta"):
        noise = torch.empty(clips * t, h // 8, w // 8, 4)
    frozen = _count(lambda: ref.encode(batch["jpg"], noise)) + _count(
        lambda: ref.conditioner(batch))
    return float(3 * _unet(ref, clips * t, clips, t, h, w) + frozen)
