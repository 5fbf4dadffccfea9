"""Visual logs of a training run (port of gcd_tpu/engine/image_logger.py:30-101).

Every `batch_frequency` steps the first video of the step's batch is sampled
in full (25 Euler-EDM steps with CFG, decoded `min(T, 7)` frames at a time)
and written under {logdir}/images/train/ with the JAX package's file names
(scene, fps, motion bucket and the last frame's camera angles): the
conditioning, sampled and target frames stacked vertically per frame as
`{name}_sample.npz` (key "frames", (T, 3H, W, 3) float32 in [0, 1]) and a
strip of up to 8 of them as `{name}_strip.png`. The machines the port trains
on need carry no video or image library, so the frames go to .npz instead of
.mp4 and the PNG is written by the port's own writer (data/png.py).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gcd_tpu_torch.data.loader import batch_to_device
from gcd_tpu_torch.data.png import write_png


def frame_strip(video01: np.ndarray, max_frames: int = 8) -> np.ndarray:
    t = video01.shape[0]
    sel = np.linspace(0, t - 1, min(t, max_frames)).astype(int)
    return np.concatenate([video01[i] for i in sel], axis=1)


class ImageLogger:
    def __init__(self, logdir: str, batch_frequency: int = 100, disabled: bool = False,
                 log_first_step: bool = True, **unused):
        self.media_dir = os.path.join(logdir, "images", "train")
        self.batch_frequency = int(batch_frequency)
        self.disabled = disabled
        self.log_first_step = log_first_step
        os.makedirs(self.media_dir, exist_ok=True)

    def should_log(self, global_step: int) -> bool:
        if self.disabled:
            return False
        if global_step == 0:
            return self.log_first_step
        return global_step % self.batch_frequency == 0

    def _meta_name(self, global_step: int, batch: Dict) -> str:
        parts = [f"gs-{global_step:07d}"]
        for key, tag in (("scene_idx", "scn"), ("fps_id", "fps"), ("motion_bucket_id", "mbid")):
            if key in batch:
                parts.append(f"{tag}-{int(np.asarray(batch[key]).reshape(-1)[0])}")
        if "scaled_relative_angles" in batch:
            ang = np.asarray(batch["scaled_relative_angles"]).reshape(-1, 3)[-1]
            parts.append("az-%.2f_el-%.2f_r-%.2f" % (float(ang[0]), float(ang[1]),
                                                     float(ang[2])))
        return "_".join(parts)

    def log(self, engine, batch: Dict, global_step: int,
            generator: Optional[torch.Generator] = None) -> str:
        """Sample the first video of a collated numpy `batch` on the engine's
        device and write its files; returns their common path prefix."""
        t = int(np.asarray(batch["image_only_indicator"]).shape[-1])
        bt_full = np.asarray(batch["jpg"]).shape[0]
        small = {}
        for k, v in batch.items():
            if np.isscalar(v):
                small[k] = v
            elif v.ndim >= 1 and v.shape[0] == bt_full:
                small[k] = v[:t]
            else:  # image_only_indicator (B, T) and the per-example arrays
                small[k] = v[:1] if v.ndim >= 1 else v
        device = next(engine.parameters()).device
        out = engine.sample_video(batch_to_device(small, device), generator=generator,
                                  decoding_t=min(t, 7))
        rows = [out["cond_video"], out["sampled_video"]]
        if "gt_video" in out:
            rows.append(out["gt_video"])
        stack = torch.cat(rows, dim=1).float().cpu().numpy()  # frames stacked vertically
        prefix = os.path.join(self.media_dir, self._meta_name(global_step, small))
        np.savez(f"{prefix}_sample.npz", frames=stack)
        write_png(f"{prefix}_strip.png",
                  (np.clip(frame_strip(stack), 0.0, 1.0) * 255.0).astype(np.uint8))
        return prefix
