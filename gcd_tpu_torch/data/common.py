"""Frame preprocessing, JSON helpers and trajectory construction (port of the
parts of gcd_tpu/data/common.py the Kubric path uses: :20-101, :186-208).

NHWC numpy throughout; images live in [-1, 1] float32. The resize is
PyTorch's bilinear interpolation on a CPU tensor (align_corners=False, no
antialiasing), which computes what cv2.resize(..., INTER_LINEAR) does: the
card's machine has no cv2.
"""

from __future__ import annotations

import json
import logging
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger("gcd_tpu_torch.data")


def log_retry(dataset: str, idx, retry_idx: int, max_retries: int,
              exc: BaseException) -> None:
    """Rate-limited warning for a dataset's retry loop: the first three
    retries of an item, then every tenth (a misconfigured `pcl_root` would
    otherwise look like a hang)."""
    if retry_idx < 3 or (retry_idx + 1) % 10 == 0:
        logger.warning(
            "%s: __getitem__(idx=%s) failed (retry %d/%d): %s: %s",
            dataset, idx, retry_idx + 1, max_retries,
            type(exc).__name__, exc)


class JsonNumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def load_json(fp: str):
    with open(fp, "r") as f:
        return json.load(f)


def save_json(obj, fp: str):
    with open(fp, "w") as f:
        json.dump(obj, f, cls=JsonNumpyEncoder, indent=2)


def center_crop_to_ar(img: np.ndarray, target_ar: float) -> np.ndarray:
    """Center-crop (H, W, C) to the target aspect ratio."""
    h, w = img.shape[:2]
    cur_ar = w / h
    if cur_ar > target_ar + 1e-6:
        new_w = int(round(h * target_ar))
        x0 = (w - new_w) // 2
        return img[:, x0:x0 + new_w]
    if cur_ar < target_ar - 1e-6:
        new_h = int(round(w / target_ar))
        y0 = (h - new_h) // 2
        return img[y0:y0 + new_h]
    return img


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) float32 -> (height, width, C) by bilinear interpolation with
    half-pixel centres and no antialiasing."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                      antialias=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def process_image(img: np.ndarray, center_crop: bool, frame_width: int,
                  frame_height: int) -> np.ndarray:
    """uint8 / float (H, W, 3) -> float32 (frame_height, frame_width, 3) in
    [-1, 1]."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if center_crop:
        img = center_crop_to_ar(img, frame_width / frame_height)
    if img.shape[0] != frame_height or img.shape[1] != frame_width:
        img = resize_bilinear(img, frame_width, frame_height)
    return img * 2.0 - 1.0


def construct_trajectory(spherical_start: np.ndarray, spherical_end: np.ndarray,
                         trajectory: str, model_frames: int, move_time: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """src stays at the start pose; dst interpolates start -> end over
    `move_time` frames (linear or sine ease), then holds the end pose."""
    spherical_src = np.tile(spherical_start[None], (model_frames, 1)).astype(np.float32)
    spherical_dst = np.tile(spherical_end[None], (model_frames, 1)).astype(np.float32)
    for t in range(min(move_time, model_frames)):
        if trajectory == "interpol_linear":
            alpha = t / move_time
        elif trajectory == "interpol_sine":
            alpha = (1.0 - np.cos(t / move_time * np.pi)) / 2.0
        else:
            raise ValueError(f"Unknown trajectory: {trajectory}")
        spherical_dst[t] = spherical_start * (1.0 - alpha) + spherical_end * alpha
    return spherical_src, spherical_dst
