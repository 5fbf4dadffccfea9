"""Frame preprocessing, JSON helpers and trajectory construction (port of the
parts of gcd_tpu/data/common.py the Kubric path uses: :20-101, :186-208).

NHWC numpy throughout; images live in [-1, 1] float32. The resize is
PyTorch's bilinear interpolation on a CPU tensor (align_corners=False, no
antialiasing), which computes what cv2.resize(..., INTER_LINEAR) does, and
PD frames are read by the port's own PNG reader (data/png.py): the card's
machine has no cv2 and no matplotlib (so motion's HSV colours are computed
here, and the `depth` and `instance` visualisations are not ported).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gcd_tpu_torch.data.png import read_png

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


# ---------------------------------------------------------------------------
# ParallelDomain-4D frames (gcd_tpu/data/common.py:216-292)
# ---------------------------------------------------------------------------


def get_pardom_camera_dn(ego_magic: str, view_idx: int) -> str:
    if ego_magic == "ego":
        return ["yaw-60", "yaw-0", "yaw-neg-60"][view_idx]  # left to right
    if ego_magic == "magic":
        return f"camera{view_idx}"  # back view, counterclockwise
    raise ValueError(ego_magic)


def load_pardom_frame(scene_dp: str, modality: str, camera: str, time_idx: int):
    """Raw PD frame: depth (H, W) from its .npz; a PNG modality as (H, W, 4)
    float32 in [0, 1] (alpha 255 appended to 3-channel images), or (H, W, 1)
    for a gray one; segmentation as (H, W) int64 ids R + 256 G + 65536 B."""
    if "depth" in modality:
        fp = os.path.join(scene_dp, modality, camera, f"{time_idx * 10 + 5:018d}.npz")
        return np.load(fp)["data"]
    fp = os.path.join(scene_dp, modality, camera, f"{time_idx * 10 + 5:018d}.png")
    img = read_png(fp)
    if img.shape[-1] >= 3:
        alpha = img[..., 3:4] if img.shape[-1] == 4 else np.full_like(img[..., :1], 255)
        img = np.concatenate([img[..., :3], alpha], axis=-1)
    frame = img.astype(np.float32) / 255.0
    if "segmentation" in modality:
        f = (frame * 255.0).astype(np.int64)
        frame = f[..., 0] + f[..., 1] * 256 + f[..., 2] * 256 * 256
    return frame


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) HSV in [0, 1] to RGB, as matplotlib.colors.hsv_to_rgb
    computes it (in the input's float type, at least float32)."""
    hsv = np.asarray(hsv)
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32))
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    sectors = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    for k, (rk, gk, bk) in enumerate(sectors):
        idx = (i % 6 == 0) if k == 0 else (i == k)
        r[idx], g[idx], b[idx] = rk[idx], gk[idx], bk[idx]
    idx = s == 0
    r[idx], g[idx], b[idx] = v[idx], v[idx], v[idx]
    return np.stack([r, g, b], axis=-1)


def visualize_pardom_frame(frame, modality: str, camera: str, ontology) -> np.ndarray:
    """A PD modality as (H, W, 3) float32 in [0, 1]: rgb, semantic, surface
    and motion. `depth` needs matplotlib's plasma table and `instance` an
    instance colour map that the ontology does not build: both raise."""
    if "depth" in modality:
        raise NotImplementedError(f"{modality}: the depth visualisation (matplotlib's "
                                  "plasma colour table) is not ported")
    if "instance" in modality:
        raise NotImplementedError(f"{modality}: the instance visualisation needs an "
                                  "instance_id_rgb_map, which no ontology builds")
    if "motion" in modality:
        dx = frame[..., 0] + frame[..., 1] * 256.0 - 128.0
        dy = frame[..., 2] + frame[..., 3] * 256.0 - 128.0
        angle = np.arctan2(dy, dx)
        mag = np.sqrt(dx**2 + dy**2)
        hue = (angle + np.pi) / (2.0 * np.pi)
        value = np.clip(np.sqrt(mag / (mag.max() + 1e-7)), 0.0, 1.0)
        hsv = np.stack([hue, np.ones_like(hue), value], axis=-1)
        return hsv_to_rgb(hsv).astype(np.float32)
    if "rgb" in modality:
        return frame[..., 0:3].astype(np.float32)
    if "semantic" in modality:
        return np.asarray(ontology["semantic_id_rgb_map"])[frame].astype(np.float32)
    if "surface" in modality:
        return frame[..., 0:3].astype(np.float32)
    raise ValueError(modality)


def load_pardom_video_vis_frames(scene_dp, modality, ego_magic, view_inds, ontology,
                                 clip_frames, center_crop, frame_width, frame_height):
    """(T, H, W, 3) float32 in [-1, 1]: one view's (or one view a frame's)
    frames of a modality ("segm" is semantic_segmentation_2d), visualised and
    processed."""
    if modality == "segm":
        modality = "semantic_segmentation_2d"
    if not isinstance(view_inds, list):
        view_inds = [view_inds] * len(clip_frames)
    frames = []
    for view_idx, frame_idx in zip(view_inds, clip_frames):
        camera = get_pardom_camera_dn(ego_magic, view_idx)
        raw = load_pardom_frame(scene_dp, modality, camera, frame_idx)
        vis = visualize_pardom_frame(raw, modality, camera, ontology)
        frames.append(process_image(vis, center_crop, frame_width, frame_height))
    return np.stack(frames)
