"""The model bundle of the inference entry points, and the request batch a
client builds from frames and a camera move.

Port of scripts/eval_utils.py: `ModelBundle`, `_find_train_config`,
`shorten_model_name`, `load_model_bundle` (:36-184) and `construct_batch`
(:187-239). numpy on the host; the engine is built by engine/build.py on
the card unless the CPU is asked for.

    bundle = load_model_bundle("configs/infer_kubric.yaml", "gcd_kubric.ckpt",
                               support_ema=True)
    batch = construct_batch(frames01, 30.0, 10.0, 0.0, 14, 5, 127, 0.02, False, bundle)

The port loads `.ckpt` / `.pt` / `.safetensors` and its own training
checkpoints: a run's `checkpoints/step_N` directory, or its `checkpoints`
directory for the latest step (io/checkpoint.py), with the run's config
found beside them. Orbax run directories (the JAX trainer's checkpoints) are
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pathlib
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from gcd_tpu_torch.data.common import construct_trajectory
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.engine.engine import DiffusionEngine
from gcd_tpu_torch.io.checkpoint import (STEP_RE, checkpoint_state_dict,
                                         is_training_checkpoint, latest_step,
                                         restore_checkpoint, with_ema)
from gcd_tpu_torch.models.lora import merge_lora_state_dict
from gcd_tpu_torch.utils.config import get_by_path, load_config, set_by_path

MODEL_NAME_SHORTENER = {
    "kubric": "kb", "pardom": "pd", "gradual": "gr", "direct": "di",
    "semantic": "sem", "max": "m",
}
GUIDER = "model.params.sampler_config.params.guider_config.params"


@dataclasses.dataclass
class ModelBundle:
    engine: DiffusionEngine
    train_config: Optional[Dict]
    test_config: Dict
    model_name: str
    # Camera / trajectory metadata from the train config.
    delta_azimuth_range: List[float]
    delta_elevation_range: List[float]
    delta_radius_range: List[float]
    trajectory: str
    move_time: int
    camera_control: str
    motion_bucket_range: List[int]


def _find_train_config(model_path: str) -> Optional[str]:
    """The checkpoint's sibling yaml, or the newest yaml in its run's
    configs directory."""
    cand = model_path.replace(".ckpt", ".yaml").replace(".safetensors", ".yaml")
    if os.path.exists(cand) and cand != model_path:
        return cand
    d = pathlib.Path(model_path).parent
    if d.name == "checkpoints":
        d = d.parent
    hits = sorted(glob.glob(str(d) + "/*config*/*.yaml"))
    return hits[-1] if hits else None


def shorten_model_name(model_path: str) -> str:
    if "/checkpoints" in model_path:
        return model_path.split("/checkpoints")[0].rsplit("_", 1)[-1]
    name = os.path.basename(model_path).split(".")[0]
    for k, v in MODEL_NAME_SHORTENER.items():
        name = name.replace(k, v)
    return name


def camera_metadata(train_config: Optional[Dict], test_config: Dict) -> Dict:
    """ModelBundle's camera fields: the train config's data section, or the
    defaults with the control mode taken from the embedders' input keys."""
    meta = dict(delta_azimuth_range=[0.0, 0.0], delta_elevation_range=[0.0, 0.0],
                delta_radius_range=[0.0, 0.0], trajectory="interpol_linear", move_time=0,
                camera_control="none", motion_bucket_range=[127, 127])
    if train_config is not None:
        dp = get_by_path(train_config, "data.params", {}) or {}
        for key in ("azimuth", "elevation", "radius"):
            if f"{key}_range" in dp:
                meta[f"delta_{key}_range"] = list(dp[f"delta_{key}_range"])
        for key in ("trajectory", "move_time", "camera_control"):
            if key in dp:
                meta[key] = dp[key]
        if "motion_bucket_range" in dp:
            mbr = dp["motion_bucket_range"]
            meta["motion_bucket_range"] = (list(map(int, mbr.split(",")))
                                           if isinstance(mbr, str) else list(mbr))
    if meta["camera_control"] == "none":
        # No train config: the control mode from the embedders' input keys.
        embs = get_by_path(test_config, "model.params.conditioner_config.params.emb_models",
                           []) or []
        keys = {e.get("input_key") for e in embs}
        if "scaled_relative_angles" in keys:
            meta["camera_control"] = "spherical"
        elif "scaled_relative_pose" in keys:
            meta["camera_control"] = "relative_pose"
    return meta


def training_checkpoint_weights(model_path: str) -> Dict[str, torch.Tensor]:
    """The module weights of the port's training checkpoint at `model_path`:
    a `step_N` directory, or a `checkpoints` directory (its latest step),
    with the EMA shadow's `model_ema.*` entries when the run kept one."""
    ckpt_dir = model_path.rstrip("/")
    m = STEP_RE.match(os.path.basename(ckpt_dir))
    if m:
        ckpt_dir, step = os.path.dirname(ckpt_dir), int(m.group(1))
    else:
        step = latest_step(ckpt_dir)
    if step is None or not is_training_checkpoint(os.path.join(ckpt_dir, f"step_{step}")):
        raise NotImplementedError(f"{model_path}: orbax run directories are the JAX "
                                  "package's; the port loads .ckpt / .pt / .safetensors")
    return restore_checkpoint(ckpt_dir, step)["module"]


def load_model_bundle(config_path: str, model_path: Optional[str] = None,
                      support_ema: bool = False, num_steps: Optional[int] = 25,
                      num_frames: int = 14,
                      max_scale: float = 1.5, min_scale: float = 1.0,
                      device: Optional[Union[str, torch.device]] = None,
                      dtype: torch.dtype = torch.bfloat16, guidance_interval=None,
                      verbose: bool = False) -> ModelBundle:
    """The engine of an inference config after the reference's config
    surgery (sampler steps, unless `num_steps` is None, the guider's frame count and scales, EMA use,
    and the sampler's `guidance_interval` (lo, hi) when given), with a
    released checkpoint's or a training run's weights (the EMA shadows with
    `support_ema`; LoRA adapters of a `time_lora` run merged into their base
    weights, models/lora.py; keys it lacks keep seeded random weights and
    are reported) or, without `model_path`, seeded random weights. On CUDA
    unless `device="cpu"` is asked for."""
    test_config = load_config(config_path)
    set_by_path(test_config, "model.params.ckpt_path", model_path)
    set_by_path(test_config, "model.params.use_ema", bool(support_ema))
    set_by_path(test_config, "model.params.ckpt_has_ema", bool(support_ema))
    if num_steps is not None:
        set_by_path(test_config, "model.params.sampler_config.params.num_steps", int(num_steps))
    set_by_path(test_config, GUIDER + ".num_frames", int(num_frames))
    set_by_path(test_config, GUIDER + ".max_scale", float(max_scale))
    set_by_path(test_config, GUIDER + ".min_scale", float(min_scale))
    if guidance_interval is not None:
        set_by_path(test_config, "model.params.sampler_config.params.guidance_interval",
                    [float(v) for v in guidance_interval])

    state_dict = None
    if model_path and os.path.exists(model_path):
        if os.path.isdir(model_path) or "step_" in os.path.basename(model_path):
            state_dict = training_checkpoint_weights(model_path)
            if support_ema:
                state_dict = with_ema(state_dict, verbose)
        else:
            state_dict = checkpoint_state_dict(
                model_path, use_ema=support_ema,
                ablate_unet_scratch=bool(get_by_path(test_config,
                                                     "model.params.ablate_unet_scratch", False)),
                verbose=verbose)
        state_dict = merge_lora_state_dict(state_dict)
    elif model_path and verbose:
        print(f"Warning: model path {model_path!r} not found; using random-init weights")
    engine = engine_from_config(test_config["model"], device, dtype, state_dict, strict=False)

    train_config_fp = _find_train_config(model_path) if model_path else None
    train_config = load_config(train_config_fp) if train_config_fp else None
    if train_config is None and "data" in test_config:
        train_config = test_config
    return ModelBundle(engine=engine, train_config=train_config, test_config=test_config,
                       model_name=shorten_model_name(model_path or "random"),
                       **camera_metadata(train_config, test_config))


def construct_batch(input_rgb01: np.ndarray, azimuth_deg: float, elevation_deg: float,
                    radius_m: float, input_frames: int, frame_rate: int, motion_bucket: int,
                    cond_aug: float, force_custom_mbid: bool, bundle: ModelBundle,
                    rng: Optional[np.random.Generator] = None) -> Dict:
    """The batch dict of one clip, (T, H, W, 3) frames in [0, 1], and a
    spherical camera move: frames past `input_frames` repeat the last input
    frame, cond_frames carry `cond_aug` noise, and the motion bucket follows
    the move's size unless `force_custom_mbid`."""
    rng = rng or np.random.default_rng(0)
    tc = input_rgb01.shape[0]
    rgb = input_rgb01.astype(np.float32) * 2.0 - 1.0
    if input_frames < tc:
        rgb[input_frames:] = rgb[input_frames - 1:input_frames]
    batch = {
        "motion_bucket_id": np.full((tc,), motion_bucket, dtype=np.int32),
        "fps_id": np.full((tc,), frame_rate, dtype=np.int32),
        "cond_aug": np.full((tc,), cond_aug, dtype=np.float32),
        "cond_frames_without_noise": rgb,
        "cond_frames": rgb + rng.standard_normal(rgb.shape).astype(np.float32) * cond_aug,
        "jpg": np.zeros_like(rgb),
        "image_only_indicator": np.zeros((1, tc), dtype=np.float32),
        "num_video_frames": tc,
    }
    spherical_start = np.zeros(3, dtype=np.float32)
    spherical_end = np.array([azimuth_deg, elevation_deg, radius_m], dtype=np.float32)
    if bundle.camera_control == "spherical":
        if not np.isfinite(spherical_end).all():
            raise ValueError(f"camera move {spherical_end} is not finite")
        s_src, s_dst = construct_trajectory(spherical_start, spherical_end, bundle.trajectory,
                                            tc, bundle.move_time)
        angles = s_dst - s_src
        angles[:, :2] *= np.pi / 180.0
        batch["scaled_relative_angles"] = angles.astype(np.float32)
    elif bundle.camera_control == "relative_pose":
        batch["scaled_relative_pose"] = np.zeros((tc, 3, 4), dtype=np.float32)
    mbr = bundle.motion_bucket_range
    motion_range = mbr[1] - mbr[0]
    if bundle.camera_control != "none" and not force_custom_mbid and motion_range > 0:
        my_motion = np.linalg.norm(spherical_end[0:2] - spherical_start[0:2])
        max_motion = np.linalg.norm([max(*bundle.delta_azimuth_range),
                                     max(*bundle.delta_elevation_range)])
        motion_amount = my_motion / max_motion if max_motion > 0 else 0.0
        motion_value = int(round(mbr[0] + motion_range * motion_amount))
        batch["motion_bucket_id"] = np.full((tc,), motion_value, dtype=np.int32)
    return batch
