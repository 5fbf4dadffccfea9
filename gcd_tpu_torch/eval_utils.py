"""What the inference and evaluation entries (infer.py, test.py) share
beyond engine/bundle.py: their inputs, their outputs and the sampler they
call (port of scripts/eval_utils.py:250-555).

Inputs are PNG images (data/png.py) and `.npz` clips holding `frames`,
(T, H, W, 3) uint8 or float in [0, 1]; the machines the port runs on carry
no video codec and no image library, so any other file raises, naming the
decoder it would need. Outputs are, per video, `{name}.npz` (`frames`
uint8 (T, H, W, 3) and `fps`) and a `{name}.png` strip of up to 8 of its
frames, in place of the reference's MP4.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List

import numpy as np
import torch

from gcd_tpu_torch.data.common import process_image
from gcd_tpu_torch.data.loader import batch_to_device
from gcd_tpu_torch.data.png import read_png, write_png
from gcd_tpu_torch.engine.bundle import ModelBundle, load_model_bundle
from gcd_tpu_torch.engine.image_logger import frame_strip

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
VIDEO_EXTS = (".npz", ".mp4", ".avi", ".mov", ".webm", ".gif", ".mkv")


def resolve_input_paths(spec: str) -> List[str]:
    """A file, a directory (its images and videos), a glob, or a .txt list
    of paths (relative ones from the list's directory; # comments)."""
    if spec.endswith(".txt"):
        base = os.path.dirname(os.path.abspath(spec))
        with open(spec) as f:
            lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        return [ln if os.path.isabs(ln) else os.path.join(base, ln) for ln in lines]
    if os.path.isdir(spec):
        out = []
        for ext in IMAGE_EXTS + VIDEO_EXTS:
            out += glob.glob(os.path.join(spec, f"*{ext}"))
        return sorted(out)
    if any(ch in spec for ch in "*?["):
        return sorted(glob.glob(spec))
    return [spec]


def _rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) with C = 1-4 (gray, gray + alpha, RGB, RGBA) -> (H, W, 3)."""
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def load_npz_frames(fp: str) -> np.ndarray:
    """An .npz clip's `frames`, (T, H, W, 3) uint8 or float in [0, 1]."""
    with np.load(fp) as z:
        if "frames" not in z.files:
            raise ValueError(f"{fp}: no 'frames' array (has {z.files})")
        frames = z["frames"]
    if frames.ndim != 4 or frames.shape[-1] != 3 or len(frames) == 0:
        raise ValueError(f"{fp}: frames {frames.shape}, expected (T, H, W, 3)")
    if frames.dtype != np.uint8:
        if not np.issubdtype(frames.dtype, np.floating):
            raise ValueError(f"{fp}: frames of {frames.dtype}, expected uint8 or float")
        if not (np.isfinite(frames).all() and frames.min() >= 0.0 and frames.max() <= 1.0):
            raise ValueError(f"{fp}: float frames outside [0, 1]")
    return frames


def load_image_or_video(fp: str, num_frames: int, frame_offset: int = 0,
                        frame_stride: int = 1, center_crop: bool = True,
                        frame_width: int = 384, frame_height: int = 256) -> np.ndarray:
    """(num_frames, H, W, 3) float32 in [0, 1]: a .png repeated num_frames
    times, or frames offset + i * stride of an .npz clip (clipped to its
    last frame), each cropped to the aspect ratio and resized."""
    ext = os.path.splitext(fp)[1].lower()

    def frame01(img):
        return (process_image(img, center_crop, frame_width, frame_height) + 1.0) / 2.0

    if ext == ".png":
        return np.tile(frame01(_rgb(read_png(fp)))[None], (num_frames, 1, 1, 1))
    if ext == ".npz":
        video = load_npz_frames(fp)
        idx = np.clip(np.arange(num_frames) * frame_stride + frame_offset, 0, len(video) - 1)
        return np.stack([frame01(video[i]) for i in idx])
    need = "a video codec" if ext in VIDEO_EXTS else f"a {ext or 'format'} image decoder"
    raise ValueError(f"{fp}: reading it needs {need}, which the port does not have; "
                     "give a .png image or an .npz clip of 'frames' (T, H, W, 3)")


def to_uint8(video01: np.ndarray) -> np.ndarray:
    return (np.clip(video01, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_video_and_frames(out_dp: str, name: str, video01: np.ndarray, fps: int = 8,
                           save_frames: bool = False) -> None:
    """{out_dp}/{name}.npz (uint8 `frames`, `fps`) and {name}.png (a strip
    of up to 8 frames); with `save_frames`, {name}/{i:04d}.png, one RGB PNG
    a frame."""
    os.makedirs(out_dp, exist_ok=True)
    frames = to_uint8(video01)
    np.savez(os.path.join(out_dp, f"{name}.npz"), frames=frames, fps=np.int64(fps))
    write_png(os.path.join(out_dp, f"{name}.png"), to_uint8(frame_strip(video01)))
    if save_frames:
        frames_dp = os.path.join(out_dp, name)
        os.makedirs(frames_dp, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(frames_dp, f"{i:04d}.png"), frame)


def sample_seed(seed: int, *path: int) -> int:
    """The noise seed of the sample at `path` (input, sample) of a run
    seeded with `seed`: a numpy SeedSequence of them all."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0] >> 1)


def load_bundle(config_path: str, model_path: str, args) -> ModelBundle:
    """load_model_bundle with an entry's arguments: the sampler's steps,
    frames, guider scales and `--guidance_interval` ("lo,hi"), EMA use, and
    the device (the card in bf16, `--device cpu` in fp32)."""
    interval = args.guidance_interval
    return load_model_bundle(
        config_path, model_path, support_ema=bool(args.support_ema), num_steps=args.num_steps,
        num_frames=args.num_frames, max_scale=args.guider_max_scale,
        min_scale=args.guider_min_scale, device=args.device,
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16,
        guidance_interval=tuple(float(v) for v in interval.split(",")) if interval else None,
        verbose=True)


def make_sampler(bundle: ModelBundle, decoding_t: int = 14, return_latents: bool = False
                 ) -> Callable[[Dict, int], Dict[str, np.ndarray]]:
    """sample(batch, seed) -> the engine's sample_video outputs as float32
    host arrays: the numpy batch moved to the engine's device, the latent
    noise from a torch.Generator there seeded with `seed`. One card; the
    reference's mesh serving is not ported."""
    engine = bundle.engine
    device = next(engine.parameters()).device

    def sample(batch: Dict, seed: int) -> Dict[str, np.ndarray]:
        gen = torch.Generator(device).manual_seed(int(seed))
        out = engine.sample_video(batch_to_device(batch, device), generator=gen,
                                  decoding_t=decoding_t, return_latents=return_latents)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    return sample
