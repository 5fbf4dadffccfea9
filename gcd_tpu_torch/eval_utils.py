"""What the inference and evaluation entries (infer.py, test.py) share
beyond engine/bundle.py: their inputs, their outputs and the sampler they
call (port of scripts/eval_utils.py:250-555).

Inputs are PNG images (data/png.py) and `.npz` clips holding `frames`,
(T, H, W, 3) uint8 or float in [0, 1]; the machines the port runs on carry
no video codec and no image library, so any other file raises, naming the
decoder it would need. Outputs are, per video, `{name}.npz` (`frames`
uint8 (T, H, W, 3) and `fps`) and a `{name}.png` strip of up to 8 of its
frames, in place of the reference's MP4.

The entries' mesh (`add_mesh_arguments`, `join_mesh`): with `--coordinator`
their processes form one torch.distributed group (parallel/distributed.py;
NCCL on CUDA, gloo with `--device cpu`), one process a card, and
`make_sampler` splits each clip's sampling over the `--mesh_data` x
`--mesh_fsdp` x `--mesh_tensor` mesh of them (engine/serving.py). Every
process reads the same inputs and samples the same clips; process 0 alone
computes the host metrics and writes.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from gcd_tpu_torch.data.common import process_image
from gcd_tpu_torch.data.loader import batch_to_device
from gcd_tpu_torch.data.png import read_png, write_png
from gcd_tpu_torch.engine.bundle import ModelBundle, load_model_bundle
from gcd_tpu_torch.engine.image_logger import frame_strip
from gcd_tpu_torch.engine.serving import make_sharded_sampler
from gcd_tpu_torch.parallel import distributed
from gcd_tpu_torch.parallel.mesh import create_mesh

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


def quick_pca(latent: np.ndarray, k: int = 3) -> np.ndarray:
    """(T, H, W, C) latents -> (T, H, W, k) in [0, 1]: their first k
    principal components, each stretched between its 2nd and 98th
    percentile (scripts/eval_utils.py quick_pca)."""
    t, h, w, c = latent.shape
    flat = latent.reshape(-1, c).astype(np.float64)
    flat = flat - flat.mean(axis=0)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:k].T
    lo, hi = np.percentile(proj, 2, axis=0), np.percentile(proj, 98, axis=0)
    proj = (proj - lo) / np.maximum(hi - lo, 1e-8)
    return np.clip(proj.reshape(t, h, w, k), 0.0, 1.0).astype(np.float32)


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


def add_mesh_arguments(p) -> None:
    """The process-group and mesh flags of the inference entries."""
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port of process 0: sample in one torch.distributed group of "
                        "--num_processes processes, one a card (formed even for one)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=1,
                   help="shard each clip's sampling over a data mesh axis "
                        "(multi-card serving; mesh_data*mesh_fsdp*mesh_tensor processes)")
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_tensor", type=int, default=1,
                   help="Megatron tensor-parallel axis for serving (parallel/tensor.py)")


def join_mesh(args, who: str) -> bool:
    """Check the entry's mesh against --num_processes, settle the device
    (the CUDA card unless `--device cpu`; without CUDA that flag is needed)
    and join the process group when a coordinator is given. Returns
    whether a group was formed (the caller leaves it)."""
    distributed.check_sampling_mesh(args.num_processes, args.mesh_data, args.mesh_fsdp,
                                    args.mesh_tensor)
    if args.device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass --device cpu to run on the CPU")
        args.device = "cuda"
    return distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                  torch.device(args.device))


def make_sampler(bundle: ModelBundle, decoding_t: int = 14, return_latents: bool = False,
                 mesh_data: int = 1, mesh_fsdp: int = 1, mesh_tensor: int = 1
                 ) -> Callable[[Dict, int], Dict[str, np.ndarray]]:
    """sample(batch, seed) -> the engine's sample_video outputs as float32
    host arrays: the numpy batch moved to the engine's device, the latent
    noise from a torch.Generator there seeded with `seed`. In a process
    group, the clip's sampling is split over the mesh data x fsdp x tensor
    of the group's processes (engine/serving.py: the conditioner, the UNet
    evaluations and the decode; with mesh_tensor > 1 the UNet is cut over
    tensor and its weights sharded over fsdp, as JAX's make_sampler places
    them; every process gets the outputs); process 0 prints the mesh and
    the row rule's split of each UNet batch."""
    engine = bundle.engine
    device = next(engine.parameters()).device

    def run(batch, gen):
        return engine.sample_video(batch, generator=gen, decoding_t=decoding_t,
                                   return_latents=return_latents)

    if dist.is_initialized() or mesh_data * mesh_fsdp * mesh_tensor > 1:
        mesh = create_mesh(mesh_data, mesh_fsdp, mesh_tensor, device.type)
        run = make_sharded_sampler(engine, mesh, decoding_t=decoding_t,
                                   return_latents=return_latents,
                                   verbose=distributed.is_main())

    def sample(batch: Dict, seed: int) -> Dict[str, np.ndarray]:
        gen = torch.Generator(device).manual_seed(int(seed))
        out = run(batch_to_device(batch, device), gen)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    return sample
