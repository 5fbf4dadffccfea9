"""What every driver shares: the run's record, the seeded weights and
inputs, the hooks that time UNet evaluations, and the result line.

A run builds the program under test (gcd_tpu_torch) from the cell's
configuration file with weights drawn from --seed, warms it up on the
cell's own shapes, measures for --seconds, and afterwards frees it and
checks what it produced against the plain reference (gcd_bench/reference).
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "gcd_bench"

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BPS = 3.35e12

# Keeps the weights' stream apart from the inputs' stream of one seed.
WEIGHT_STREAM = 0x5EED
SEED_MOD = 2 ** 63


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def stream_seed(seed: int, *parts: int) -> int:
    """A generator seed for one stream of a run's seed (a 63-bit mix)."""
    h = int(seed) % SEED_MOD
    for p in parts:
        h = (h * 6364136223846793005 + int(p) + 1442695040888963407) % SEED_MOD
    return h


@dataclass
class Run:
    """One run of one cell: its settings, and what the drivers and the
    metric readers record."""

    workload: str
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    process_start: float = 0.0  # epoch seconds
    # Filled by the drivers.
    setup_s: Optional[float] = None
    window_start: float = 0.0
    window_end: float = 0.0
    attempted: int = 0
    failed: int = 0
    done: List[Dict] = field(default_factory=list)  # per request, clip or step
    batch_fill: List[int] = field(default_factory=list)
    enqueue_ms: List[float] = field(default_factory=list)
    memory_peak_bytes: int = 0
    profile: Any = None  # profile.Slices
    checks: List[Tuple[str, float, float]] = field(default_factory=list)
    notes: Dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    @property
    def frames(self) -> int:
        return int(self.config["frames"])

    @property
    def frame_hw(self) -> Tuple[int, int]:
        return int(self.config["height"]), int(self.config["width"])

    def limit(self, name: str) -> float:
        return float(self.limits[name])

    def check(self, name: str, value: float) -> None:
        self.checks.append((name, float(value), self.limit(name)))

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0 and bool(self.checks)
                and all(v == v and v <= lim for _, v, lim in self.checks))


# --- weights ---------------------------------------------------------------

def reference_shapes(model_cfg: Dict) -> Tuple[List[Tuple[str, torch.Size]], List[str]]:
    """(key, shape) of every tensor of the configuration's engine, from the
    reference built on the meta device (the checkpoint's key space), and
    the keys of its normalisations' scales and shifts."""
    from torch import nn

    from gcd_bench.reference.engine import Reference
    from gcd_bench.reference.layers import GroupNorm

    with torch.device("meta"):
        ref = Reference(model_cfg)
    norms = [f"{name}.{p}" for name, m in ref.named_modules()
             if isinstance(m, (GroupNorm, nn.LayerNorm)) for p in ("weight", "bias")]
    return [(k, v.shape) for k, v in ref.state_dict().items()], norms


def seeded_weights(model_cfg: Dict, seed: int, std: float, device: torch.device,
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The run's weights, as a trained checkpoint's normalisations hold them
    (scales 1, shifts 0) and N(0, std) on every other tensor, drawn on
    `device` in one call from the seed into one buffer of `dtype`, as views
    by key. (With N(0, std) scales too, every normalised activation shrinks
    by std and the sampled frames hardly depend on the UNet.)"""
    shapes, norms = reference_shapes(model_cfg)
    sizes = [s.numel() for _, s in shapes]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(stream_seed(seed, WEIGHT_STREAM))
    flat.normal_(0.0, std, generator=gen)
    weights = {k: v.view(s) for (k, s), v in zip(shapes, flat.split(sizes))}
    for k in norms:
        weights[k].fill_(1.0 if k.endswith(".weight") else 0.0)
    return weights


def reference_weights(model_cfg: Dict, seed: int, std: float, device: torch.device,
                      served_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The same weights as float32 copies, tensor by tensor."""
    sd = seeded_weights(model_cfg, seed, std, device, served_dtype)
    out = {}
    for k in list(sd):
        out[k] = sd.pop(k).float()
    return out


def build_reference(model_cfg: Dict, weights: Dict[str, torch.Tensor], quant=None,
                    checkpoint: Optional[bool] = None):
    """The reference engine on the weights' device, float32, TF32 off."""
    from gcd_bench.reference.engine import Reference
    from gcd_bench.reference.layers import set_quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        ref = Reference(model_cfg)
    ref.load_state_dict(weights, strict=True, assign=True)
    if checkpoint is not None:
        ref.model.diffusion_model.use_checkpoint = checkpoint
    return set_quant(ref.eval(), quant)


# --- inputs ----------------------------------------------------------------

def random_clips(gen: torch.Generator, clips: int, frames: int, hw: Tuple[int, int],
                 device: torch.device, target: bool = False) -> Dict[str, torch.Tensor]:
    """A batch of `clips` random clips as the data modules hand them over:
    frames uniform in [-1, 1], their copies with cond_aug 0.02 noise, fps_id
    5, motion_bucket_id 127, random camera moves, and with `target` the
    frames to learn ("jpg")."""
    n = clips * frames
    h, w = hw

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    cond = rand(n, h, w, 3) * 2.0 - 1.0
    batch = {"cond_frames": cond + 0.02 * torch.randn(cond.shape, generator=gen, device=device),
             "cond_frames_without_noise": cond,
             "cond_aug": torch.full((n,), 0.02, device=device),
             "fps_id": torch.full((n,), 5.0, device=device),
             "motion_bucket_id": torch.full((n,), 127.0, device=device),
             "scaled_relative_angles": (rand(n, 3) * 2.0 - 1.0) * 0.5,
             "image_only_indicator": torch.zeros(clips, frames, device=device)}
    if target:
        batch["jpg"] = rand(n, h, w, 3) * 2.0 - 1.0
    return batch


def clip_pool(run: Run) -> List[Dict[str, torch.Tensor]]:
    """The run's distinct clips, one batch each, made on the card from the seed."""
    gen = torch.Generator(run.device).manual_seed(stream_seed(run.seed, 1))
    return [random_clips(gen, 1, run.frames, run.frame_hw, run.device)
            for _ in range(int(run.traffic["clips_in_pool"]))]


def latent_noise(seed: int, frames: int, hw: Tuple[int, int], device: torch.device):
    """A clip's unit Gaussian latent noise (T, h, w, 4) from a generator on
    `device` seeded with `seed`, as the served path draws it."""
    gen = torch.Generator(device).manual_seed(int(seed))
    return torch.randn((frames, hw[0] // 8, hw[1] // 8, 4), generator=gen, device=device)


def sample_indices(seed: int, n: int, k: int) -> List[int]:
    """k of range(n) drawn from the seed (all of them when k >= n)."""
    if k >= n:
        return list(range(n))
    gen = torch.Generator().manual_seed(stream_seed(seed, 2))
    return sorted(torch.randperm(n, generator=gen)[:k].tolist())


def frames_gap(produced: torch.Tensor, expected: torch.Tensor) -> float:
    """|produced - expected| over |expected - its mean| (L2 over the clip):
    the error as a share of the reference's own variation."""
    e = expected.double()
    return float((produced.double() - e).norm() / (e - e.mean()).norm().clamp_min(1e-30))


# --- spans -----------------------------------------------------------------

class UNetSpans:
    """Forward hooks on the UNet: the host ms from the start to the return
    of each call (no synchronise), and a `bench.unet` profiler range."""

    NAME = "bench.unet"

    def __init__(self, unet: torch.nn.Module):
        self.ms: List[float] = []
        self._local = threading.local()
        self._handles = [unet.register_forward_pre_hook(self._pre),
                         unet.register_forward_hook(self._post)]

    def _pre(self, module, args):
        rf = torch.autograd.profiler.record_function(self.NAME)
        rf.__enter__()
        self._local.open = (time.perf_counter(), rf)

    def _post(self, module, args, out):
        t0, rf = self._local.open
        rf.__exit__(None, None, None)
        self.ms.append(1e3 * (time.perf_counter() - t0))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


# --- result ----------------------------------------------------------------

def device_record(run: Run, count: int) -> Dict:
    props = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
             "kind": (torch.cuda.get_device_name(0) if run.device.type == "cuda"
                      else "cpu"),
             "count": count, "memory_peak_bytes": int(run.memory_peak_bytes)}
    limit = power_limit()
    if limit:
        props["power_limit"] = limit
    if run.trace and run.profile is not None:
        props["busy_s"] = run.profile.busy_s
        props["window_s"] = run.profile.window_s
    return props


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (inclusive method) of at least two values."""
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1]
