"""What the served and the single-clip drivers share: the engine built from
the cell's configuration, and the check of sampled clips against the
reference."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from gcd_bench.harness import (Run, build_reference, frames_gap, latent_noise, reference_weights,
                               sample_indices, seeded_weights)


def build_engine(run: Run):
    """The program's engine, eval mode, on the run's weights."""
    from gcd_tpu_torch.engine.build import engine_from_config

    weights = seeded_weights(run.config["model"], run.seed, run.config["weights_std"],
                             run.device, run.dtype)
    engine = engine_from_config(run.config["model"], device=run.device, dtype=run.dtype,
                                state_dict=weights)
    del weights
    return engine


def free() -> None:
    """Return the memory of what the caller has dropped to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check_clips(run: Run, pool: List[Dict[str, torch.Tensor]], quant=None) -> List[float]:
    """The frames gap of a sample, drawn from the seed, of the clips the
    window completed (run.done entries with "pool", "noise_seed" and the
    program's "frames" on the host), against the reference sampling each
    alone from the same inputs and noise; also recorded as the check
    "frames_gap" (the worst). `quant` makes the reference the control."""
    t0 = time.perf_counter()
    done = [d for d in run.done if d.get("frames") is not None]
    picked = [done[i] for i in sample_indices(run.seed, len(done),
                                              int(run.traffic["checked_clips"]))]
    weights = reference_weights(run.config["model"], run.seed, run.config["weights_std"],
                                run.device, run.dtype)
    ref = build_reference(run.config["model"], weights, quant)
    del weights
    gaps = []
    for d in picked:
        noise = latent_noise(d["noise_seed"], run.frames, run.frame_hw, run.device)
        expected = ref.sample(pool[d["pool"]], noise).cpu()
        gaps.append(frames_gap(d["frames"], expected))
    del ref
    free()
    run.notes["frames_gaps"] = gaps
    run.notes["check_s"] = time.perf_counter() - t0
    if gaps:
        run.check("frames_gap", max(gaps))
    return gaps
