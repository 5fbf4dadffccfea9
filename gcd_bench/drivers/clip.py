"""One client sampling one clip at a time through
`DiffusionEngine.sample_video`, each clip sent when the last has returned
(a researcher's or a demo's single-clip latency, no server batching).

Traffic keys: clips_in_pool (distinct clips made from the seed, cycled),
checked_clips (clips compared with the reference after the window).
"""

from __future__ import annotations

import time

import torch

from gcd_bench import profile
from gcd_bench.drivers.sampling import build_engine, check_clips, free
from gcd_bench.harness import Run, UNetSpans, clip_pool, latent_noise, stream_seed


def sync(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def run(run: Run) -> None:
    pool = clip_pool(run)
    engine = build_engine(run)

    def one(i: int) -> dict:
        p, seed = i % len(pool), stream_seed(run.seed, 3, i)
        noise = latent_noise(seed, run.frames, run.frame_hw, run.device)
        frames = engine.sample_video(pool[p], noise=noise)["sampled_video"].cpu()
        return {"pool": p, "noise_seed": seed, "frames": frames, "n_frames": run.frames}

    one(-1)  # warm-up: builds and loads every kernel at the window's shapes
    spans = UNetSpans(engine.model.diffusion_model) if run.trace else None
    sync(run)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_s = time.time() - run.process_start
    run.window_start = time.perf_counter()
    i = 0
    while time.perf_counter() - run.window_start < run.seconds:
        t0 = time.perf_counter()
        d = one(i)
        d.update(start=t0, end=time.perf_counter())
        run.done.append(d)
        i += 1
    run.window_end = run.done[-1]["end"]
    run.attempted = i
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    if spans is not None:
        run.enqueue_ms = list(spans.ms)
        run.profile = profile.Slices(units=1)
        profile.device_slice(run.profile, lambda: one(i))
        profile.host_slice(run.profile, lambda: one(i + 1))
        spans.remove()
    del engine
    free()
    check_clips(run, pool)
