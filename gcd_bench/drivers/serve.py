"""A closed loop of clients sending one clip each to `SamplerServer` in
process, over the engine's sample function as `serve.py` builds it; each
client sends its next clip when the last has returned.

Traffic keys: clients, max_batch, max_wait_ms (the server's settings),
clips_in_pool (distinct clips made from the seed, cycled), checked_clips
(clips compared with the reference after the window).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from gcd_bench import profile
from gcd_bench.drivers.clip import sync
from gcd_bench.drivers.sampling import build_engine, check_clips, free
from gcd_bench.harness import Run, UNetSpans, clip_pool, stream_seed

RESULT_TIMEOUT_S = 300.0


def run(run: Run) -> None:
    from gcd_tpu_torch.engine.server import (SamplerServer, batch_check,
                                             make_engine_sample_fn, sample_keys)

    tr = run.traffic
    mb, t = int(tr["max_batch"]), run.frames
    pool = clip_pool(run)
    host_pool = [{k: v.cpu().numpy() for k, v in clip.items()} for clip in pool]
    engine = build_engine(run)
    fn = make_engine_sample_fn(engine, mb, t)
    slice_job = []  # a profiler slice to wrap the next batch in

    def counted(batch, seeds):
        run.batch_fill.append(len(set(seeds)))
        if not slice_job:
            return fn(batch, seeds)
        out = {}
        slice_job.pop()(lambda: out.update(fn(batch, seeds)))
        return out

    # Warm-up on the traffic's own shapes, as serve.py warms up before it listens.
    warm = {k: np.concatenate([host_pool[i % len(pool)][k] for i in range(mb)])
            for k in host_pool[0]}
    fn(warm, [stream_seed(run.seed, 5, i) for i in range(mb)])
    server = SamplerServer(counted, t, max_batch=mb, max_wait_ms=float(tr["max_wait_ms"]),
                           check=batch_check(sample_keys(engine), mb, t, run.frame_hw)).start()
    spans = UNetSpans(engine.model.diffusion_model) if run.trace else None
    lock = threading.Lock()
    counter = iter(range(10 ** 9))

    def client(end: float) -> None:
        while time.perf_counter() < end:
            with lock:
                i = next(counter)
                run.attempted += 1
            p, seed = i % len(pool), stream_seed(run.seed, 3, i)
            t0 = time.perf_counter()
            try:
                out = server.submit(host_pool[p], seed).result(timeout=RESULT_TIMEOUT_S)
            except Exception as e:  # a request that fails or never comes
                with lock:
                    run.failed += 1
                    run.notes.setdefault("errors", []).append(repr(e)[:300])
                continue
            d = {"pool": p, "noise_seed": seed, "start": t0, "end": time.perf_counter(),
                 "frames": torch.from_numpy(out["sampled_video"]), "n_frames": t}
            with lock:
                run.done.append(d)

    def load(seconds: float) -> None:
        end = time.perf_counter() + seconds
        threads = [threading.Thread(target=client, args=(end,))
                   for _ in range(int(tr["clients"]))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    try:
        sync(run)
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        run.setup_s = time.time() - run.process_start
        run.window_start = time.perf_counter()
        load(run.seconds)
        run.window_end = max((d["end"] for d in run.done), default=time.perf_counter())
        if run.device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
        if spans is not None:
            window_batches = len(run.batch_fill)
            run.profile = profile.Slices(units=mb)
            for take in (profile.device_slice, profile.host_slice):
                slice_job.append(lambda body, take=take: take(run.profile, body))
                futs = [server.submit(host_pool[i % len(pool)], stream_seed(run.seed, 6, i))
                        for i in range(mb)]
                for f in futs:
                    f.result(timeout=RESULT_TIMEOUT_S)
            del run.batch_fill[window_batches:]
            spans.remove()
    finally:
        server.stop()
    del engine, fn, counted, server
    free()
    check_clips(run, pool)
