"""The arithmetic the metric readers share (gcd_bench/metrics/<name>.py
each call one of these). A reader returns None where it finds nothing to
read, and the metric is then left out of the result line."""

from __future__ import annotations

import statistics
from typing import Optional

from gcd_bench import flops, ops
from gcd_bench.harness import PEAK_BF16_FLOPS, PEAK_HBM_BPS, Run, percentile


def frames_per_s(run: Run) -> Optional[float]:
    """Frames of all work completed in the window over the window's seconds."""
    if not run.done or run.window_s <= 0:
        return None
    return sum(d["n_frames"] for d in run.done) / run.window_s


def latency_p95(run: Run) -> Optional[float]:
    return percentile([d["end"] - d["start"] for d in run.done if "end" in d], 95)


def device_ms(run: Run, annotation: str, per_unit: bool = False) -> Optional[float]:
    """Device ms inside the profiler ranges named `annotation` in the host
    slice: the mean a range, or the total over the slice's units."""
    p = run.profile
    vals = [v for v in (p.ranges_us.get(annotation, []) if p else []) if v > 0]
    if not vals:
        return None
    if per_unit:
        return sum(vals) / 1e3 / max(p.units, 1)
    return statistics.fmean(vals) / 1e3


def roofline_pct(run: Run) -> Optional[float]:
    """100 x the sum over the host slice's gcd:: op calls of the least time
    the card could take (the larger of flops / peak and bytes / bandwidth)
    over the sum of their device time."""
    p = run.profile
    least = spent = 0.0
    for call in (p.ops if p else []):
        count = ops.counter(call.name)
        if count is None or call.device_us <= 0:
            continue
        f, b = count(call.shapes, call.dtypes, call.scalars, run.frames)
        least += max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BPS)
        spent += call.device_us / 1e6
    return 100.0 * least / spent if spent > 0 else None


def mfu_pct(run: Run) -> Optional[float]:
    """100 x the model FLOPs of the work the window completed over the
    window's seconds times the bf16 peak."""
    if not run.done or run.window_s <= 0:
        return None
    if run.traffic["driver"] == "train":
        per = flops.train_flops(run.config, int(run.config["batch_size"]))
    else:
        per = flops.clip_flops(run.config)
    return 100.0 * per * len(run.done) / (run.window_s * PEAK_BF16_FLOPS)


def idle_pct(run: Run) -> Optional[float]:
    p = run.profile
    if not p or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
