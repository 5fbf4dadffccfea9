"""The traced run's profiler slices, reduced to what the metric readers use.

Two slices of the same work as the window, taken after it:
  * `device`: torch.profiler with CUDA activity only, the cheapest trace:
    the union of kernel intervals (busy_s), the slice's wall time
    (window_s), kernel time by name;
  * `host`: CPU and CUDA activity with shapes: each `gcd::` op call with
    its shapes and device time, the benchmark's `bench.unet` ranges, the
    optimizer's `Optimizer.step` annotation, and what the host was doing
    in each idle gap. Its host overhead stretches the gaps, so the idle
    share comes from the device slice.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch


def _device_us(ev) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(ev, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _is_kernel(ev) -> bool:
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The merged intervals, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class OpCall:
    name: str
    shapes: List
    dtypes: Optional[List]
    scalars: Optional[List]
    device_us: float


@dataclass
class Slices:
    busy_s: float = 0.0
    window_s: float = 0.0
    kernels_s: Dict[str, float] = field(default_factory=dict)
    ops: List[OpCall] = field(default_factory=list)
    ranges_us: Dict[str, List[float]] = field(default_factory=dict)  # annotation -> device us
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    units: int = 0  # evaluations, clips or steps in the host slice


def _profile(fn: Callable[[], None], host: bool):
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts, record_shapes=host) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def device_slice(slices: Slices, fn: Callable[[], None]) -> None:
    events, wall = _profile(fn, host=False)
    kernels = [ev for ev in events if _is_kernel(ev)]
    spans = union([(ev.time_range.start, ev.time_range.end) for ev in kernels])
    by_name: Counter = Counter()
    for ev in kernels:
        by_name[ev.name] += (ev.time_range.end - ev.time_range.start) / 1e6
    slices.busy_s = sum(b - a for a, b in spans) / 1e6
    slices.window_s = wall
    slices.kernels_s = dict(by_name)


ANNOTATIONS = ("bench.unet", "Optimizer.step")
GAPS_KEPT = 10


def host_slice(slices: Slices, fn: Callable[[], None]) -> None:
    events, _ = _profile(fn, host=True)
    cpu = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CPU]
    for ev in cpu:
        if ev.name.startswith("gcd::"):
            slices.ops.append(OpCall(ev.name[len("gcd::"):], list(ev.input_shapes or []),
                                     getattr(ev, "input_dtypes", None),
                                     getattr(ev, "concrete_inputs", None), _device_us(ev)))
        for prefix in ANNOTATIONS:
            if ev.name.startswith(prefix):
                slices.ranges_us.setdefault(prefix, []).append(_device_us(ev))
    spans = union([(ev.time_range.start, ev.time_range.end) for ev in events if _is_kernel(ev)])
    gaps = [(b, a2) for (_, b), (a2, _) in zip(spans, spans[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    for lo, hi in gaps[:GAPS_KEPT]:
        mid = (lo + hi) / 2
        inside = [ev for ev in cpu if ev.time_range.start <= mid <= ev.time_range.end]
        label = max(inside, key=lambda ev: ev.time_range.start).name if inside else "host idle"
        slices.idle_gaps.append((label, (hi - lo) / 1e6))
