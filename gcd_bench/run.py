"""Run one cell of the benchmark once.

    python3 -m gcd_bench.run --workload kubric.serve_b2 --seed 7 --seconds 30 --trace 0

The cell, its configuration (gcd_bench/configs/<config>.json), its traffic
(gcd_bench/traffic/<traffic>.json, whose "driver" names
gcd_bench/drivers/<driver>.py), its limits (gcd_bench/limits/<cell>.json)
and its metrics (gcd_bench/metrics/<metric>.py) are found by the names in
BENCHMARK.json. With --trace 0 the result line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics and a breakdown.
Progress goes to standard error; the last line of standard output is the
result. A machine without enough CUDA cards, a checkout without the
program, or a process that has loaded JAX or the JAX package exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path


def process_start_time() -> float:
    """This process's start in epoch seconds (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


_PROCESS_START = process_start_time()

ROOT = Path(__file__).resolve().parent.parent
# Caches of the program and its libraries, inside the checkout at fixed
# paths: only a checkout's first run builds. (The port keeps its nvcc builds
# in gcd_tpu_torch/_build/ by itself.)
CACHE = ROOT / "gcd_bench" / "_cache"
CACHE_ENV = {"TRITON_CACHE_DIR": CACHE / "triton", "TORCH_EXTENSIONS_DIR": CACHE / "torch_ext",
             "CUDA_CACHE_PATH": CACHE / "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "gcd_tpu")

EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_JAX = 3, 4, 5


def log(msg: str) -> None:
    print(f"[gcd_bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_cell(workload: str, bench: dict):
    from gcd_bench.harness import BENCH_DIR, load_json

    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    trace its per-layer ones (listed for it, or moving an end-to-end metric
    it reports)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, device=None,
            dtype=None, bench: dict = None, config: dict = None):
    """Run the cell once; returns (the run, the result line's dict). `device`,
    `dtype` and `config` replace the card, bf16 and the cell's configuration
    (the CPU tests' tiny runs)."""
    import torch

    from gcd_bench import metrics
    from gcd_bench.harness import Run, device_record, load_json

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, cell_config, traffic, limits = load_cell(workload, bench)
    run = Run(workload=workload, cell=cell, config=config or cell_config, traffic=traffic,
              limits=limits, seed=int(seed), seconds=float(seconds), trace=bool(trace),
              device=torch.device(device or "cuda"), dtype=dtype or torch.bfloat16,
              process_start=_PROCESS_START)
    driver = importlib.import_module(f"gcd_bench.drivers.{traffic['driver']}")
    log(f"{workload} seed {seed}: {traffic['driver']} driver, {seconds} s, trace {int(trace)}")
    driver.run(run)
    log(f"window {run.window_s:.3f} s, {len(run.done)} done of {run.attempted}, "
        f"{run.failed} failed; set-up {run.setup_s:.3f} s; notes {json.dumps(run.notes)[:2000]}")
    values = {}
    for m in cell_metrics(bench, workload, trace):
        v = metrics.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": values, "device": device_record(run, int(cell["chips"]))}
    if trace and run.profile is not None:
        top = sorted(run.profile.kernels_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in run.profile.idle_gaps[:10]]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return run, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, path in CACHE_ENV.items():
        os.environ.setdefault(key, str(path))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from gcd_bench.harness import load_json

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(args.workload, bench)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return EXIT_NO_CARD
    try:
        importlib.import_module("gcd_tpu_torch")
    except ImportError as e:
        log(f"the program under test (gcd_tpu_torch) is not in this checkout: {e}")
        return EXIT_NO_PROGRAM
    run, result = execute(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    found = forbidden_modules()
    if found:
        log(f"this process has loaded {found}: the benchmark measures gcd_tpu_torch alone")
        return EXIT_JAX
    for name, v, lim in run.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
