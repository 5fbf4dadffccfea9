"""The control of a cell's comparison: the reference put in the program's
place, computed one precision below the configuration's (bf16 -> float8
e4m3 on every matrix product's operands), read by the same compared numbers
against the float32 reference, on the cell's own inputs.

    python3 -m gcd_bench.control --workload kubric.clip_b1 --seeds 11 12 13

Prints one JSON line a seed with its readings. The benchmark's own runs
never run it; a limit must lie below the smallest reading it gives (and
above the largest the program gives). It needs the card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

from gcd_bench.drivers.sampling import free
from gcd_bench.harness import (Run, build_reference, clip_pool, frames_gap, latent_noise,
                               load_json, reference_weights, stream_seed)
from gcd_bench.reference.layers import fp8_e4m3


def clip_readings(run: Run) -> Dict[str, Dict[str, float]]:
    """frames_gap of the control against the reference, worst of the
    cell's checked_clips first requests."""
    pool = clip_pool(run)
    gaps = []
    outs = {}
    for quant in (None, fp8_e4m3):
        weights = reference_weights(run.config["model"], run.seed, run.config["weights_std"],
                                    run.device, run.dtype)
        ref = build_reference(run.config["model"], weights, quant)
        del weights
        for i in range(int(run.traffic["checked_clips"])):
            noise = latent_noise(stream_seed(run.seed, 3, i), run.frames, run.frame_hw,
                                 run.device)
            out = ref.sample(pool[i % len(pool)], noise).cpu()
            if quant is None:
                outs[i] = out
            else:
                gaps.append(frames_gap(out, outs[i]))
        del ref
        free()
    return {"control": {"frames_gap": max(gaps)}}


def train_readings(run: Run) -> Dict[str, Dict[str, float]]:
    """The control's numbers, and those of the fault of a loss over half of
    the batch (planted in the reference put in the program's place)."""
    from gcd_bench.drivers import train

    steps = int(run.traffic["checked_steps"])
    want = train.reference_steps(run, steps)
    control = train.compare(train.reference_steps(run, steps, quant=fp8_e4m3), want)
    half = train.compare(train.reference_steps(run, steps, half=True), want)
    return {"control": control, "half_batch": half}


def readings(run: Run) -> Dict[str, Dict[str, float]]:
    return train_readings(run) if run.traffic["driver"] == "train" else clip_readings(run)


def make_run(workload: str, seed: int, device="cuda", dtype=torch.bfloat16, config=None) -> Run:
    from gcd_bench.run import ROOT, load_cell

    cell, cell_config, traffic, limits = load_cell(workload, load_json(ROOT / "BENCHMARK.json"))
    return Run(workload=workload, cell=cell, config=config or cell_config, traffic=traffic,
               limits=limits, seed=seed, seconds=0.0, trace=False, device=torch.device(device),
               dtype=dtype)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        run = make_run(args.workload, seed)
        t0 = time.perf_counter()
        got = readings(run)
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "limits": run.limits, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
