"""Blend factors' zero gradients in chip_smoke.py's seeded Adam steps, with
some of the port's kernels switched off.

    python3 scripts/torch_blend_witness.py [--steps 3] [--off fused_mlp ...]

Builds the training engine as chip_smoke.py's train phase does (its config,
seed and batch), runs `--steps` Adam steps with the kernels named by `--off`
switched off (once with none off, then once with them off, each on a fresh
trainer), and prints one JSON line a step: the loss, and for every
`time_mixer.mix_factor` whose gradient is exactly zero, chip_smoke's
`BlendWitness` evidence (fp32 value and reading of every frame against its
rounding slack). The first line is nvidia-smi's name and power limit. Needs
one CUDA card.
"""

import argparse
import gc
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def run(steps: int, off: tuple) -> None:
    from gcd_tpu_torch.engine.trainer import load_trainer
    from gcd_tpu_torch.ops import kernel_flags

    trainer = load_trainer(chip_smoke.TRAIN_CONFIG)
    engine = trainer.engine
    named = dict(engine.named_parameters())
    gen = torch.Generator("cuda").manual_seed(chip_smoke.SEED + 20)
    batch = chip_smoke.random_batch(gen, chip_smoke.TRAIN_B, target=True)
    witness = chip_smoke.BlendWitness(engine)
    with kernel_flags(**dict.fromkeys(off, False)):
        for step in range(steps):
            witness.reset()
            metrics = trainer.train_step(batch, gen)
            zero = sorted(n for n, p in named.items() if n.endswith("time_mixer.mix_factor")
                          and p.grad is not None and not p.grad.any())
            print(json.dumps({"off": list(off), "step": step, "loss": float(metrics["loss"]),
                              "blend_zero_evidence": {
                                  n: witness.explain(n[:-len(".mix_factor")]) for n in zero}}),
                  flush=True)
    witness.remove()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--off", nargs="*", default=["fused_mlp"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_blend_witness: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for off in ((), tuple(args.off)):
        run(args.steps, off)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
