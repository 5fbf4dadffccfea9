"""`Trainer.train_step` on batches made on the card from the seed, in the
form the data modules hand over (clips of "jpg" targets with their
conditioning frames), each step's random numbers made by the benchmark and
passed as the step's `draws`.

Set-up builds one trainer and drives it through `checked_steps` steps (the
first builds the kernels); the window's steps continue on that same
trainer. After the window the reference takes the same first steps from the
same weights, batches and random numbers (`reference_steps`), and `compare`
reads:
  loss_gap:   the largest |loss - reference loss| / |reference loss| of the steps;
  grad_gap:   over the trainable leaves, the largest gap between the norm of
              the first gradient (the program's from Adam's first moment after
              one step, m / (1 - beta1)) and the reference's, over the larger
              of the reference leaf's norm and the median leaf's;
  change_gap: the same of each leaf's change after the checked steps, over the
              leaves whose reference gradient is at least a thousandth of the
              median leaf's (the others move by round-off alone under Adam);
  `.median`:  the median leaf's gap in place of the largest.
The cell's limits file names the ones compared; the others go to the notes.

Traffic keys: checked_steps, profiled_steps.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

import torch

from gcd_bench import profile
from gcd_bench.drivers.clip import sync
from gcd_bench.drivers.sampling import build_engine, free
from gcd_bench.harness import (Run, build_reference, random_clips, reference_weights,
                               seeded_weights, stream_seed)

# Leaves whose reference gradient norm is below this share of the median
# leaf's are left out of the change comparison.
MOVED_SHARE = 1e-3


def draws_for(run: Run, gen: torch.Generator, rows: int) -> Dict:
    """The loss's random numbers for `rows` frames, in the layout the
    trainer takes: the posterior noise, the conditioning-dropout keep masks
    of the embedders with a ucg_rate, the sigma sampler's normals, the noise."""
    h, w = run.frame_hw[0] // 8, run.frame_hw[1] // 8
    dev = run.device
    embs = run.config["model"]["params"]["conditioner_config"]["params"]["emb_models"]
    return {"posterior": torch.randn((rows, h, w, 4), generator=gen, device=dev),
            "ucg_keep": {i: torch.rand((rows, 1), generator=gen, device=dev)
                         < 1.0 - float(e["ucg_rate"])
                         for i, e in enumerate(embs) if float(e.get("ucg_rate", 0.0)) > 0.0},
            "sigma_rand": torch.randn((rows,), generator=gen, device=dev),
            "noise": torch.randn((rows, h, w, 4), generator=gen, device=dev)}


def feed(run: Run, step: int) -> Tuple[Dict, Dict]:
    """Step `step`'s batch and random numbers, every step's rows its own."""
    gen = torch.Generator(run.device).manual_seed(stream_seed(run.seed, 4, step))
    clips = int(run.config["batch_size"])
    batch = random_clips(gen, clips, run.frames, run.frame_hw, run.device, target=True)
    return batch, draws_for(run, gen, clips * run.frames)


def half_batch(batch: Dict, draws: Dict, clips: int) -> Tuple[Dict, Dict]:
    """The first half of the clips of a batch and of its random numbers."""
    keep = clips // 2

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[: v.shape[0] * keep // clips]

    return cut(batch), cut(draws)


def learning_rate(run: Run) -> float:
    return float(run.config["model"]["base_learning_rate"])


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names: List[str],
              pick=max) -> float:
    """`pick` (the largest, or the median) of |got - want| over max(want,
    median of want), by leaf."""
    if not names:
        return float("nan")
    median = statistics.median(want[n] for n in names)
    return pick([abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names])


def build_trainer(run: Run):
    from gcd_tpu_torch.engine.trainer import Trainer

    return Trainer(build_engine(run), learning_rate(run), 1)


def program_steps(run: Run, trainer, steps: int) -> Dict:
    """The checked steps on the program: losses, first-gradient and change norms by leaf."""
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    losses, grads = [], {}
    for k in range(steps):
        batch, draws = feed(run, k)
        losses.append(trainer.train_step(batch, draws=draws)["loss"])
        if k == 0:
            # A master the optimizer never got has no state: its gradient reads 0.
            state = trainer.optimizer.state
            grads = {n: float(state[m]["exp_avg"].norm() / (1.0 - beta1)) if m in state else 0.0
                     for n, m in zip(trainer.trainable_names, trainer.masters)}
    init = seeded_weights(run.config["model"], run.seed, run.config["weights_std"], run.device,
                          run.dtype)
    change = {n: float((m - init[n].float()).norm())
              for n, m in zip(trainer.trainable_names, trainer.masters)}
    del init
    return {"loss": [float(v) for v in losses], "grad": grads, "change": change}


def reference_steps(run: Run, steps: int, quant=None, half: bool = False) -> Dict:
    """The same steps on the reference (the control with `quant`; with
    `half`, the fault of a loss over the first half of the batch's rows).
    As the configuration states, Adam updates float32 masters and each step
    runs the model on the masters rounded to the served dtype (bf16): an
    update smaller than half a bf16 step leaves the weights the model sees
    unchanged. The arithmetic is float32 throughout."""
    weights = reference_weights(run.config["model"], run.seed, run.config["weights_std"],
                                run.device, run.dtype)
    ref = build_reference(run.config["model"], weights, quant)
    del weights
    ref.requires_grad_(False)
    trainable = ref.trainable_parameters()
    masters = {n: p.detach().clone() for n, p in trainable.items()}
    init = {n: m.clone() for n, m in masters.items()}
    for p in trainable.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(masters.values()), lr=learning_rate(run))
    losses, grads = [], {}
    for k in range(steps):
        with torch.no_grad():
            for n, p in trainable.items():
                p.copy_(masters[n].to(run.dtype))
                p.grad = None
        batch, draws = feed(run, k)
        if half:
            batch, draws = half_batch(batch, draws, int(run.config["batch_size"]))
        loss = ref.loss(batch, draws, k)
        loss.backward()
        losses.append(float(loss.detach()))
        for n, m in masters.items():
            m.grad = trainable[n].grad
        if k == 0:
            grads = {n: float(p.grad.norm()) for n, p in trainable.items()}
        opt.step()
    change = {n: float((m - init[n]).norm()) for n, m in masters.items()}
    del ref, opt, init, masters, trainable
    free()
    return {"loss": losses, "grad": grads, "change": change}


def moved_leaves(want: Dict) -> List[str]:
    names = sorted(want["grad"])
    median = statistics.median(want["grad"][n] for n in names)
    return [n for n in names if want["grad"][n] >= MOVED_SHARE * median]


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers of `got` against `want`: the worst leaf's gaps and the
    median leaf's (`.median`)."""
    names, moved = sorted(want["grad"]), moved_leaves(want)
    med = statistics.median
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
            "grad_gap": leaf_gaps(got["grad"], want["grad"], names),
            "grad_gap.median": leaf_gaps(got["grad"], want["grad"], names, med),
            "change_gap": leaf_gaps(got["change"], want["change"], moved),
            "change_gap.median": leaf_gaps(got["change"], want["change"], moved, med)}


def worst_leaves(got: Dict, want: Dict, key: str, names: List[str], k: int = 3) -> List:
    """The k leaves farthest apart by `key`: [name, got, want, reference gradient]."""
    median = statistics.median(want[key][n] for n in names)
    worst = sorted(names, key=lambda n: -abs(got[key][n] - want[key][n])
                   / max(want[key][n], median, 1e-30))[:k]
    return [[n, got[key][n], want[key][n], want["grad"][n]] for n in worst]


def run(run: Run) -> None:
    steps = int(run.traffic["checked_steps"])
    trainer = build_trainer(run)
    got = program_steps(run, trainer, steps)
    frames = int(run.config["batch_size"]) * run.frames
    sync(run)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_s = time.time() - run.process_start
    k = steps

    def step() -> None:
        nonlocal k
        batch, draws = feed(run, k)
        trainer.train_step(batch, draws=draws)
        k += 1

    run.window_start = time.perf_counter()
    while time.perf_counter() - run.window_start < run.seconds:
        step()
        run.attempted += 1
        if k % 4 == 0:  # keep the host within a few steps of the card
            sync(run)
    sync(run)
    run.window_end = time.perf_counter()
    run.done = [{"n_frames": frames}] * run.attempted
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    if run.trace:
        n = int(run.traffic["profiled_steps"])
        run.profile = profile.Slices(units=n)
        profile.device_slice(run.profile, lambda: [step() for _ in range(n)])
        profile.host_slice(run.profile, lambda: [step() for _ in range(n)])
    del trainer
    free()
    t0 = time.perf_counter()
    want = reference_steps(run, steps)
    run.notes["check_s"] = time.perf_counter() - t0
    run.notes["program"] = {"loss": got["loss"]}
    run.notes["reference"] = {"loss": want["loss"]}
    run.notes["worst_grad"] = worst_leaves(got, want, "grad", sorted(want["grad"]))
    run.notes["worst_change"] = worst_leaves(got, want, "change", moved_leaves(want))
    run.notes["median_grad"] = statistics.median(want["grad"].values())
    numbers = compare(got, want)
    run.notes["numbers"] = numbers
    for name in run.limits:
        run.check(name, numbers[name])
