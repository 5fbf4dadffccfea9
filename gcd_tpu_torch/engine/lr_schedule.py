"""Learning-rate schedules (port of gcd_tpu/engine/lr_schedule.py; the
reference is sgm/lr_scheduler.py).

Each scheduler is a multiplier of the base rate, `schedule(n)` at optimizer
update n, as the reference's LambdaLR uses it (diffusion.py:420-430). The
configs name them by their `sgm.lr_scheduler.*` targets (utils/config.py);
engine/trainer.py applies `base_lr * schedule(k)` at the k-th optimizer
update. No shipped config sets a scheduler.
"""

from __future__ import annotations

import numpy as np


class LambdaWarmUpCosineScheduler:
    """Linear warm-up from lr_start to lr_max over warm_up_steps, then a
    cosine from lr_max to lr_min over the steps up to max_decay_steps."""

    def __init__(self, warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps,
                 verbosity_interval=0):
        self.lr_warm_up_steps = warm_up_steps
        self.lr_start = lr_start
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.lr_max_decay_steps = max_decay_steps

    def schedule(self, n):
        if n < self.lr_warm_up_steps:
            lr = (self.lr_max - self.lr_start) / self.lr_warm_up_steps * n + self.lr_start
        else:
            t = (n - self.lr_warm_up_steps) / (self.lr_max_decay_steps - self.lr_warm_up_steps)
            t = min(t, 1.0)
            lr = self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + np.cos(t * np.pi))
        return lr

    def __call__(self, n):
        return self.schedule(n)


class LambdaWarmUpCosineScheduler2:
    """Warm-up and cosine per cycle, over cycles of the given lengths
    (lr_scheduler.py:51); past the last boundary the last cycle's formula
    goes on."""

    def __init__(self, warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                 verbosity_interval=0):
        if not (len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start)
                == len(cycle_lengths)):
            raise ValueError("warm_up_steps, f_min, f_max, f_start and cycle_lengths need "
                             "one entry per cycle")
        self.lr_warm_up_steps = warm_up_steps
        self.f_start = f_start
        self.f_min = f_min
        self.f_max = f_max
        self.cycle_lengths = cycle_lengths
        self.cum_cycles = np.cumsum([0] + list(self.cycle_lengths))

    def find_in_interval(self, n):
        """The cycle of step n: the first whose end is >= n, the last one
        past the final boundary (as the JAX trainer's traced schedule
        clamps; the reference's Python one would index past its lists)."""
        for interval, cl in enumerate(self.cum_cycles[1:]):
            if n <= cl:
                return interval
        return len(self.cycle_lengths) - 1

    def schedule(self, n):
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            f = (self.f_max[cycle] - self.f_start[cycle]) / self.lr_warm_up_steps[cycle] * n \
                + self.f_start[cycle]
        else:
            t = (n - self.lr_warm_up_steps[cycle]) / (
                self.cycle_lengths[cycle] - self.lr_warm_up_steps[cycle])
            t = min(t, 1.0)
            f = self.f_min[cycle] + 0.5 * (self.f_max[cycle] - self.f_min[cycle]) * (
                1 + np.cos(t * np.pi))
        return f

    def __call__(self, n):
        return self.schedule(n)


class LambdaLinearScheduler(LambdaWarmUpCosineScheduler2):
    """Warm-up per cycle, then a linear fall from f_max towards f_min at the
    cycle's end."""

    def schedule(self, n):
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            f = (self.f_max[cycle] - self.f_start[cycle]) / self.lr_warm_up_steps[cycle] * n \
                + self.f_start[cycle]
        else:
            f = self.f_min[cycle] + (self.f_max[cycle] - self.f_min[cycle]) * (
                self.cycle_lengths[cycle] - n) / (self.cycle_lengths[cycle])
        return f
