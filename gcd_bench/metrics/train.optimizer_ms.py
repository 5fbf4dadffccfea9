"""Device ms inside torch.optim's Optimizer.step annotation, a step."""

from gcd_bench import readers


def read(run):
    return readers.device_ms(run, "Optimizer.step", per_unit=True)
