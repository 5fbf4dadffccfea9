"""Model FLOPs of the work the window completed over its seconds times the bf16 peak."""

from gcd_bench import readers


def read(run):
    return readers.mfu_pct(run)
