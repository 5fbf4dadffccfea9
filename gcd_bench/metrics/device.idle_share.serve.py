"""1 - the union of kernel intervals over the wall time of the device slice, in %."""

from gcd_bench import readers


def read(run):
    return readers.idle_pct(run)
