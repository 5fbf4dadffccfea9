"""Share of the roofline of the gcd:: ops: their least time over their device time."""

from gcd_bench import readers


def read(run):
    return readers.roofline_pct(run)
