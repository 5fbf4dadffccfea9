"""95th percentile of submit-to-result seconds over the window's requests."""

from gcd_bench import readers


def read(run):
    return readers.latency_p95(run)
