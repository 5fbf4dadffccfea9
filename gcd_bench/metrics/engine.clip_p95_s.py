"""95th percentile of the seconds a clip took over the window's clips."""

from gcd_bench import readers


def read(run):
    return readers.latency_p95(run)
