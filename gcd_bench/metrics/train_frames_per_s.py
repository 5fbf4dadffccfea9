"""Frames of every batch row times the steps completed in the window, over its seconds."""

from gcd_bench import readers


def read(run):
    return readers.frames_per_s(run)
