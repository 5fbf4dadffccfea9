"""Frames of all clips completed in the window over the window's seconds."""

from gcd_bench import readers


def read(run):
    return readers.frames_per_s(run)
