"""Seconds from the process start to the first timed request or step."""


def read(run):
    return run.setup_s
