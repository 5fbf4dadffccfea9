"""Clips a batch that the server handed the sample function, mean over the window."""


def read(run):
    return sum(run.batch_fill) / len(run.batch_fill) if run.batch_fill else None
