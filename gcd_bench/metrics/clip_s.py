"""The window's seconds over the clips completed by the one client."""


def read(run):
    return run.window_s / len(run.done) if run.done else None
