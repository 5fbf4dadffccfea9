"""Host ms from the call to the return of a UNet evaluation (no synchronise), mean."""


def read(run):
    return sum(run.enqueue_ms) / len(run.enqueue_ms) if run.enqueue_ms else None
