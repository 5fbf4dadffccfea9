"""torch.cuda.max_memory_allocated over the window, in GB (1e9 bytes)."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
