"""torch.cuda.max_memory_allocated() over the window, reset at its start, in GB."""


def read(run):
    return run.window.peak_bytes / 1e9 if run.window.peak_bytes else None
