"""torch.cuda.max_memory_allocated() over the measured window (reset at its
start, read as it closes), in GB, reported in the `--trace 1` run: a
matrix-free cell holds well under 1 GB by design, so it is watched here."""


def read(run):
    return run.window.peak_bytes / 1e9 if run.window.peak_bytes else None
