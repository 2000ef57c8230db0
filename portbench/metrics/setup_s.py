"""Process start to the window's start: imports, the CUDA context, the
program's libraries, the inputs and the warm-up inversion (host clock)."""


def read(run):
    return run.setup_s
