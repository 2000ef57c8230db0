"""The window's seconds over the inversions completed in it: the time a user
waits for one inversion, Parfile in and outputs written (host clock)."""


def read(run):
    n = len(run.inversions)
    return run.window.seconds / n if n else None
