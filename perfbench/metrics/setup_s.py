"""Seconds from the process's start to the window's: weights, the
store or the engine, and the warm-up (host clock).
Returns None where the run has nothing to read."""


def read(run):
    return run.setup_s
