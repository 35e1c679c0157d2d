"""Tokens of every whole step in the window over the window's time, to
the end of the last step's device work (host clock).
Returns None where the run has nothing to read."""


def read(run):
    if run.kind != "train" or not run.units:
        return None
    return run.tokens / run.window_s
