"""Prompt and generated tokens of every batch completed in the window
over the window's time, to the end of the last batch's device work
(host clock).
Returns None where the run has nothing to read."""


def read(run):
    if run.kind != "serve_batch" or not run.units:
        return None
    return run.tokens / run.window_s
