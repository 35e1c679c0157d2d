"""The window's time from each batch's first ``lm.decode_step`` call to
the end of the batch, over all its decode calls (host clock, traced
runs only).
Returns None where the run has nothing to read."""


def read(run):
    if run.kind != "serve_batch" or not run.spans.get("decode_calls"):
        return None
    return sum(run.spans["decode_s"]) / sum(run.spans["decode_calls"]) * 1e3
