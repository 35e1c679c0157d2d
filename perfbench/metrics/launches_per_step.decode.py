"""Kernel-launch calls inside the profiled batch's ``lm.decode_step``
calls, over those calls.
Returns None where the run has nothing to read."""


def read(run):
    t = run.trace if run.kind == "serve_batch" else None
    if not t or not t.get("decode_calls"):
        return None
    n = t["span_launches"].get("decode_step", 0)
    return n / t["decode_calls"] if n else None
