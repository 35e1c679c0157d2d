"""Kernel-launch calls in the profiled stretch of whole training steps
over its steps (``torch.profiler``'s runtime events).
Returns None where the run has nothing to read."""


def read(run):
    t = run.trace if run.kind == "train" else None
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["units"]
