"""The share of the profiled stretch of training steps in which no
operation ran on the device, in %.
Returns None where the run has nothing to read."""


def read(run):
    t = run.trace if run.kind == "train" else None
    if not t or not t["busy_s"]:
        return None
    return (1 - t["busy_s"] / t["window_s"]) * 100
