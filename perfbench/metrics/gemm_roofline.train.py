"""The dense products of the profiled training steps at their least
time (``perfbench.work.train_products``: max of operations at the bf16
peak and bytes once at the memory peak) over the device time of the
kernels whose names mark them as products (``perfbench.trace.GEMM_NAME``),
in %.
Returns None where the run has nothing to read."""


def read(run):
    t = run.trace if run.kind == "train" else None
    if not t or not t["gemm_s"]:
        return None
    return run.least_s * t["units"] / t["gemm_s"] * 100
