"""The dense products of the profiled batch at their least time
(``perfbench.work.serve_products``) over the device time of the kernels
whose names mark them as products (``perfbench.trace.GEMM_NAME``), in %.
Returns None where the run has nothing to read."""


def read(run):
    t = run.trace if run.kind == "serve_batch" else None
    if not t or not t["gemm_s"]:
        return None
    return run.least_s * t["units"] / t["gemm_s"] * 100
