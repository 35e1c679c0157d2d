"""The window's batches' own work (``perfbench.work.serve_flops``) over
the window's time, as a share of the bf16 peak, in %.
Returns None where the run has nothing to read."""
from perfbench import peaks


def read(run):
    if run.kind != "serve_batch" or not run.units:
        return None
    return run.flops * run.units / run.window_s / peaks.BF16_FLOPS * 100
