"""The window's training steps' own work (``perfbench.work.train_flops``)
over the window's time, as a share of the bf16 peak, in %.
Returns None where the run has nothing to read."""
from perfbench import peaks


def read(run):
    if run.kind != "train" or not run.units:
        return None
    return run.flops * run.units / run.window_s / peaks.BF16_FLOPS * 100
