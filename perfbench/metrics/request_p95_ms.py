"""The 95th percentile (linear between order statistics) of every
request completed in the window, each timed from its batch's hand-off
to ``run_batch`` to the end of the batch's device work (host clock).
Returns None where the run has nothing to read."""
import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
