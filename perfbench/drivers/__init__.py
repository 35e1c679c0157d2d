"""One driver per traffic kind, a module ``perfbench/drivers/<kind>.py``
found by the ``kind`` of the cell's mix (:func:`perfbench.spec.load`).
Each has:

- ``run(cell, seed, seconds, trace, device, t0) -> Run``: set-up, the
  measured window, the traced stretch, and what the check needs;
- ``readings(run) -> (values, reference outputs)``: the numbers the check
  holds against the cell's limits, the reference run after the window;
- ``control(run, ref) -> values``: the same numbers of the control, the
  reference put in the program's place one precision lower;
- ``faults(run, ref) -> dict``: further readings for the limits'
  calibration (:mod:`perfbench.calibrate`).

Set-up is everything from the process's start to the window's. The window
drives the program's own entry in whole units (steps, batches) until
``seconds`` have passed; its time runs to the end of the last one's device
work. With ``trace`` the program's calls are wrapped in spans for the
whole window, and one more stretch of whole units runs under the profiler
right after it. The program's state is freed before the reference runs.

This module holds what the drivers share.
"""
from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import torch

from perfbench import trace as tr


class Run(SimpleNamespace):
    """What a run measured and kept: ``setup_s``, ``window_s``, ``units``
    (steps or batches in the window), ``tokens``, ``latencies_s`` (one a
    request), ``spans`` ({name: [seconds, ...]}), ``trace`` (the traced
    stretch's reduction, with ``units`` and ``decode_calls``), ``flops``
    and ``least_s`` (a unit's work and its products' least time),
    ``attempted``, ``failed``, ``memory_peak_bytes``, ``program`` (the
    outputs the check compares) and ``reference`` (the family's reference
    module)."""


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Device time of a call: CUDA events on the card, the host clock
    (after a synchronise) elsewhere."""

    def __init__(self, device):
        self.device, self.pairs = device, []

    def wrap(self, fn):
        def timed(*a, **k):
            if self.device.type == "cuda":
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = fn(*a, **k)
                e.record()
                self.pairs.append((s, e))
            else:
                t = time.perf_counter()
                out = fn(*a, **k)
                self.pairs.append(time.perf_counter() - t)
            return out
        return timed

    def seconds(self) -> list:
        return [p if isinstance(p, float) else p[0].elapsed_time(p[1]) / 1e3
                for p in self.pairs]


@contextlib.contextmanager
def patched(obj, name: str, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def span(name: str, fn):
    def spanned(*a, **k):
        with torch.profiler.record_function(tr.SPAN_PREFIX + name):
            return fn(*a, **k)
    return spanned


def free(device) -> None:
    """Collect and hand the allocator's cached blocks back."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
