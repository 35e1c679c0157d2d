"""Profiler ranges and host-read counts on the LM path.

``span(name)`` opens the ``torch.profiler`` range ``repro_torch.<name>``
while a profiler records (:func:`recording`, the one gate), so the
program's ranges land in the profiler's own trace beside the device
kernels and on its clock; with no profiler it hands back one shared no-op
context. ``host_read(site)`` marks a read that blocks the host on the
device: it always counts the read (:func:`counts`), and while a profiler
records it also opens the range ``repro_torch.host_read.<site>``.

A range is a function-scope record (the profiler's fast range, as traced
compiled graphs use), not a user-scope ``record_function``: the profiler
copies each user-scope range onto the device's timeline, spanning the
kernels it launched, and a tool that sums device activity would read that
copy as device work. A kernel names the range it was launched in through
its launch's correlation id.

Ranges: ``engine.prefill``, ``engine.decode_step`` (``ServeEngine``),
``attn.direct``, ``attn.flash``, ``attn.flash_bwd`` (the attention core,
forward and backward), ``lm.head`` (the vocabulary product of
``lm.forward``). Host reads: ``engine_tokens`` (each decode step's tokens
back to the host), ``embed_ids`` (the embedding's id check).

To see them, run the call under ``torch.profiler.profile`` and export the
trace (``prof.export_chrome_trace``).
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}


def recording() -> bool:
    """Whether a profiler records on this thread (autograd's backward
    threads inherit the caller's profiler state)."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """The range ``repro_torch.<name>`` while a profiler records, else a
    shared no-op context."""
    if recording():
        return _range(PREFIX + name)
    return _OFF


def host_read(site: str):
    """Counts one blocking device-to-host read at ``site``; the range
    ``repro_torch.host_read.<site>`` while a profiler records."""
    _COUNTS[site] = _COUNTS.get(site, 0) + 1
    return span("host_read." + site)


def counts() -> dict[str, int]:
    """{site: host reads since the last :func:`reset`}."""
    return dict(_COUNTS)


def reset() -> None:
    _COUNTS.clear()
