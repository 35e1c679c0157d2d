"""The traced stretch: ``torch.profiler`` over whole steps or batches, and
its reduction to device busy time, idle gaps by what the host was doing,
launch calls, GEMM time and the top device operations.

Spans from the benchmark's own files are ``record_function`` ranges named
``perfbench.<span>``; the reduction reads them from the same trace, so
launches and gaps can be counted inside them.
"""
from __future__ import annotations

import bisect
import re
import time

import torch

# cuBLAS, cuBLASLt and CUTLASS product kernels on Hopper and before
GEMM_NAME = re.compile(r"gemm|gemv|xmma|cutlass|nvjet|wgmma|cublas",
                       re.IGNORECASE)
SPAN_PREFIX = "perfbench."
NAME_CHARS = 160


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except AttributeError:
        return ""


def profile(fn) -> dict:
    """Runs ``fn`` under the profiler, synchronised at both ends, and
    reduces the trace (:func:`reduce`)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as _profile
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN_PREFIX + "traced"):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), wall)


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, wall_s: float, top: int = 10, labelled: int = 400
           ) -> dict:
    """-> {busy_s, window_s, launches, device_ops, idle_gaps, gemm_s,
    device_s, spans: {name: [(start_ns, end_ns), ...]}, span_launches:
    {name: launch calls inside that span's ranges}}. ``window_s`` is the
    traced range's length on the trace's clock (``wall_s``, the host's,
    where the range is missing)."""
    dev, host, launches, spans = [], [], [], {}
    for e in events:
        kind = _kind(e)
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        name = e.name()
        on_device = e.device_type().name == "CUDA"
        if on_device:
            # a record_function range has a device-side copy: not an op
            if "annotation" not in kind and not name.startswith(SPAN_PREFIX):
                dev.append((start, end, name))
            continue
        if "LaunchKernel" in name:
            launches.append(start)
        elif name.startswith(SPAN_PREFIX):
            spans.setdefault(name[len(SPAN_PREFIX):], []).append((start, end))
        host.append((start, end, name))
    traced = spans.get("traced")
    if traced:
        lo, hi = traced[0]
    elif dev:
        lo, hi = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        lo = hi = 0
    window_s = (hi - lo) / 1e9 if traced else wall_s
    busy = _union([(max(a, lo), min(b, hi)) for a, b, _ in dev
                   if b > lo and a < hi])
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name: dict = {}
    gemm_s = 0.0
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        if GEMM_NAME.search(name):
            gemm_s += (b - a) / 1e9
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:labelled]
    host.sort()
    starts = [h[0] for h in host]
    idle: dict = {}
    for a, b in gaps:
        label = _host_at(host, starts, a)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    launches.sort()
    span_launches = {
        name: sum(bisect.bisect_right(launches, e) -
                  bisect.bisect_left(launches, s) for s, e in ranges)
        for name, ranges in spans.items()}
    return {
        "busy_s": busy_s, "window_s": window_s, "device_s":
        sum(by_name.values()), "gemm_s": gemm_s,
        "launches": sum(1 for t in launches if lo <= t <= hi),
        "device_ops": [[n[:NAME_CHARS], s] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n[:NAME_CHARS], s] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        "spans": spans, "span_launches": span_launches}


def _host_at(host: list, starts: list, t: int) -> str:
    """The benchmark's innermost span and the innermost host operation
    running at ``t`` ("idle host" where none is)."""
    span = op = None
    best_span = best_op = -1
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 5000), -1):
        a, b, name = host[j]
        if b < t:
            continue
        if name.startswith(SPAN_PREFIX):
            if a > best_span:
                best_span, span = a, name[len(SPAN_PREFIX):]
        elif a > best_op:
            best_op, op = a, name
    if span is None and op is None:
        return "idle host"
    return f"{span or '-'} / {op or '-'}"
