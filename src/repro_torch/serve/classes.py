"""Request classes and latency accounting for the serving front door.

The multi-tenant front door (:mod:`repro_torch.serve.frontend`) speaks in
**request classes**: named service levels (``interactive`` / ``batch`` /
``background`` are the presets) that bundle everything the serving stack
needs to treat one tenant's work differently from another's —

- a **priority** plus an **anti-starvation aging rate** that the pump's
  group selection scores queued work by (a ``background`` chunk outranks
  an ``interactive`` one once it has waited long enough, so low-priority
  work always drains),
- a per-class **coalescing policy** (``coalesce`` depth and ``linger_us``
  hold time — ``interactive`` launches immediately in singleton groups,
  ``batch`` lingers for fuller launches),
- a default **deadline_ms** applied to submits that do not pass their
  own, and
- the front door's **admission window** (``max_inflight`` outstanding
  requests admitted freely, ``queue_depth`` more admitted as queued
  work, anything past that rejected with a typed :class:`Overloaded`).

:class:`LatencyHistogram` is the streaming log-bucketed latency record
behind the per-class SLO gates — unlike the bench-compat
``FeatureService.latencies`` deque (a sliding 8192-sample window whose
``np.percentile`` silently reports the p99 of only the most RECENT
tickets on long runs), the histogram sees every completed ticket at a
fixed ~10% relative resolution, so its percentiles are unbiased however
long the service has been up.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RequestClass:
    """One named service level (see module docstring).

    ``coalesce``/``linger_us`` of ``None`` inherit the service-wide
    settings; a class's ``coalesce`` is additionally capped at the
    service's (launch buffers are sized for the service-wide depth).
    ``aging_s`` is the anti-starvation rate: a queued chunk's effective
    priority is ``priority + waited_seconds / aging_s``, so every
    ``aging_s`` seconds of queue time is worth one priority level.
    """
    name: str
    priority: int = 1
    deadline_ms: float | None = None
    max_inflight: int = 64          # front-door window: admitted freely
    queue_depth: int = 256          # then this many more admitted queued
    coalesce: int | None = None     # None: service-wide depth
    linger_us: float | None = None  # None: service-wide linger
    aging_s: float = 0.25

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("request class needs a name")
        if self.priority < 0:
            raise ValueError("priority must be >= 0")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        if self.coalesce is not None and self.coalesce < 1:
            raise ValueError("coalesce must be >= 1")
        if self.linger_us is not None and self.linger_us < 0:
            raise ValueError("linger_us must be >= 0")
        if self.aging_s <= 0:
            raise ValueError("aging_s must be > 0")


def default_classes() -> tuple[RequestClass, ...]:
    """The preset three-tier ladder: ``interactive`` launches immediately
    (singleton groups, highest priority, tight deadline), ``batch``
    coalesces normally, ``background`` is the aged-up scavenger class
    (small admission window, no deadline — it may wait, never starve)."""
    return (
        RequestClass("interactive", priority=3, deadline_ms=5_000.0,
                     max_inflight=64, queue_depth=128, coalesce=1,
                     linger_us=0.0, aging_s=0.25),
        RequestClass("batch", priority=2, deadline_ms=30_000.0,
                     max_inflight=32, queue_depth=256, aging_s=0.5),
        RequestClass("background", priority=1, deadline_ms=None,
                     max_inflight=16, queue_depth=512, aging_s=0.5),
    )


class Overloaded(RuntimeError):
    """Typed admission rejection from the front door: the request class's
    outstanding work is past ``max_inflight + queue_depth``.

    Carries the saturation picture (``klass``, ``tenant``, ``outstanding``
    against ``bound``) and a ``retry_after_s`` hint — the front door's
    estimate of when a slot should free up (from the class's observed p50
    latency), so a well-behaved client backs off instead of hammering.
    Nothing was enqueued: an Overloaded submit left no ticket behind.
    """

    def __init__(self, msg: str, *, klass: str | None = None,
                 tenant: str | None = None, outstanding: int = 0,
                 bound: int = 0, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.klass = klass
        self.tenant = tenant
        self.outstanding = outstanding
        self.bound = bound
        self.retry_after_s = retry_after_s


class LatencyHistogram:
    """Streaming log-bucketed latency histogram (see module docstring).

    Buckets are geometric: ``buckets_per_decade`` per factor of 10
    between ``lo_s`` and ``hi_s`` (defaults: 24 per decade over 1 us ..
    1000 s, 216 buckets, ~10% bucket width), values outside clamp to the
    edge buckets. ``record`` is O(1) and allocation-free — cheap enough
    to run under the service lock on every retire. ``percentile`` walks
    the cumulative counts and returns the geometric midpoint of the
    target bucket, clamped to the exact observed min/max so the tails
    never report a value outside what was actually seen. Not internally
    locked: the owner serializes access (the service mutates it under
    its own lock).
    """

    def __init__(self, lo_s: float = 1e-6, hi_s: float = 1e3,
                 buckets_per_decade: int = 24):
        if lo_s <= 0 or hi_s <= lo_s:
            raise ValueError("need 0 < lo_s < hi_s")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self._lo = lo_s
        self._log_lo = math.log10(lo_s)
        self._bpd = buckets_per_decade
        self._n = int(math.ceil(
            (math.log10(hi_s) - self._log_lo) * buckets_per_decade))
        self.counts = np.zeros(self._n, np.int64)
        self.count = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def _index(self, s: float) -> int:
        if s <= self._lo:
            return 0
        i = int((math.log10(s) - self._log_lo) * self._bpd)
        return min(i, self._n - 1)

    def record(self, s: float) -> None:
        self.counts[self._index(s)] += 1
        self.count += 1
        self.total_s += s
        if s < self.min_s:
            self.min_s = s
        if s > self.max_s:
            self.max_s = s

    def merge(self, other: "LatencyHistogram") -> None:
        if other._n != self._n or other._lo != self._lo:
            raise ValueError("histogram layouts differ")
        self.counts += other.counts
        self.count += other.count
        self.total_s += other.total_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)

    def percentile(self, q: float) -> float:
        """The q-th percentile in SECONDS over every recorded sample
        (0.0 when empty). Resolution is one bucket (~10% relative at the
        default layout); exact at the extremes (observed min/max)."""
        if not 0 <= q <= 100:
            raise ValueError("q must be in [0, 100]")
        if self.count == 0:
            return 0.0
        if q == 0:
            return self.min_s
        if q >= 100:
            return self.max_s
        target = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for i in range(self._n):
            c = int(self.counts[i])
            if c == 0:
                continue
            cum += c
            if cum >= target:
                mid = 10.0 ** (self._log_lo + (i + 0.5) / self._bpd)
                return min(max(mid, self.min_s), self.max_s)
        return self.max_s

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def summary(self) -> dict:
        """JSON-safe snapshot for stats endpoints (milliseconds)."""
        empty = self.count == 0
        return {"samples": self.count,
                "mean_ms": self.mean_s * 1e3,
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3,
                "min_ms": 0.0 if empty else self.min_s * 1e3,
                "max_ms": self.max_s * 1e3}
