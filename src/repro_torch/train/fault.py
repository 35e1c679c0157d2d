"""Fault tolerance: straggler detection.

Slow hosts and slow launches (stragglers) amplify tail latency. The
detector here is pure host-side logic, unit-testable without hardware; the
serving pump feeds it launch round-trip times
(:mod:`repro_torch.serve.feature_service`). Elastic re-mesh planning and
the fault log come with the training stack.
"""
from __future__ import annotations

import math


class StragglerDetector:
    """EWMA step-time tracker; flags outlier steps/hosts.

    On real fleets the per-host step time arrives via heartbeats; here the
    single-process trainer feeds its own step times (and tests feed synthetic
    fleets). Mitigation policy is up to the caller (re-mesh, evict, re-route
    data) — detection must be cheap and robust to warmup.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.mean: float | None = None
        self.var: float = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_outlier = False
        if self.n > self.warmup:
            sd = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
            if dt > self.mean + self.threshold * sd and dt > 1.2 * self.mean:
                is_outlier = True
                self.flagged.append((step, dt))
        if not is_outlier:          # don't pollute the EWMA with outliers
            delta = dt - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta ** 2)
        return is_outlier

    @property
    def straggler_fraction(self) -> float:
        return len(self.flagged) / max(self.n, 1)

    def hedge_cutoff(self, factor: float, floor: float) -> float:
        """Latency past which a BACKUP attempt should launch (the
        speculative-duplicate idiom: past ``factor`` x the EWMA mean a
        step is probably straggling, so racing a duplicate on healthy
        hardware beats waiting it out). ``floor`` bounds the cutoff from
        below so warmup noise (or an untrained mean) never hedges
        healthy-latency work; before any observation the floor IS the
        cutoff."""
        return max(floor, factor * (self.mean or 0.0))
