"""Fault tolerance: straggler detection, elastic re-mesh planning and the
fault log.

Slow hosts and slow launches (stragglers) amplify tail latency, and lost
hosts need a smaller mesh and a restore from a checkpoint. Everything here
is pure host-side logic, unit-testable without hardware: the serving pump
feeds the detector launch round-trip times
(:mod:`repro_torch.serve.feature_service`), the trainer its step times
(:mod:`repro_torch.train.trainer`), and the trainer records restarts and
stragglers in a :class:`FaultLog`. :func:`plan_elastic_mesh` plans the
mesh a restore would move onto; moving onto it is not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


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


@dataclass
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    n_devices: int


def plan_elastic_mesh(n_available: int, *, model_parallel: int,
                      multi_pod: bool = False,
                      pod_size: int = 256) -> MeshPlan:
    """Largest (pod ×) data × model mesh that fits the surviving devices.

    Invariants: 'model' stays fixed (param sharding must not change — only
    data parallelism shrinks, so reshard-from-checkpoint touches batch
    sharding only); data axis is the largest divisor that fits.
    """
    if n_available < model_parallel:
        raise ValueError(f"need >= {model_parallel} devices for the model "
                         f"axis, have {n_available}")
    if multi_pod and n_available >= 2 * pod_size:
        pods = n_available // pod_size
        data = pod_size // model_parallel
        return MeshPlan((pods, data, model_parallel),
                        ("pod", "data", "model"),
                        pods * data * model_parallel)
    data = n_available // model_parallel
    return MeshPlan((data, model_parallel), ("data", "model"),
                    data * model_parallel)


@dataclass
class FaultEvent:
    step: int
    kind: str                    # 'straggler' | 'device_loss' | 'restart'
    detail: str = ""


@dataclass
class FaultLog:
    events: list[FaultEvent] = field(default_factory=list)

    def record(self, step: int, kind: str, detail: str = ""):
        self.events.append(FaultEvent(step, kind, detail))

    def summary(self) -> dict:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out
