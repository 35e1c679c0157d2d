"""Fault layer for the serving stack: typed errors, policy, chaos injection.

A production front door cannot die because one launch threw. This module
holds the pieces the pump in :mod:`repro_torch.serve.feature_service`
uses to keep serving through faults:

- **Typed per-ticket errors.** A launch group that keeps failing resolves
  its tickets to :class:`ServeError` (surfaced by ``poll``/``result``/
  ``collect`` per-ticket — never by killing the service); a request whose
  ``deadline_ms`` expires before launch resolves to
  :class:`DeadlineExceeded` (also a :class:`TimeoutError`, so generic
  timeout handling catches it). Both chain the underlying cause via
  ``__cause__``.
- **FaultPolicy.** One knob bundle for the pump's recovery machinery:
  retry count, capped exponential backoff, circuit-breaker thresholds and
  probe cooldown, straggler-detector tuning. Defaults are production-ish;
  tests shrink the time constants.
- **Circuit breaker** (:class:`StreamBreaker`): per launch stream
  (primary or replica executor). ``breaker_fails`` CONSECUTIVE failures —
  thrown launches or straggler strikes — open it for ``cooldown_s``;
  while open the pump routes the shard's launches to its other streams
  (replicas as an availability mechanism, not just a throughput one).
  After the cooldown the stream is half-open: the round-robin's next
  launch is the probe, success closes the breaker, failure re-opens it.
- **Device health** (:class:`DeviceHealth`): one step up from breakers —
  a per-DEVICE view of repeated launch failures. Every breaker TRIP is
  attributed to the failing stream's device; ``device_fails`` consecutive
  trips (no successful round trip in between) declare the device DOWN, as
  does a single :class:`DeviceDown` error (the injectable 'device died
  outright' fault). A down device's resident streams get evicted and
  rebuilt on a healthy device from the host packed words — the service's
  device-loss recovery path.
- **FaultInjector**: the deterministic, seed-driven chaos harness. Wired
  into the pump behind a no-op default (``faults=None`` costs one
  ``is None`` test per launch), it evaluates script rules against every
  launch: fail the next N launches of shard k (optionally only stream r —
  'fail replica r N times then heal'), fire on every j-th matching launch
  (periodic faults), delay a launch (straggler simulation), STALL a
  launch's retire (async straggler — the readiness gate hedged launches
  race against, without blocking the pump the way a delay does), kill a
  device outright (every launch touching it raises :class:`DeviceDown`
  until revived), plus a seed-driven random mode for the nightly chaos
  sweep. Injection happens ON the pump's launch path before dispatch, so
  an injected fault takes exactly the recovery path a real device error
  takes.

The port's service is single-device: it uses the typed errors, the
policy, one breaker and the injector. Replicas, failover, hedging and
device-loss recovery come with sharded serving; until then
:class:`DeviceHealth` and :class:`DeviceDown` are data only.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np


class ServeError(RuntimeError):
    """A ticket's request failed (launch faults exhausted their retries).

    Carries the failure's serving context: ``ticket``, owning ``shard``,
    and ``attempts`` (launch tries including the first). The underlying
    device/injection error is chained as ``__cause__``. The service stays
    up: only this ticket resolved to an error.
    """

    def __init__(self, msg: str, *, ticket: int | None = None,
                 shard: int | None = None, attempts: int = 0):
        super().__init__(msg)
        self.ticket = ticket
        self.shard = shard
        self.attempts = attempts


class DeadlineExceeded(ServeError, TimeoutError):
    """A ticket's ``deadline_ms`` expired before its chunks launched.

    Subclasses :class:`TimeoutError` too, so callers that only distinguish
    'timed out' from 'failed' can catch the builtin."""


class InjectedFault(RuntimeError):
    """The error a :class:`FaultInjector` 'fail' rule raises on the launch
    path — stands in for a real device/runtime error in chaos tests."""


class DeviceDown(RuntimeError):
    """A launch touched a device that is gone (injected via
    :meth:`FaultInjector.kill_device`, or raised by a real runtime when
    the accelerator drops off the bus). Unlike a transient launch fault,
    ONE of these marks the whole device down: every resident stream on it
    is evicted and rebuilt elsewhere rather than retried in place."""


@dataclass
class FaultPolicy:
    """Recovery knobs for the serving pump (see module docstring).

    ``max_retries`` bounds a chunk's RE-launches (so a chunk is attempted
    at most ``1 + max_retries`` times); backoff between retries is
    ``backoff_s * 2**(attempt-1)`` capped at ``backoff_cap_s``, and is
    skipped entirely when another healthy stream of the shard can take the
    retry immediately (replica failover). ``breaker_fails`` consecutive
    failures open a stream's breaker for ``breaker_cooldown_s``.
    Stragglers: a launch flagged by the per-shard
    :class:`repro_torch.train.fault.StragglerDetector` (EWMA + ``threshold``
    sigma, ``warmup`` samples) counts as a breaker strike when it took at
    least ``straggler_min_s`` — the absolute floor keeps scheduler jitter
    on fast hosts from striking healthy streams.

    Device loss: ``device_fails`` CONSECUTIVE breaker trips attributed to
    one device (no successful round trip on it in between) declare the
    device down; a :class:`DeviceDown` error does so immediately. The
    pump supervisor restarts a crashed pump loop (ledger intact) at most
    ``pump_restarts`` times; past the budget the crash is terminal, the
    pre-supervisor behavior. Hedging: once a retire wait on a launch
    exceeds ``max(hedge_min_s, hedge_factor x the shard's EWMA round-trip
    mean)`` and the shard has another healthy stream, a duplicate launch
    races the straggler (first retire wins); ``hedge=False`` turns the
    speculation off (the no-hedge benchmark baseline).
    """
    max_retries: int = 3
    backoff_s: float = 0.02
    backoff_cap_s: float = 0.5
    breaker_fails: int = 3
    breaker_cooldown_s: float = 0.25
    straggler_threshold: float = 3.0
    straggler_warmup: int = 5
    straggler_min_s: float = 0.05
    device_fails: int = 3
    pump_restarts: int = 2
    hedge: bool = True
    hedge_factor: float = 4.0
    hedge_min_s: float = 0.05

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if min(self.backoff_s, self.backoff_cap_s) < 0:
            raise ValueError("backoff must be >= 0")
        if self.breaker_fails < 1:
            raise ValueError("breaker_fails must be >= 1")
        if self.breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be >= 0")
        if self.device_fails < 1:
            raise ValueError("device_fails must be >= 1")
        if self.pump_restarts < 0:
            raise ValueError("pump_restarts must be >= 0")
        if self.hedge_factor < 1.0 or self.hedge_min_s < 0:
            raise ValueError("hedge_factor must be >= 1 and "
                             "hedge_min_s >= 0")

    def backoff_for(self, attempt: int) -> float:
        """Capped exponential backoff before retry number ``attempt``."""
        return min(self.backoff_s * (2.0 ** max(attempt - 1, 0)),
                   self.backoff_cap_s)


@dataclass
class StreamBreaker:
    """Per-launch-stream circuit breaker state (owned by the service, one
    per executor id; mutated only under the service lock)."""
    fails: int = 0              # consecutive failures / straggler strikes
    open_until: float = 0.0    # perf_counter deadline while open
    opened: int = 0             # times this breaker tripped (stats)

    def is_open(self, threshold: int, now: float) -> bool:
        """Open = skip this stream (unless it is the only one). Past
        ``open_until`` the stream is half-open: selectable again, and the
        first launch routed to it is the recovery probe."""
        return self.fails >= threshold and now < self.open_until

    def strike(self, threshold: int, cooldown_s: float,
               now: float) -> bool:
        """Record one failure; returns True when this strike TRIPPED the
        breaker closed->open (the moment a stream turns unhealthy)."""
        self.fails += 1
        if self.fails < threshold:
            return False
        self.open_until = now + cooldown_s      # probe failure re-opens
        tripped = self.fails == threshold
        if tripped:
            self.opened += 1
        return tripped

    def reset(self) -> None:
        """A round trip completed on this stream — healthy again."""
        self.fails = 0
        self.open_until = 0.0


@dataclass
class DeviceHealth:
    """Per-device failure attribution, one step above stream breakers.

    Owned by the service, keyed by ``id(device)``, mutated only under the
    service lock. Breaker trips feed :meth:`strike`; a successful round
    trip on the device feeds :meth:`ok` (consecutive counting — a device
    that intersperses successes is sick streams, not dead hardware); a
    :class:`DeviceDown` error feeds :meth:`mark_down` directly. Once a
    device is down it STAYS down for the service's lifetime (its streams
    are rebuilt elsewhere; re-admitting flapping hardware is an operator
    decision, not an automatic one — :meth:`revive` exists for tests and
    tooling)."""
    trips: dict = field(default_factory=dict)   # id(device) -> consecutive
    down: set = field(default_factory=set)      # id(device) declared dead
    lost: int = 0                               # devices declared dead ever

    def strike(self, dev_id: int, threshold: int) -> bool:
        """One breaker trip attributed to ``dev_id``; True when this trip
        crossed ``threshold`` and newly declared the device down."""
        if dev_id in self.down:
            return False
        n = self.trips.get(dev_id, 0) + 1
        self.trips[dev_id] = n
        return n >= threshold and self.mark_down(dev_id)

    def ok(self, dev_id: int) -> None:
        """A launch retired successfully on this device — not dead."""
        self.trips.pop(dev_id, None)

    def mark_down(self, dev_id: int) -> bool:
        """Declare the device dead; True when it was alive until now."""
        if dev_id in self.down:
            return False
        self.down.add(dev_id)
        self.trips.pop(dev_id, None)
        self.lost += 1
        return True

    def is_down(self, dev_id: int) -> bool:
        return dev_id in self.down

    def revive(self, dev_id: int) -> None:
        self.down.discard(dev_id)
        self.trips.pop(dev_id, None)

    def survivors(self, devices) -> list:
        """The pool minus down devices — where rebuilds may land (empty
        when every device is gone: serving falls back to host gathers)."""
        return [d for d in devices if id(d) not in self.down]


@dataclass
class _Rule:
    kind: str                   # 'fail' | 'delay' | 'stall'
    shard: int | None           # None = any shard
    stream: int | None          # None = any stream of the shard
    remaining: int              # firings left (rule heals at 0)
    after: int = 0              # matching launches to skip first
    every: int = 1              # fire on every j-th matching launch
    delay_s: float = 0.0
    seen: int = 0               # matching launches observed so far
    klass: str | None = None    # None = any request class


class FaultInjector:
    """Deterministic, seed-driven launch-fault injection for chaos tests.

    Scripted rules fire in registration order, at most one per launch
    (deterministic given the launch sequence). ``seed`` drives the random
    mode only; scripted rules need no randomness at all.

    Thread-safe: the pump calls :meth:`before_launch` outside the service
    lock (delays must not stall clients touching service state), so the
    injector guards its own counters.
    """

    def __init__(self, seed: int | None = None):
        self._rng = np.random.default_rng(seed)
        self._rules: list[_Rule] = []
        self._random: dict | None = None
        self._dead_devices: set[int] = set()
        self._lock = threading.Lock()
        self.launches_seen = 0
        self.faults_injected = 0
        self.delays_injected = 0
        self.stalls_injected = 0
        self.device_faults = 0

    # -- scripting -----------------------------------------------------------------
    def fail_launches(self, n: int = 1, *, shard: int | None = None,
                      stream: int | None = None, after: int = 0,
                      every: int = 1,
                      klass: str | None = None) -> "FaultInjector":
        """Fail the next ``n`` matching launches (then heal). ``shard``/
        ``stream`` restrict the blast radius ('fail replica ``stream`` of
        shard k ``n`` times then heal'); ``klass`` restricts to launches
        serving one request class ('fail only batch-class groups' — the
        front door's per-class chaos axis); ``after`` skips that many
        matching launches first; ``every=j`` fires on every j-th match
        (periodic faults). Returns self for chaining."""
        self._rules.append(_Rule("fail", shard, stream, n, after, every,
                                 klass=klass))
        return self

    def delay_launches(self, seconds: float, n: int = 1, *,
                       shard: int | None = None, stream: int | None = None,
                       after: int = 0, every: int = 1,
                       klass: str | None = None) -> "FaultInjector":
        """Sleep ``seconds`` on the next ``n`` matching launches —
        straggler simulation (the launch SUCCEEDS, late)."""
        self._rules.append(_Rule("delay", shard, stream, n, after, every,
                                 delay_s=seconds, klass=klass))
        return self

    def stall_launches(self, seconds: float, n: int = 1, *,
                       shard: int | None = None, stream: int | None = None,
                       after: int = 0, every: int = 1,
                       klass: str | None = None) -> "FaultInjector":
        """ASYNC straggler: the next ``n`` matching launches dispatch
        normally but their result buffers are treated as not-ready for
        ``seconds`` (the service gates the retire on the stall). Unlike
        :meth:`delay_launches` the pump keeps running — this is the slow
        device compute a hedged duplicate launch can actually race and
        beat, where a delay blocks the dispatcher itself."""
        self._rules.append(_Rule("stall", shard, stream, n, after, every,
                                 delay_s=seconds, klass=klass))
        return self

    def kill_device(self, device) -> "FaultInjector":
        """Kill ``device``: every subsequent launch dispatched to it
        raises :class:`DeviceDown` (persistently, until
        :meth:`revive_device`) — the 'accelerator fell off the bus' fault
        the device-loss recovery path evicts and rebuilds around."""
        with self._lock:
            self._dead_devices.add(id(device))
        return self

    def revive_device(self, device) -> "FaultInjector":
        """Heal a killed device (injection stops; whether the service
        trusts it again is the service's DeviceHealth policy, not ours)."""
        with self._lock:
            self._dead_devices.discard(id(device))
        return self

    def random_faults(self, p_fail: float = 0.0, p_delay: float = 0.0,
                      delay_s: float = 0.05,
                      max_events: int | None = None) -> "FaultInjector":
        """Seed-driven random mode for sweep harnesses: every launch
        draws once; ``u < p_fail`` fails it, ``u < p_fail + p_delay``
        delays it. Deterministic for a given seed and launch sequence."""
        if not 0 <= p_fail + p_delay <= 1:
            raise ValueError("p_fail + p_delay must be within [0, 1]")
        self._random = {"p_fail": p_fail, "p_delay": p_delay,
                        "delay_s": delay_s, "left": max_events}
        return self

    # -- the pump-side hook --------------------------------------------------------
    def _match(self, rule: _Rule, shard: int, stream: int,
               klass: str | None) -> bool:
        if rule.remaining <= 0:
            return False
        if rule.shard is not None and rule.shard != shard:
            return False
        if rule.klass is not None and rule.klass != klass:
            return False
        return rule.stream is None or rule.stream == stream

    def before_launch(self, shard: int, stream: int,
                      device=None, klass: str | None = None) -> float:
        """Called by the pump for every launch, BEFORE dispatch: (shard,
        stream index within the shard — 0 is the primary, i>0 replica
        i-1, ``device`` the stream's placement, ``klass`` the request
        class of the group being launched). May sleep (delay rule) or
        raise (:class:`InjectedFault` fail rules; :class:`DeviceDown` when
        the device was killed). Returns the launch's injected STALL in
        seconds (0.0 normally) — the service gates the launch's retire on
        it, simulating slow device compute without blocking the pump."""
        delay = 0.0
        stall = 0.0
        fail = None
        with self._lock:
            self.launches_seen += 1
            if device is not None and id(device) in self._dead_devices:
                self.device_faults += 1
                raise DeviceDown(
                    f"injected device loss under shard {shard} "
                    f"stream {stream}")
            for rule in self._rules:
                if not self._match(rule, shard, stream, klass):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after or \
                        (rule.seen - rule.after) % rule.every:
                    continue
                rule.remaining -= 1
                if rule.kind == "fail":
                    self.faults_injected += 1
                    fail = InjectedFault(
                        f"injected launch fault on shard {shard} "
                        f"stream {stream}")
                elif rule.kind == "stall":
                    self.stalls_injected += 1
                    stall = rule.delay_s
                else:
                    self.delays_injected += 1
                    delay = rule.delay_s
                break                           # one rule per launch
            rnd = self._random
            if fail is None and not delay and not stall \
                    and rnd is not None and \
                    (rnd["left"] is None or rnd["left"] > 0):
                u = float(self._rng.random())
                if u < rnd["p_fail"]:
                    self.faults_injected += 1
                    if rnd["left"] is not None:
                        rnd["left"] -= 1
                    fail = InjectedFault(
                        f"random launch fault on shard {shard} "
                        f"stream {stream}")
                elif u < rnd["p_fail"] + rnd["p_delay"]:
                    self.delays_injected += 1
                    if rnd["left"] is not None:
                        rnd["left"] -= 1
                    delay = rnd["delay_s"]
        if delay:
            time.sleep(delay)
        if fail is not None:
            raise fail
        return stall
