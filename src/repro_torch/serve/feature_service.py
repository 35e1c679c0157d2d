"""FeatureService: a pump-driven, coalescing ADV feature server.

The serving-side rendering of the paper's §6 pipeline: features are served
directly out of the data system ('codes in, features out'), not exported
and recomputed. A request names table rows; the service chunks it to
static bucket shapes and queues the chunks; ONE background pump thread
coalesces up to ``coalesce`` same-bucket chunks into ONE kernel launch,
keeps up to ``prefetch`` launches in flight, and retires finished launches
into per-ticket results in request order::

    submit(rows) -> [queue] --group--> pump: launch (async on the device)
                                              |
               results <-- retire <-- event ready, pinned host copy

Packed serving ships indices only: every chunk — word-aligned range or
arbitrary row set — is served by the packed rows kernel
(:meth:`FeatureExecutor._rows_future`), which computes word index + bit
offset against the resident streams, so the per-launch host->device
traffic is the padded (coalesce x bucket) int32 index vector.
``stats['bytes_h2d']`` therefore reports INDEX bytes; int32 plans ship
(C, bucket) code slices through the int32 kernel and account those.

``submit(where=predicate)`` serves the rows a predicate selects: the scan
kernel finds them on the resident words, and they are pumped like any
explicit request. ``count_where``, ``filtered_rows``, ``groupby_where`` and
``agg_where`` answer pushdown queries directly, without the pump.

Each launch copies its features into a pinned host buffer asynchronously
and records a CUDA event behind the copy; retiring a launch waits on that
event (``Event.query()`` first, blocking only when the copy is not yet
done), so the pump never synchronises the whole device.

Request classes (``classes=``, :class:`RequestClass`): every service
carries a ``default`` class; ``submit(klass=...)`` names another. The pump
picks the class it serves next by ``priority + waited / aging_s`` over
each class's oldest queued chunk (static priority plus anti-starvation
aging), and groups only that class's chunks, up to its own ``coalesce``
depth and ``linger_us`` hold. ``linger_us`` adds bounded-latency
coalescing: under light load the pump may hold a PARTIAL launch group
open until its oldest chunk has been queued ``linger_us`` microseconds.
Per-class counts and latency histograms back :meth:`class_stats` and
:meth:`latency_percentile`; :mod:`repro_torch.serve.frontend` puts
admission control in front.

Fault tolerance: a launch or retire that raises fails only its own launch
group, which re-enqueues at the head of the queue after capped exponential
backoff (:class:`FaultPolicy`) and re-launches the same kernel; a chunk
out of retries resolves its ticket to a :class:`ServeError` chained to the
cause, and the service keeps serving. Failures and straggler-flagged round
trips (:class:`StragglerDetector`) strike the stream's breaker, whose
state ``stats['unhealthy_shards']`` and :attr:`unhealthy` report. The
chaos harness (``faults=``, :class:`FaultInjector`, no-op by default)
fails, delays or stalls launches ON the launch path, so injected faults
take the recovery path a real device error would. ``deadline_ms`` on
:meth:`submit` evicts a request's still-queued chunks once expired (the
ticket resolves to :class:`DeadlineExceeded`, also a ``TimeoutError``);
``timeout=`` on :meth:`result`/:meth:`drain`/:meth:`collect` bounds every
blocking wait, so a device fault can never hang a caller.

The pump runs under a supervisor: an exception in its own control logic
(not a guarded launch or retire) restarts the pump loop with the ledger
intact — a group it had taken and not launched, or the unretired rest of
a launch it was retiring, goes back to the head of the queue — up to
``FaultPolicy.pump_restarts`` times; past that the crash is terminal and
every entry point raises it.

``pause``/``resume`` hold launches (queueing continues) so callers can
force maximal coalescing; ``shutdown`` (also via the context-manager
protocol) drains the queue and joins the pump thread.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pipeline import (FeatureExecutor, FeaturePipeline,
                                       FeaturePlan, pad_rows_edge,
                                       to_device)
from repro_torch.serve.classes import LatencyHistogram, RequestClass
from repro_torch.serve.faults import (DeadlineExceeded, FaultInjector,
                                      FaultPolicy, ServeError, StreamBreaker)
from repro_torch.train.fault import StragglerDetector

DEFAULT_BUCKETS = (64, 256, 1024)
STREAM = 0      # the token (and injector index) of the one launch stream


@dataclass(eq=False)
class _Chunk:
    """One bucket-shaped slice of a request, queued for the pump."""
    ticket: int
    rows: np.ndarray        # raw (unpadded) row indices
    n: int                  # valid rows (== rows.shape[0])
    bucket: int             # static launch shape this chunk pads to
    dest: int               # first row of this chunk in the request output
    t_enq: float = 0.0
    # -- fault-recovery state (pump thread only) --
    attempts: int = 0               # launches tried so far
    not_before: float = 0.0         # retry backoff deadline (perf_counter)
    avoid: frozenset = frozenset()  # stream tokens this chunk failed on
    klass: str = "default"          # request class (pump scheduling key)


@dataclass
class _Flight:
    """One dispatched launch awaiting retire (pump thread only).

    ``ready_at`` gates the retire on an injected stall (simulated slow
    device compute — 0.0 means none)."""
    host: torch.Tensor              # pinned copy of the launch buffer
    event: torch.cuda.Event | None  # recorded after the copy (None on CPU)
    parts: list                     # (ticket, n, dest, row_off) per chunk
    group: list                     # the _Chunks this launch covers
    t0: float                       # dispatch time (perf_counter)
    ready_at: float = 0.0           # injected-stall retire gate


class FeatureService:
    """Request-queue-driven feature serving over a compiled FeaturePlan."""

    def __init__(self, plan: FeaturePlan | FeaturePipeline, *,
                 prefetch: int = 2,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 coalesce: int = 4, linger_us: float = 0.0,
                 faults: FaultInjector | None = None,
                 fault_policy: FaultPolicy | None = None,
                 classes: tuple[RequestClass, ...] | None = None):
        if isinstance(plan, FeaturePipeline):
            plan = plan.plan
        if prefetch < 2:
            raise ValueError("FeatureService is double-buffered: prefetch >= 2")
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bad bucket sizes {buckets!r}")
        if linger_us < 0:
            raise ValueError("linger_us must be >= 0")
        if coalesce < 1:
            raise ValueError("coalesce must be >= 1")
        self.plan = plan
        self.packed = plan.packed
        self.prefetch = prefetch
        self._executor = FeatureExecutor(plan, prefetch=prefetch)
        self.buckets = tuple(sorted(buckets))
        if self.packed:
            # word-aligned buckets keep the range iterator's discipline and
            # one launch shape per bucket
            self.buckets = tuple(sorted(
                {-(-b // 32) * 32 for b in self.buckets}))
        self.coalesce = coalesce if self.packed else 1
        self._linger_s = linger_us * 1e-6
        # -- pump-shared state: everything below is guarded by _lock --
        self._queue: deque[_Chunk] = deque()
        self._inflight: deque[_Flight] = deque()
        self._busy = False                  # a launch/retire is mid-flight
        self._chunks_total: dict[int, int] = {}
        self._chunks_done: dict[int, int] = {}
        self._ticket_rows: dict[int, int] = {}
        self._out_buf: dict[int, np.ndarray] = {}
        self._results: dict[int, np.ndarray] = {}
        self._claimed: set[int] = set()     # tickets a result() call waits on
        self._submitted_at: dict[int, float] = {}
        self._next_ticket = 0
        self._paused = False
        self._shutdown = False
        self._flushes = 0               # drain()s in progress: no lingering
        self._pump_error: BaseException | None = None
        # -- fault-tolerance state --
        self._faults = faults
        self._policy = fault_policy if fault_policy is not None \
            else FaultPolicy()
        self._errors: dict[int, ServeError] = {}   # failed-ticket results
        self._dead: set[int] = set()    # failed tickets: drop their chunks
        self._deadlines: dict[int, float] = {}     # ticket -> perf_counter
        self._breaker = StreamBreaker()
        self._straggler = StragglerDetector(
            threshold=self._policy.straggler_threshold,
            warmup=self._policy.straggler_warmup)
        # -- pump supervisor state (journal: what the pump held when it
        #    died, so a restart re-enqueues instead of losing tickets) --
        self._pump_restarts_used = 0
        self._pump_taken: list[_Chunk] | None = None   # taken, not in flight
        self._pump_retiring: _Flight | None = None
        self._retire_prog = 0       # parts fully retired of current flight
        # -- latency accounting: the deque is a recent-8192 window; the
        #    histograms see every completed ticket and back
        #    latency_percentile()/class_stats() --
        self.latencies: deque[float] = deque(maxlen=8192)  # per-ticket s
        self._lat_hist = LatencyHistogram()
        # -- request classes: 'default' (service-wide coalesce/linger,
        #    priority 1, no deadline) is always there --
        self._classes: dict[str, RequestClass] = {
            "default": RequestClass("default")}
        for rc in (classes or ()):
            if rc.name in self._classes and rc.name != "default":
                raise ValueError(f"duplicate request class {rc.name!r}")
            self._classes[rc.name] = rc
        self._ticket_class: dict[int, str] = {}
        self._class_stats: dict[str, dict] = {
            name: {"requests": 0, "completed": 0, "failed": 0, "rows": 0,
                   "hist": LatencyHistogram()}
            for name in self._classes}
        self.stats = {"requests": 0, "rows": 0, "padded_rows": 0,
                      "batches": 0, "launches": 0, "max_inflight": 0,
                      "latency_s_total": 0.0, "completed": 0,
                      "latency_samples_total": 0,
                      "bytes_h2d": 0, "filtered_requests": 0,
                      "retries": 0, "timeouts": 0, "failed_tickets": 0,
                      "unhealthy_shards": 0, "stragglers": 0,
                      "pump_restarts": 0}
        # conditions over ONE lock, so each event wakes only the threads
        # that care:
        #   _work — the pump sleeps here; submits that queued work (and
        #           pause/shutdown/drain-flush) notify
        #   _cv   — result()/poll() waiters; notified when a ticket lands
        #   _idle — drain() waiters; notified when the pump goes idle
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._cv = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._pump = threading.Thread(target=self._pump_main,
                                      name="feature-service-pump",
                                      daemon=True)
        self._pump.start()

    # -- lifecycle ------------------------------------------------------------------
    def __enter__(self) -> "FeatureService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self, drain: bool = True) -> None:
        """Stop the pump thread and join it.

        ``drain=True`` (default) serves everything already queued first (an
        orderly drain — results stay retrievable via :meth:`result` /
        :meth:`drain`); ``drain=False`` discards queued-but-unlaunched
        chunks, forgetting their tickets. Idempotent.
        """
        with self._lock:
            if not drain:
                dropped = {ch.ticket for ch in self._queue}
                self._queue.clear()
                for t in dropped:
                    self._chunks_total.pop(t, None)
                    self._chunks_done.pop(t, None)
                    self._ticket_rows.pop(t, None)
                    self._out_buf.pop(t, None)
                    self._submitted_at.pop(t, None)
                    self._deadlines.pop(t, None)
                    self._ticket_class.pop(t, None)
            self._shutdown = True
            self._notify_everyone()
        self._pump.join()

    def _notify_everyone(self) -> None:
        """Wake every waiter class (lock held) — shutdown/error paths."""
        self._work.notify_all()
        self._cv.notify_all()
        self._idle.notify_all()

    def _check_pump(self) -> None:
        if self._pump_error is not None:
            raise RuntimeError("feature-service pump thread died") \
                from self._pump_error

    def pause(self) -> None:
        """Hold launches (submissions still queue) — lets a caller batch a
        burst of submits into maximally coalesced launches."""
        with self._lock:
            self._check_pump()
            self._paused = True
            self._work.notify_all()

    def resume(self) -> None:
        with self._lock:
            self._check_pump()
            self._paused = False
            self._work.notify_all()

    # -- fault tolerance: the breaker, stragglers, failure handling -----------------
    @property
    def unhealthy(self) -> list[int]:
        """Shards whose launch stream's breaker is OPEN right now: ``[0]``
        or ``[]`` (one shard, one stream)."""
        with self._lock:
            return [0] if self._breaker.is_open(
                self._policy.breaker_fails, time.perf_counter()) else []

    def _close_breaker_locked(self, now: float) -> None:
        """A round trip proved the stream healthy: close its breaker, and
        when it was TRIPPED, give back its ``unhealthy_shards`` mark (a
        gauge of currently-unhealthy streams). A success while the breaker
        is still OPEN does not close it: the forced launches through an
        open breaker are not probes — the breaker holds until the cooldown
        makes the stream half-open and a success there is the probe."""
        b = self._breaker
        if b.is_open(self._policy.breaker_fails, now):
            return
        if b.fails >= self._policy.breaker_fails:
            self.stats["unhealthy_shards"] -= 1
        b.reset()

    def _strike_locked(self, now: float) -> bool:
        """One failure (or straggler flag) on the stream; True when this
        strike TRIPPED the breaker."""
        p = self._policy
        if self._breaker.strike(p.breaker_fails, p.breaker_cooldown_s, now):
            self.stats["unhealthy_shards"] += 1
            return True
        return False

    def _observe_latency_locked(self, dt: float, now: float) -> None:
        """Feed the straggler detector one launch round-trip time; a
        flagged launch that also clears the absolute floor
        (``straggler_min_s``) strikes the breaker, otherwise the round
        trip closes it."""
        flagged = self._straggler.observe(self.stats["launches"], dt)
        if flagged and dt >= self._policy.straggler_min_s:
            self.stats["stragglers"] += 1
            self._strike_locked(now)
        else:
            self._close_breaker_locked(now)

    def _fail_ticket_locked(self, ticket: int, err: ServeError, *,
                            timeout: bool = False) -> None:
        """Resolve ``ticket`` to a typed error (lock held): the ledger
        entries go, the error is retrievable via poll/result/collect, and
        chunks of this ticket still queued are dropped on sight
        (``_dead``). Idempotent for already-resolved tickets."""
        if ticket not in self._chunks_total:
            return
        del self._chunks_total[ticket]
        self._chunks_done.pop(ticket, None)
        self._ticket_rows.pop(ticket, None)
        self._out_buf.pop(ticket, None)
        self._deadlines.pop(ticket, None)
        self._submitted_at.pop(ticket, None)
        self._dead.add(ticket)
        self._errors[ticket] = err
        self.stats["failed_tickets"] += 1
        k = self._ticket_class.pop(ticket, None)
        if k is not None:
            self._class_stats[k]["failed"] += 1
        if timeout:
            self.stats["timeouts"] += 1
        self._cv.notify_all()

    def _handle_launch_failure(self, group: list[_Chunk],
                               err: Exception) -> None:
        """A launch or retire raised (lock held, pump thread): strike the
        breaker, then re-enqueue the group at the head of the queue after
        capped exponential backoff — the retry re-launches the same
        kernel. Chunks out of retries resolve their tickets to a
        :class:`ServeError` chained to ``err``; nothing else is touched."""
        now = time.perf_counter()
        self._strike_locked(now)
        retry, failed = [], []
        for ch in group:
            (retry if ch.attempts + 1 <= self._policy.max_retries
             and ch.ticket not in self._dead else failed).append(ch)
        for ch in failed:
            e = ServeError(
                f"request failed after {ch.attempts + 1} launch attempts "
                f"on shard 0: {err!r}", ticket=ch.ticket, shard=0,
                attempts=ch.attempts + 1)
            e.__cause__ = err
            self._fail_ticket_locked(ch.ticket, e)
        if not retry:
            return
        for ch in reversed(retry):
            ch.attempts += 1
            ch.avoid = ch.avoid | {STREAM}
            ch.not_before = now + self._policy.backoff_for(ch.attempts)
            self._queue.appendleft(ch)
        self.stats["retries"] += 1
        self._work.notify_all()

    # -- requests -------------------------------------------------------------------
    def submit(self, rows: np.ndarray | None = None, *, where=None,
               deadline_ms: float | None = None,
               klass: str = "default") -> int:
        """Enqueue a featurization request; returns a ticket for the result.

        Only queues: the pump picks the chunks up, coalesces them with other
        queued work and launches — the caller goes on submitting while the
        device gathers. ``deadline_ms`` bounds the request's time in the
        queue: chunks still QUEUED once it expires are dropped before launch
        and the ticket resolves to :class:`DeadlineExceeded` (chunks already
        in flight retire normally).

        ``where=<predicate>`` (instead of ``rows``) is the pushdown form:
        the matching rows are found by the scan kernel over the resident
        words (:meth:`FeatureExecutor.filtered_rows`) and then pumped
        through the same coalescing launch path as explicit rows — "serve
        features WHERE ..." as one ticket. An empty selection resolves at
        once to a (0, out_dim) result without reaching the pump.

        ``klass`` names a registered :class:`RequestClass` (construct the
        service with ``classes=``): it sets the pump's scheduling
        priority, coalescing policy and — when ``deadline_ms`` is not
        passed — the class's default deadline.
        """
        rc = self._classes.get(klass)
        if rc is None:
            raise ValueError(f"unknown request class {klass!r} "
                             f"(registered: {sorted(self._classes)})")
        if deadline_ms is None:
            deadline_ms = rc.deadline_ms
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        filtered = where is not None
        if filtered:
            if rows is not None:
                raise ValueError("pass rows OR where, not both")
            rows = self._pushdown_ex().filtered_rows(where)
            if rows.size == 0:
                return self._resolved_empty_ticket(klass)
        elif rows is None:
            raise ValueError("need rows or where")
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if rows.size == 0:
            raise ValueError("empty request")
        if int(rows.min()) < 0 or int(rows.max()) >= self.plan.n_rows:
            raise IndexError(f"row indices out of range [0, {self.plan.n_rows})")
        cap = self.buckets[-1]
        pieces, padded = [], 0
        for start in range(0, rows.shape[0], cap):
            chunk = rows[start:start + cap]
            bucket = self._bucket(chunk.shape[0])
            padded += bucket - chunk.shape[0]
            pieces.append(_Chunk(0, chunk, chunk.shape[0], bucket, start))
        with self._lock:
            self._check_pump()
            if self._shutdown:
                raise RuntimeError("service is shut down")
            ticket = self._next_ticket
            self._next_ticket += 1
            now = time.perf_counter()
            self._submitted_at[ticket] = now
            if deadline_ms is not None:
                self._deadlines[ticket] = now + deadline_ms / 1e3
            self.stats["requests"] += 1
            self.stats["filtered_requests"] += filtered
            self.stats["rows"] += rows.size
            self.stats["padded_rows"] += padded
            self._chunks_total[ticket] = len(pieces)
            self._ticket_rows[ticket] = rows.size
            self._ticket_class[ticket] = klass
            cs = self._class_stats[klass]
            cs["requests"] += 1
            cs["rows"] += rows.size
            q = self._queue
            n0 = len(q)
            for ch in pieces:
                ch.ticket = ticket
                ch.t_enq = now
                ch.klass = klass
                q.append(ch)
            # wake the parked pump when the queue went empty -> nonempty,
            # when this submit completed a coalescing group, or when it
            # OUTRANKS the queue's head (a lingering low-priority group
            # must not make a fresh high-priority chunk wait out its
            # hold); chunks landing mid-group ride the pending tick
            preempt = n0 > 0 and rc.priority > \
                self._classes[q[0].klass].priority
            if n0 == 0 or preempt or n0 < self.coalesce <= len(q):
                self._work.notify_all()
            return ticket

    def _resolved_empty_ticket(self, klass: str) -> int:
        """A filtered request that matched no row: a ticket whose (0, F)
        result is already on the host (poll/result look at the results
        before the chunk ledger, so the pump is not involved)."""
        with self._lock:
            self._check_pump()
            if self._shutdown:
                raise RuntimeError("service is shut down")
            ticket = self._next_ticket
            self._next_ticket += 1
            self.stats["requests"] += 1
            self.stats["filtered_requests"] += 1
            self.stats["completed"] += 1
            cs = self._class_stats[klass]
            cs["requests"] += 1
            cs["completed"] += 1
            self._results[ticket] = np.zeros((0, self.plan.out_dim),
                                             np.float32)
            self._cv.notify_all()
            return ticket

    def _bucket(self, n: int) -> int:
        """Smallest static bucket >= n (largest bucket caps a chunk)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -- the pump -------------------------------------------------------------------
    def _coalesce_for(self, rc: RequestClass) -> int:
        """Effective coalescing depth for one class: the class's own when
        set, else the service-wide depth — capped at the service depth
        either way (launch buffers are sized ``(coalesce, bucket)``) and
        1 on int32 plans (no coalesced launches there)."""
        if not self.packed:
            return 1
        c = rc.coalesce if rc.coalesce is not None else self.coalesce
        return max(1, min(c, self.coalesce))

    def _linger_for(self, rc: RequestClass) -> float:
        return rc.linger_us * 1e-6 if rc.linger_us is not None \
            else self._linger_s

    def _select_class(self, queue: deque, now: float):
        """Pick the request class the pump serves next (lock held).

        Scores each class PRESENT in the queue by its oldest chunk:
        ``priority + waited / aging_s``, so a starving low-priority head
        eventually outranks a fresh high-priority one. Classes whose head
        chunk is still in retry backoff are not candidates. Returns
        ``(klass, head, 0.0)`` for the winner, or ``(None, None, hold)``
        when every present class is backing off (``hold`` = seconds until
        the nearest backoff ends, the caller's wait bound)."""
        heads: dict[str, _Chunk] = {}
        n_classes = len(self._classes)
        for ch in queue:
            if ch.klass not in heads:
                heads[ch.klass] = ch
                if len(heads) == n_classes:
                    break
        best = best_head = None
        best_eff = 0.0
        hold = None
        for name, ch in heads.items():
            if ch.not_before > now:
                h = ch.not_before - now
                hold = h if hold is None else min(hold, h)
                continue
            rc = self._classes[name]
            eff = rc.priority + (now - ch.t_enq) / rc.aging_s
            if best is None or eff > best_eff:
                best, best_head, best_eff = name, ch, eff
        if best is None:
            return None, None, hold if hold is not None else 0.0
        return best, best_head, 0.0

    def _linger_left(self, queue: deque, klass: str, head: _Chunk,
                     now: float) -> float:
        """Seconds the selected class's head launch group should stay
        open: 0 once the class's coalesce depth of same-bucket chunks is
        queued, else until the head chunk has waited the class's linger."""
        rc = self._classes[klass]
        cap = self._coalesce_for(rc)
        n_match = 0
        for ch in queue:
            if ch.klass == klass and ch.bucket == head.bucket:
                n_match += 1
                if n_match >= cap:
                    return 0.0
        return head.t_enq + self._linger_for(rc) - now

    def _all_idle(self) -> bool:
        return not (self._queue or self._inflight or self._busy)

    def _pick_action(self):
        """The pump's next action (lock held): ``("launch", None)`` when the
        in-flight window has room and the selected class's group is ready,
        else ``("retire", None)`` for the oldest launch, ``("wait",
        timeout)`` or ``("exit", None)``. A lingering partial group or a
        queue whose every class is in retry backoff launches nothing, but
        its deadline bounds the wait."""
        held = self._paused and not self._shutdown
        linger = None
        queue = self._queue
        if queue and not held and len(self._inflight) < self.prefetch:
            now = time.perf_counter()
            klass, head, hold = self._select_class(queue, now)
            if klass is None:
                linger = hold
            else:
                rc = self._classes[klass]
                if self._linger_for(rc) > 0 and self._coalesce_for(rc) > 1 \
                        and not self._shutdown and not self._flushes:
                    left = self._linger_left(queue, klass, head, now)
                    if left <= 0:
                        return "launch", None
                    linger = left
                else:
                    return "launch", None
        if self._inflight and (linger is None
                               or len(self._inflight) >= self.prefetch):
            return "retire", None
        if self._shutdown and self._all_idle():
            return "exit", None
        return "wait", linger

    def _pump_main(self) -> None:
        """Pump SUPERVISOR (the thread target): run the pump loop, and
        when it dies of an exception in its own control logic (not a
        guarded launch/retire) restart it with the ledger intact
        (:meth:`_recover_pump_locked`), up to ``FaultPolicy.pump_restarts``
        times. Past the budget the crash is terminal: ``_pump_error``
        poisons the service and every waiter is woken."""
        while True:
            try:
                self._pump_loop()
                return
            except BaseException as e:
                with self._lock:
                    if self._pump_restarts_used >= \
                            self._policy.pump_restarts:
                        self._pump_error = e
                        self._notify_everyone()
                        return
                    self._pump_restarts_used += 1
                    self.stats["pump_restarts"] += 1
                    self._recover_pump_locked()

    def _recover_pump_locked(self) -> None:
        """Restore the ledger's invariants after a pump crash (lock held):
        clear the busy marker, and put back at the head of the queue, in
        their order, a group the dying pump had taken but not recorded in
        flight, and the not-yet-distributed chunks of a retire it was
        part way through (``_retire_prog`` marks where it stopped)."""
        self._busy = False
        if self._pump_taken is not None:
            for ch in reversed(self._pump_taken):
                self._queue.appendleft(ch)
            self._pump_taken = None
        fl = self._pump_retiring
        if fl is not None:
            for ch in reversed(fl.group[self._retire_prog:]):
                if ch.ticket in self._chunks_total:
                    self._queue.appendleft(ch)
            self._pump_retiring = None
        self._work.notify_all()

    def _pump_loop(self) -> None:
        """Coalesce -> launch -> retire until shutdown, with a
        ``prefetch``-deep in-flight window. The only thread that launches
        kernels or waits on their results; launches are asynchronous, so
        the device works while the pump prepares the next group.

        Fault isolation: dispatching a launch and waiting on its result are
        guarded per launch group — an exception there goes to
        :meth:`_handle_launch_failure` (retry with backoff, else a
        per-ticket ServeError) and the loop goes on; an exception in the
        loop's own logic lands in the supervisor (:meth:`_pump_main`).
        """
        while True:
            with self._lock:
                while True:
                    action, arg = self._pick_action()
                    if action != "wait":
                        break
                    if self._all_idle():
                        self._idle.notify_all()
                    self._work.wait(timeout=arg)
                if action == "exit":
                    return
                if action == "launch":
                    group = self._take_group(self._queue,
                                             time.perf_counter())
                    if not group:
                        # the whole head group was evicted (failed or
                        # deadline-expired tickets) — nothing to launch
                        if self._all_idle():
                            self._idle.notify_all()
                        continue
                    self._pump_taken = group
                else:
                    fl = self._inflight.popleft()
                    group = fl.group
                    self._pump_retiring = fl
                    self._retire_prog = 0
                self._busy = True
            try:
                if action == "launch":
                    fl, nbytes = self._launch(group)
                else:
                    arr, dt = self._await_flight(fl)
            except Exception as e:
                with self._lock:
                    self._handle_launch_failure(group, e)
                    self._pump_taken = self._pump_retiring = None
                    self._busy = False
                    if self._all_idle():
                        self._idle.notify_all()
                continue
            with self._lock:
                if action == "launch":
                    self._inflight.append(fl)
                    self._pump_taken = None
                    self.stats["launches"] += 1
                    self.stats["batches"] += len(fl.parts)
                    self.stats["bytes_h2d"] += nbytes
                    self.stats["max_inflight"] = max(
                        self.stats["max_inflight"], len(self._inflight))
                else:
                    self._observe_latency_locked(dt, time.perf_counter())
                    if self._retire(arr, fl.parts):
                        self._cv.notify_all()
                    self._pump_retiring = None
                self._busy = False
                if self._all_idle():
                    self._idle.notify_all()

    def _take_group(self, queue: deque, now: float) -> list[_Chunk]:
        """Pop one launch group (lock held): the :meth:`_select_class`
        winner's chunks, up to the class's coalesce depth, sharing the
        class head's bucket shape (FIFO within the class; other classes'
        chunks keep their place). Chunks of failed tickets are dropped on
        sight, a chunk whose ticket's deadline expired resolves it to
        :class:`DeadlineExceeded` before launch, and the take stops at a
        selected-class chunk still in retry backoff — so the group may
        come back empty."""
        klass, _head, _hold = self._select_class(queue, now)
        if klass is None:
            return []
        cap = self._coalesce_for(self._classes[klass])
        group: list[_Chunk] = []
        rest: deque[_Chunk] = deque()
        bucket = None
        while queue:
            ch = queue[0]
            if ch.ticket in self._dead:
                queue.popleft()
                continue
            dl = self._deadlines.get(ch.ticket)
            if dl is not None and now > dl:
                queue.popleft()
                self._fail_ticket_locked(ch.ticket, DeadlineExceeded(
                    f"ticket {ch.ticket} missed its deadline before launch",
                    ticket=ch.ticket, shard=0), timeout=True)
                continue
            if len(group) >= cap:
                break
            if ch.klass != klass:
                rest.append(queue.popleft())
                continue
            if ch.not_before > now:
                break
            queue.popleft()
            if bucket is None:
                bucket = ch.bucket
            (group if ch.bucket == bucket else rest).append(ch)
        rest.extend(queue)
        queue.clear()
        queue.extend(rest)
        return group

    def _launch(self, group: list[_Chunk]) -> tuple[_Flight, int]:
        """Dispatch ONE launch for a coalesced group (pump thread only);
        returns the flight and the host->device bytes it shipped.

        The chaos hook fires first, before any dispatch, so an injected
        fault or delay lands where a real device error would; its return
        value is the launch's injected stall, which gates the flight's
        retire (``ready_at``).

        Packed plans: a flat (coalesce * bucket,) int32 index vector —
        padded to the full coalesce width so every launch of a bucket has
        one shape — into the packed rows kernel; the indices are all that
        crosses to the device. int32 plans: the (C, bucket) code slice of a
        single chunk into the int32 kernel. Either way the launch buffer is
        a flat (rows, F) array and each part records its chunk's row offset
        into it; on a CUDA device it is copied to pinned host memory
        asynchronously, with an event recorded behind the copy.
        """
        t0 = time.perf_counter()
        stall = 0.0
        if self._faults is not None:
            stall = self._faults.before_launch(0, STREAM,
                                               device=self.plan.device,
                                               klass=group[0].klass)
        ready_at = t0 + stall if stall else 0.0
        bucket = group[0].bucket
        if self.packed:
            mat = np.empty((self.coalesce, bucket), np.int32)
            for i, ch in enumerate(group):
                mat[i] = pad_rows_edge(ch.rows, bucket)
            mat[len(group):] = mat[len(group) - 1]   # surplus lanes unread
            dev = self._executor._rows_future(mat.reshape(-1))
            nbytes = mat.nbytes
        else:
            codes = self.plan.host_codes(pad_rows_edge(group[0].rows, bucket))
            dev = self._executor.gather_device(
                to_device(codes, self.plan.device))
            nbytes = int(codes.nbytes)
        parts = [(ch.ticket, ch.n, ch.dest, i * bucket)
                 for i, ch in enumerate(group)]
        if dev.device.type != "cuda":
            return _Flight(dev, None, parts, group, t0, ready_at), nbytes
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        return _Flight(host, event, parts, group, t0, ready_at), nbytes

    @staticmethod
    def _await_flight(fl: _Flight) -> tuple[np.ndarray, float]:
        """The flight's features on the host once its copy has landed, and
        the launch's round-trip seconds. With no injected stall: a
        non-blocking ``Event.query()``, then a blocking wait on the event
        only if the copy is still running. With one: poll until the stall
        has passed and ``query()`` is true, 0.2 ms between checks. A fault
        in the launch surfaces here and goes to the retry path."""
        if fl.ready_at:
            while time.perf_counter() < fl.ready_at or not (
                    fl.event is None or fl.event.query()):
                time.sleep(2e-4)
        elif fl.event is not None and not fl.event.query():
            fl.event.synchronize()
        return fl.host.numpy(), time.perf_counter() - fl.t0

    def _retire(self, arr: np.ndarray, parts: list) -> bool:
        """Distribute one retired launch buffer to its tickets (lock held);
        True if any ticket completed (its waiters need a wake).

        Single-chunk requests take the sliced piece directly (copied when
        small, so the result does not pin the whole coalesced launch buffer
        for its lifetime); multi-chunk requests assemble into a per-ticket
        (rows, F) buffer at each chunk's destination.

        ``self._retire_prog`` journals how many leading parts are fully
        distributed, so the pump supervisor re-enqueues exactly the rest
        of a crashed retire's group. The pump resets it to 0 per flight.
        """
        landed = False
        for i in range(self._retire_prog, len(parts)):
            ticket, n, dest, off = parts[i]
            total = self._chunks_total.get(ticket)
            if total is None:
                # dropped by shutdown(drain=False)
                self._ticket_class.pop(ticket, None)
                self._retire_prog = i + 1
                continue
            piece = arr[off:off + n]
            if total == 1:
                if piece.size * 8 < arr.size:
                    piece = piece.copy()
                self._results[ticket] = piece
            else:
                buf = self._out_buf.get(ticket)
                if buf is None:
                    buf = np.empty((self._ticket_rows[ticket],
                                    arr.shape[1]), arr.dtype)
                    self._out_buf[ticket] = buf
                buf[dest:dest + n] = piece
                done = self._chunks_done.get(ticket, 0) + 1
                if done < total:
                    self._chunks_done[ticket] = done
                    self._retire_prog = i + 1
                    continue
                self._chunks_done.pop(ticket, None)
                self._results[ticket] = self._out_buf.pop(ticket)
            del self._chunks_total[ticket]
            self._ticket_rows.pop(ticket, None)
            self._deadlines.pop(ticket, None)
            landed = True
            t0 = self._submitted_at.pop(ticket, None)
            if t0 is not None:
                lat = time.perf_counter() - t0
                self.stats["latency_s_total"] += lat
                self.stats["completed"] += 1
                self.stats["latency_samples_total"] += 1
                self.latencies.append(lat)
                self._lat_hist.record(lat)
                cs = self._class_stats.get(
                    self._ticket_class.pop(ticket, "default"))
                if cs is not None:
                    cs["completed"] += 1
                    cs["hist"].record(lat)
            self._retire_prog = i + 1
        return landed

    # -- client API ---------------------------------------------------------------------
    def poll(self, ticket: int) -> bool:
        """True once the ticket has RESOLVED — its result is on host, or it
        failed and :meth:`result` will raise its typed error. Raises
        KeyError for unknown/already-collected tickets."""
        with self._lock:
            self._check_pump()
            if ticket in self._results or ticket in self._errors:
                return True
            if ticket not in self._chunks_total:
                raise KeyError(f"unknown or already-collected ticket {ticket}")
            return False

    def _queued_while_paused(self, ticket: int | None) -> bool:
        """True when blocking on this work would deadlock: the pump is
        paused (and not shutting down) and the awaited chunks are still
        queued. Lock held."""
        if not self._paused or self._shutdown:
            return False
        if ticket is None:
            return bool(self._queue)
        return any(ch.ticket == ticket for ch in self._queue)

    def result(self, ticket: int,
               timeout: float | None = None) -> np.ndarray:
        """Block until the ticket RESOLVES: return its (rows, F) features,
        or raise its typed error (:class:`ServeError`, or
        :class:`DeadlineExceeded`). ``timeout`` (seconds) bounds the wait
        with a builtin ``TimeoutError``; the ticket then stays pending.
        Raises RuntimeError instead of deadlocking if the service is paused
        with this ticket's chunks still unlaunched."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            # claim the ticket so a concurrent drain() can't sweep it away
            self._claimed.add(ticket)
            try:
                while True:
                    self._check_pump()
                    if ticket in self._results:
                        return self._results.pop(ticket)
                    err = self._errors.pop(ticket, None)
                    if err is not None:
                        raise err
                    if ticket not in self._chunks_total:
                        raise KeyError(
                            f"unknown or already-collected ticket {ticket}")
                    if self._queued_while_paused(ticket):
                        raise RuntimeError(
                            f"ticket {ticket} is queued but the service is "
                            "paused — resume() before blocking on results")
                    wait = 0.5
                    if deadline is not None:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            raise TimeoutError(
                                f"result({ticket}) timed out after "
                                f"{timeout} s")
                        wait = min(wait, left)
                    self._cv.wait(timeout=wait)
            finally:
                self._claimed.discard(ticket)

    def drain(self, timeout: float | None = None) -> dict[int, np.ndarray]:
        """Wait until everything queued or in flight is done; return
        {ticket: features} collected — except tickets another thread is
        blocked on in result(). Failed tickets are not in the dict; their
        errors stay retrievable via :meth:`result`/:meth:`collect`."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            try:
                # a drain wants everything NOW: partial groups stop
                # lingering while any drain is in progress
                self._flushes += 1
                self._work.notify_all()
                while not self._all_idle():
                    self._check_pump()
                    if self._queued_while_paused(None):
                        raise RuntimeError("queue is held by pause() — "
                                           "resume() before drain()")
                    wait = 0.5
                    if deadline is not None:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            raise TimeoutError(
                                f"drain() timed out after {timeout} s")
                        wait = min(wait, left)
                    self._idle.wait(timeout=wait)
                self._check_pump()
            finally:
                self._flushes -= 1
            out = {t: r for t, r in self._results.items()
                   if t not in self._claimed}
            for t in out:
                del self._results[t]
            return out

    def collect(self, timeout: float | None = None) -> dict:
        """Drain, then return EVERYTHING that resolved: ``{ticket:
        features | ServeError}``, both consumed."""
        out: dict = dict(self.drain(timeout))
        with self._lock:
            errs = {t: e for t, e in self._errors.items()
                    if t not in self._claimed}
            for t in errs:
                del self._errors[t]
        out.update(errs)
        return out

    # -- predicate pushdown queries (no pump involvement) -----------------------
    def _pushdown_ex(self) -> FeatureExecutor:
        if not self.packed:
            raise RuntimeError("predicate pushdown needs a packed plan "
                               "(resident word streams)")
        return self._executor

    def filtered_rows(self, where) -> np.ndarray:
        """Matching row indices via the device predicate scan."""
        return self._pushdown_ex().filtered_rows(where)

    def count_where(self, where) -> int:
        """SELECT COUNT(*) WHERE — one scan launch."""
        return self._pushdown_ex().count_where(where)

    def groupby_where(self, column: str, where):
        """GROUP BY column COUNT(*) WHERE — masked device histogram."""
        return self._pushdown_ex().groupby_where(column, where)

    def agg_where(self, where, column: str, agg: str = "count") -> float:
        """Masked count/sum/mean of ``column`` under a predicate."""
        return self._pushdown_ex().agg_where(where, column, agg)

    # -- streaming convenience ----------------------------------------------------
    def serve_stream(self, row_batches):
        """Featurize an iterator of row-index batches through the pump.

        Yields (rows, features) in submission order while keeping up to
        ``prefetch`` launches in flight on the pump side.
        """
        def gen():
            # the pump runs the prefetch-deep window; this FIFO only stops
            # the producer racing ahead of the consumer
            pending: deque[tuple[np.ndarray, int]] = deque()
            for rows in row_batches:
                rows = np.asarray(rows)
                pending.append((rows, self.submit(rows)))
                if len(pending) > self.prefetch:
                    r, t = pending.popleft()
                    yield r, self.result(t)
            while pending:
                r, t = pending.popleft()
                yield r, self.result(t)
        return gen()

    # -- reporting --------------------------------------------------------------
    @property
    def classes(self) -> dict[str, RequestClass]:
        """The registered request classes (always includes 'default')."""
        return dict(self._classes)

    def latency_percentile(self, q: float,
                           klass: str | None = None) -> float:
        """The q-th per-ticket latency percentile in SECONDS from the
        streaming histogram over every completed ticket since construction
        (or the last :meth:`reset_latency_window`), not the ``latencies``
        deque's recent window; ``klass`` narrows to one request class."""
        with self._lock:
            h = self._lat_hist if klass is None \
                else self._class_stats[klass]["hist"]
            return h.percentile(q)

    def class_stats(self) -> dict[str, dict]:
        """Per-request-class serving picture: counts (requests / completed
        / failed / pending / rows) plus the class's streaming latency
        summary (p50/p99/min/max/mean ms over its completed tickets).
        JSON-safe — what the front door's stats endpoint reads."""
        with self._lock:
            out = {}
            for name, cs in self._class_stats.items():
                resolved = cs["completed"] + cs["failed"]
                out[name] = {
                    "requests": cs["requests"],
                    "completed": cs["completed"],
                    "failed": cs["failed"],
                    "pending": max(cs["requests"] - resolved, 0),
                    "rows": cs["rows"],
                    **cs["hist"].summary()}
            return out

    def reset_latency_window(self) -> None:
        """Start a fresh latency observation window: clears the
        ``latencies`` deque, the streaming histograms (global and per
        class) and ``stats['latency_samples_total']``. The serving ledger
        (requests/completed/failed counters) is not touched."""
        with self._lock:
            self.latencies.clear()
            self._lat_hist = LatencyHistogram()
            self.stats["latency_samples_total"] = 0
            for cs in self._class_stats.values():
                cs["hist"] = LatencyHistogram()

    def throughput_stats(self, wall_s: float) -> dict:
        rows = self.stats["rows"]
        done = self.stats["completed"]
        resolved = done + self.stats["failed_tickets"]
        wall_ok = wall_s > 0
        return {**self.stats, "wall_s": wall_s,
                # wall_s <= 0 cannot yield a rate: 0.0 with the flag set,
                # never inf (json renders it as a token parsers reject)
                "wall_s_invalid": not wall_ok,
                "rows_per_s": rows / wall_s if wall_ok else 0.0,
                "mean_latency_s": (self.stats["latency_s_total"] / done
                                   if done else 0.0),
                # availability covers RESOLVED tickets; still-pending work
                # is reported as pending
                "pending": max(self.stats["requests"] - resolved, 0),
                "availability": done / resolved if resolved else 1.0,
                "pad_overhead": (self.stats["padded_rows"] /
                                 max(rows + self.stats["padded_rows"], 1))}
