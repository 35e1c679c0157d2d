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

Sharded serving (``sharded=True`` over a packed plan) builds one
:class:`repro_torch.core.ShardedFeatureExecutor`: one resident word-stream
shard per IMCU, each on a device of the serve pool (``devices``, default
the plan's device) with its own CUDA stream. A request's rows are routed
at submit to the shards that own them (the whole request in one piece
when one shard owns it all); each shard has its own queue and its own
``prefetch``-deep in-flight window per launch stream, and the ONE pump
multiplexes every shard, retiring in global launch order. A retry prefers
a stream of its shard it has not failed on (replica failover, no
backoff); breakers are per stream. ``stats['shard_launches']``,
``['shard_batches']`` and ``['shard_bytes_h2d']`` attribute the work per
shard. A load monitor (``rebalance_every`` launches, or :meth:`rebalance`)
replicates a shard whose request-rate EWMA runs ``hot_factor`` x the
other shards' mean, sheds replicas of cooled shards, and splits the open
tail shard once appends push it past ``row_budget`` rows; every shard-set
mutation (:meth:`add_replica`, :meth:`drop_replica`, :meth:`split_tail`)
runs on the pump thread, between launches, and queued chunks of a split
tail are re-routed with their tickets intact. ``sharded=True`` over an
int32 plan keeps one pump and routes the host code slices by IMCU.

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

Device loss (sharded services): a launch or retire that raises
:class:`DeviceDown` declares the stream's device dead (:class:`DeviceHealth`,
keyed by the canonical device). Any other error, however often it
repeats, stays on the retry, failover and :class:`ServeError` path: a
kernel that fails to launch is never answered from the host instead (the
reference also counts ``device_fails`` breaker trips as a loss; the port
does not). A dead device's streams are evicted
(:meth:`ShardedFeatureExecutor.evict_device`: replicas dropped, an
orphaned primary replaced by a surviving replica), and a shard left with
no live stream is served from its host words (:meth:`FeaturePlan.
host_features`, bit for bit the kernel's answer) until the pump rebuilds
its stream on a surviving device (``stats['recoveries']``), so
availability holds even with every device dead.

Hedged launches: a retire wait that outlives ``max(hedge_min_s,
hedge_factor x the shard's EWMA round trip)`` (detector warmed up, the
shard on more than one stream) dispatches ONE duplicate of the launch
group on another healthy stream of the shard, with its own output,
pinned host buffer and event; the first copy whose event completes
resolves the tickets, the other is dropped unread (the pinned allocator
holds its buffer until its copy is done), and a win by the duplicate
strikes the primary's breaker. Stats ``hedges`` and ``hedge_wins``.

Tiered residency (``hbm_budget_bytes``): every shard is **hot** (words
on the device), **warm** (host packed words only) or **cold** (RLE runs
of its codes, :meth:`_PackedShardPlan.demote_cold`). Construction commits
shards in order while the per-device budget lasts; the rest start warm. A
request for an off-device shard is a tier miss: it is served at once from
the host (over a small thread pool, ``host_gather_workers``) and marks
the shard for promotion, which the pump runs on a free beat, displacing
strictly colder resident shards when the device is full. The monitor
settles every device under the budget, ages a warm shard quiet for
``cold_after`` ticks to cold, and promotes the hottest off-device shard.
:attr:`tiers`, :meth:`device_bytes`, :meth:`demote` and :meth:`promote`
expose it; every mutation runs on the pump. Pushdown over a warm shard
puts its words again (the version-keyed sync), and the next monitor tick
settles the budget.

``pause``/``resume`` hold launches (queueing continues) so callers can
force maximal coalescing; ``shutdown`` (also via the context-manager
protocol) drains the queue and joins the pump thread.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pipeline import (FeatureExecutor, FeaturePipeline,
                                       FeaturePlan, ShardedFeatureExecutor,
                                       pad_rows_edge, to_device)
from repro_torch.serve.classes import LatencyHistogram, RequestClass
from repro_torch.serve.faults import (DeadlineExceeded, DeviceDown,
                                      DeviceHealth, FaultInjector,
                                      FaultPolicy, ServeError, StreamBreaker)
from repro_torch.train.fault import StragglerDetector

DEFAULT_BUCKETS = (64, 256, 1024)


@dataclass(eq=False)
class _Chunk:
    """One bucket-shaped slice of a request, queued for its shard."""
    ticket: int
    rows: np.ndarray        # raw (unpadded) SHARD-LOCAL row indices
    n: int                  # valid rows (== rows.shape[0])
    bucket: int             # static launch shape this chunk pads to
    shard: int              # owning shard (0 for unsharded services)
    # destination of these rows in the request output: an int start for a
    # contiguous run, or an explicit position vector for routed splits
    dest: int | np.ndarray = 0
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
    device compute — 0.0 means none). ``hedge`` is the flight of a
    duplicate of the group launched on another stream: its own pinned
    buffer and event, the same layout as ``parts``; whichever copy is
    ready first retires the tickets."""
    host: torch.Tensor              # pinned copy of the launch buffer
    event: torch.cuda.Event | None  # recorded after the copy (None on CPU)
    parts: list                     # (ticket, n, dest, row_off) per chunk
    group: list                     # the _Chunks this launch covers
    ex: FeatureExecutor             # the stream that launched it
    t0: float                       # dispatch time (perf_counter)
    ready_at: float = 0.0           # injected-stall retire gate
    shard: int = 0                  # the shard whose group this is
    hedge: _Flight | None = None    # the duplicate launch, if any
    hedge_done: bool = False        # hedge attempted (or impossible)


class FeatureService:
    """Request-queue-driven feature serving over a compiled FeaturePlan."""

    def __init__(self, plan: FeaturePlan | FeaturePipeline, *,
                 prefetch: int = 2,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 sharded: bool = False, coalesce: int = 4,
                 linger_us: float = 0.0, devices=None,
                 rebalance_every: int = 0, row_budget: int | None = None,
                 hot_factor: float = 4.0, max_replicas: int | None = None,
                 hbm_budget_bytes: int | None = None, cold_after: int = 2,
                 host_gather_workers: int | None = None,
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
        if rebalance_every < 0:
            raise ValueError("rebalance_every must be >= 0")
        if row_budget is not None and row_budget < 32:
            raise ValueError("row_budget must be >= 32 (one alignment word)")
        if hot_factor < 1.0:
            raise ValueError("hot_factor must be >= 1 (hot means above mean)")
        if (rebalance_every or row_budget) and not (sharded and plan.packed):
            raise ValueError("adaptive shard management (rebalance_every / "
                             "row_budget) needs sharded=True over a packed "
                             "plan")
        if hbm_budget_bytes is not None and not (sharded and plan.packed):
            raise ValueError("tiered residency (hbm_budget_bytes) needs "
                             "sharded=True over a packed plan")
        if cold_after < 1:
            raise ValueError("cold_after must be >= 1 monitor tick")
        if host_gather_workers is None:
            # the fan-out only cuts a miss window with spare cores to land
            # on; a 1-core host stays sequential
            host_gather_workers = min(4, os.cpu_count() or 1)
        if host_gather_workers < 1:
            raise ValueError("host_gather_workers must be >= 1")
        if coalesce < 1:
            raise ValueError("coalesce must be >= 1")
        self.plan = plan
        self.packed = plan.packed
        self.prefetch = prefetch
        self.sharded = sharded
        if sharded and self.packed:
            # one resident word-stream shard per IMCU, each with its own
            # executor (and CUDA stream), queue and in-flight windows, all
            # fed by the one pump
            self._sharded_ex = ShardedFeatureExecutor(
                plan, prefetch=prefetch, devices=devices,
                hbm_budget_bytes=hbm_budget_bytes)
            self._executor = self._sharded_ex.executors[0]
            self._n_shards = self._sharded_ex.n_shards
        else:
            # ONE executor; int32 sharding only changes where the host code
            # slices come from
            self._sharded_ex = None
            self._executor = FeatureExecutor(plan, prefetch=prefetch)
            self._n_shards = 1
        if sharded and not self.packed:
            self._shard_bounds = plan.imcu_bounds()
            self._shards = plan.imcu_shards()
            self._starts = np.array([b[0] for b in self._shard_bounds])
        self.buckets = tuple(sorted(buckets))
        if self.packed:
            # word-aligned buckets keep the range iterator's discipline and
            # one launch shape per bucket
            self.buckets = tuple(sorted(
                {-(-b // 32) * 32 for b in self.buckets}))
        self.coalesce = coalesce if self.packed else 1
        self._linger_s = linger_us * 1e-6
        # -- pump-shared state: everything below is guarded by _lock --
        # one queue and one in-flight window PER SHARD; a window entry is
        # (global launch sequence number, _Flight)
        self._queues: list[deque[_Chunk]] = [deque()
                                             for _ in range(self._n_shards)]
        self._inflights: list[deque] = [deque()
                                        for _ in range(self._n_shards)]
        self._busy = [0] * self._n_shards   # launches/retires mid-flight
        self._seq = 0                       # global launch order for retires
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
        # breakers key on the executor's stream token, never id(): a
        # dropped replica's id() can be recycled for a fresh executor
        self._breakers: dict[int, StreamBreaker] = {}
        self._stream_rr = [0] * self._n_shards     # healthy-stream cursor
        self._stragglers = [self._new_straggler()
                            for _ in range(self._n_shards)]
        # -- device-loss recovery state --
        self._device_health = DeviceHealth()
        self._needs_rebuild: set[int] = set()   # shards with no live stream
        # -- pump supervisor state (journal: what the pump held when it
        #    died, so a restart re-enqueues instead of losing tickets) --
        self._pump_restarts_used = 0
        self._pump_taken: tuple | None = None      # (shard, group) pre-launch
        self._pump_retiring: tuple | None = None   # (shard, _Flight)
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
        # -- adaptive shard management state --
        self.rebalance_every = rebalance_every
        self.row_budget = row_budget
        self.hot_factor = hot_factor
        self.max_replicas = max_replicas
        self._mon_alpha = 0.5           # EWMA weight per monitor tick
        self._mon_ewma = [0.0] * self._n_shards
        self._mon_last = [0] * self._n_shards
        self._mon_mark = 0              # launches at the last monitor tick
        self._route_gen = 0             # bumped on every routing-table swap
        self._admin_q: deque = deque()  # (fn, event, result_box) for the pump
        # -- tiered residency state: construction committed the shards
        #    that fit the budget; the rest start WARM --
        self.cold_after = cold_after
        self._tier = (["hot" if ex.resident_bytes() > 0 else "warm"
                       for ex in self._sharded_ex.executors]
                      if self._sharded_ex is not None
                      else ["hot"] * self._n_shards)
        self._offdevice = {s for s, t in enumerate(self._tier) if t != "hot"}
        self._promote_pending: set[int] = set()   # tier misses awaiting a beat
        self._warm_ticks = [0] * self._n_shards   # quiet ticks while warm
        self._host_served = [0] * self._n_shards  # host-served chunks (EWMA)
        self._host_workers = host_gather_workers
        self._host_pool: ThreadPoolExecutor | None = None   # lazy fan-out
        self.stats = {"requests": 0, "rows": 0, "padded_rows": 0,
                      "batches": 0, "launches": 0, "max_inflight": 0,
                      "latency_s_total": 0.0, "completed": 0,
                      "latency_samples_total": 0,
                      "packed_ranges": 0, "bytes_h2d": 0,
                      "split_requests": 0, "filtered_requests": 0,
                      "retries": 0, "failovers": 0, "timeouts": 0,
                      "failed_tickets": 0, "unhealthy_shards": 0,
                      "stragglers": 0,
                      "recoveries": 0, "pump_restarts": 0,
                      "hedges": 0, "hedge_wins": 0,
                      "devices_lost": 0, "host_gathers": 0,
                      "rebalances": 0, "replicas_added": 0,
                      "replicas_dropped": 0, "shard_splits": 0,
                      "promotions": 0, "demotions": 0, "rehydrations": 0,
                      "tier_misses": 0,
                      "tier_hot": self._tier.count("hot"),
                      "tier_warm": self._tier.count("warm"),
                      "tier_cold": 0,
                      "shard_launches": [0] * self._n_shards,
                      "shard_batches": [0] * self._n_shards,
                      "shard_bytes_h2d": [0] * self._n_shards}
        # conditions over ONE lock, so each event wakes only the threads
        # that care:
        #   _work — the pump sleeps here; submits that queued work (and
        #           pause/shutdown/drain-flush/admin) notify
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

    @property
    def n_shards(self) -> int:
        """Shards this service launches through (1 unsharded)."""
        return self._n_shards

    @property
    def replicas(self) -> list[int]:
        """Replica count per shard (all zeros unsharded)."""
        if self._sharded_ex is None:
            return [0] * self._n_shards
        return [len(r) for r in self._sharded_ex.replicas]

    @property
    def monitor_ewma(self) -> list[float]:
        """Per-shard request-rate EWMA — the load monitor's current view."""
        return list(self._mon_ewma)

    @property
    def shard_starts(self) -> list[int]:
        """Routing-table row starts per shard (grows on tail splits)."""
        if self._sharded_ex is None:
            return [0]
        return list(self._sharded_ex._routing[1])

    def shutdown(self, drain: bool = True) -> None:
        """Stop the pump thread and join it.

        ``drain=True`` (default) serves everything already queued first (an
        orderly drain — results stay retrievable via :meth:`result` /
        :meth:`drain`); ``drain=False`` discards queued-but-unlaunched
        chunks, forgetting their tickets. Idempotent.
        """
        with self._lock:
            if not drain:
                dropped = set()
                for q in self._queues:
                    dropped.update(ch.ticket for ch in q)
                    q.clear()
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
        if self._host_pool is not None:
            self._host_pool.shutdown(wait=True)   # idempotent

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

    # -- fault tolerance: breakers, stream health, failure handling -----------------
    def _new_straggler(self) -> StragglerDetector:
        p = self._policy
        return StragglerDetector(threshold=p.straggler_threshold,
                                 warmup=p.straggler_warmup)

    def _breaker(self, ex: FeatureExecutor) -> StreamBreaker:
        b = self._breakers.get(ex.stream_token)
        if b is None:
            b = self._breakers[ex.stream_token] = StreamBreaker()
        return b

    def _close_breaker_locked(self, ex: FeatureExecutor, now: float) -> None:
        """A round trip proved the stream healthy: close its breaker, and
        when it was TRIPPED, give back its ``unhealthy_shards`` mark (a
        gauge of currently-unhealthy streams). A success while the breaker
        is still OPEN does not close it: the forced launches through an
        open breaker are not probes — the breaker holds until the cooldown
        makes the stream half-open and a success there is the probe."""
        b = self._breakers.get(ex.stream_token)
        if b is None or b.is_open(self._policy.breaker_fails, now):
            return
        if b.fails >= self._policy.breaker_fails:
            self.stats["unhealthy_shards"] -= 1
        b.reset()

    def _discard_breaker_locked(self, ex: FeatureExecutor) -> None:
        """The stream leaves the shard set (a dropped replica, an evicted
        or rebuilt stream): forget its breaker, and give back its gauge
        mark when it left unhealthy."""
        b = self._breakers.pop(ex.stream_token, None)
        if b is not None and b.fails >= self._policy.breaker_fails:
            self.stats["unhealthy_shards"] -= 1

    def _shard_streams(self, s: int) -> list[FeatureExecutor]:
        return (self._sharded_ex.stream_executors(s)
                if self._sharded_ex is not None else [self._executor])

    def _healthy_streams(self, s: int, now: float) -> list[FeatureExecutor]:
        thr = self._policy.breaker_fails
        return [ex for ex in self._shard_streams(s)
                if not self._breaker(ex).is_open(thr, now)
                and not self._device_health.is_down(ex.device)]

    @property
    def unhealthy(self) -> list[int]:
        """Shards with at least one OPEN-breaker launch stream right now —
        what the monitor's failover policy re-replicates around."""
        with self._lock:
            now = time.perf_counter()
            return [s for s in range(self._n_shards)
                    if len(self._healthy_streams(s, now))
                    < len(self._shard_streams(s))]

    def _pick_stream(self, s: int, avoid: frozenset):
        """Healthy-stream selection with read fan-out (pump thread, lock
        held): round-robin over the shard's closed-breaker streams; a
        stream past its cooldown is half-open and its next pick is the
        probe. ``avoid`` (stream tokens a retrying group failed on) is
        left out unless nothing else is left, so a retry prefers a copy it
        has NOT watched fail. Returns (executor, stream index)."""
        streams = self._shard_streams(s)
        if len(streams) == 1 and not avoid:
            return streams[0], 0
        now = time.perf_counter()
        thr = self._policy.breaker_fails
        idx = list(range(len(streams)))
        dh = self._device_health
        healthy = [i for i in idx
                   if not self._breaker(streams[i]).is_open(thr, now)
                   and not dh.is_down(streams[i].device)]
        pool = ([i for i in healthy
                 if streams[i].stream_token not in avoid]
                or healthy
                or [i for i in idx if streams[i].stream_token not in avoid]
                or idx)
        self._stream_rr[s] += 1
        i = pool[self._stream_rr[s] % len(pool)]
        return streams[i], i

    def _strike_locked(self, ex: FeatureExecutor, now: float) -> bool:
        """One failure (or straggler flag) on a stream; True when this
        strike TRIPPED its breaker."""
        p = self._policy
        if self._breaker(ex).strike(p.breaker_fails, p.breaker_cooldown_s,
                                    now):
            self.stats["unhealthy_shards"] += 1
            return True
        return False

    def _observe_latency_locked(self, s: int, ex: FeatureExecutor,
                                dt: float, now: float) -> None:
        """Feed shard ``s``'s straggler detector one launch round-trip
        time; a flagged launch that also clears the absolute floor
        (``straggler_min_s``) strikes the stream's breaker, otherwise the
        round trip closes it."""
        flagged = self._stragglers[s].observe(
            self.stats["shard_launches"][s], dt)
        if flagged and dt >= self._policy.straggler_min_s:
            self.stats["stragglers"] += 1
            self._strike_locked(ex, now)
        else:
            self._close_breaker_locked(ex, now)

    def _fail_ticket_locked(self, ticket: int, err: ServeError, *,
                            timeout: bool = False) -> None:
        """Resolve ``ticket`` to a typed error (lock held): the ledger
        entries go, the error is retrievable via poll/result/collect, and
        chunks of this ticket still queued anywhere are dropped on sight
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

    def _handle_launch_failure(self, s: int, group: list[_Chunk],
                               ex: FeatureExecutor, err: Exception) -> None:
        """A launch or retire raised (lock held, pump thread): only this
        group's chunks are touched. Strike the stream's breaker, then
        re-enqueue the group at the head of its shard's queue — at once
        when another healthy stream of the shard can take the retry
        (replica failover), else after capped exponential backoff; the
        retry re-launches the same kernel. Chunks out of retries resolve
        their tickets to a :class:`ServeError` chained to ``err``.

        Device attribution (sharded services): only a :class:`DeviceDown`
        declares the stream's device dead; any other error stays on this
        path however often it repeats, so a failing kernel ends in
        retries and ServeErrors, never in host serving. A device newly
        dead is recovered (its streams evicted, orphaned shards marked for
        rebuild) before the group is queued again, so the retry sees the
        stream set after the eviction."""
        now = time.perf_counter()
        self._strike_locked(ex, now)
        if self._sharded_ex is not None and isinstance(err, DeviceDown) \
                and self._device_health.mark_down(ex.device):
            self._recover_device_locked(ex.device)
        retry, failed = [], []
        for ch in group:
            (retry if ch.attempts + 1 <= self._policy.max_retries
             and ch.ticket not in self._dead else failed).append(ch)
        for ch in failed:
            e = ServeError(
                f"request failed after {ch.attempts + 1} launch attempts "
                f"on shard {s}: {err!r}", ticket=ch.ticket, shard=s,
                attempts=ch.attempts + 1)
            e.__cause__ = err
            self._fail_ticket_locked(ch.ticket, e)
        if not retry:
            return
        failed_tok = ex.stream_token
        alt = any(e.stream_token != failed_tok
                  for e in self._healthy_streams(s, now))
        for ch in reversed(retry):
            ch.attempts += 1
            ch.avoid = ch.avoid | {failed_tok}
            ch.not_before = now if alt \
                else now + self._policy.backoff_for(ch.attempts)
            self._queues[s].appendleft(ch)
        self.stats["retries"] += 1
        self._work.notify_all()

    # -- device-loss recovery (evict -> host-serve -> rebuild) -----------------------
    def _recover_device_locked(self, device) -> None:
        """A device was declared dead (lock held, pump thread): evict its
        streams, and mark the shards left with NO live stream for rebuild;
        until then their queued work is served from host words (the
        ``hostserve`` arm of :meth:`_pick_action`). A shard the tier ladder
        had already demoted was host-served before and needs no rebuild:
        its promotion rebuilds on a survivor if its load comes back."""
        self.stats["devices_lost"] += 1
        removed, orphans = self._sharded_ex.evict_device(device)
        for _s, rex in removed:
            self._discard_breaker_locked(rex)
        self._needs_rebuild.update(s for s in orphans
                                   if s not in self._offdevice)
        self._work.notify_all()

    def _rebuild_shard_locked(self, s: int) -> bool:
        """Commit an orphaned shard's stream again on a surviving device
        (lock held, pump thread): True once it is committed and the shard
        launches again, False (still host-served) when no device
        survives."""
        sx = self._sharded_ex
        old = sx.executors[s]
        try:
            sx.rebuild_on(s, lost=set(self._device_health.down))
        except ValueError:
            return False                 # nothing healthy to rebuild on
        self._discard_breaker_locked(old)
        self._needs_rebuild.discard(s)
        self.stats["recoveries"] += 1
        self._work.notify_all()
        return True

    def _host_features_group(self, s: int, group: list) -> list[np.ndarray]:
        """A host-served group's features (pump thread, NO lock held): one
        :meth:`FeaturePlan.host_features` per chunk — the same codes and
        the same clamp as the kernel, so bit for bit its answer — over a
        small lazy thread pool when the group has several chunks. Safe
        concurrently: the word and run reads are pure, and tier changes
        run only on the pump thread, which waits here."""
        plan = (self._sharded_ex.shards[s]
                if self._sharded_ex is not None else self.plan)
        if len(group) == 1 or self._host_workers == 1:
            return [plan.host_features(ch.rows) for ch in group]
        if self._host_pool is None:
            self._host_pool = ThreadPoolExecutor(
                max_workers=self._host_workers,
                thread_name_prefix="feature-service-hostgather")
        return list(self._host_pool.map(
            lambda ch: plan.host_features(ch.rows), group))

    def _host_serve(self, s: int, group: list) -> None:
        """Serve one taken group from the host end to end (pump thread,
        lock NOT held on entry): a shard with no live stream (device loss)
        or an off-device tier. Counts ``host_gathers`` only, and
        ``tier_misses`` when the shard is off-device by tier — a miss also
        marks the shard for promotion on a free beat. A chunk leaves the
        ``_pump_taken`` journal once it is retired, so a pump restart
        serves exactly the rest again."""
        feats_list = self._host_features_group(s, group)
        with self._lock:
            self.stats["host_gathers"] += 1
            self._host_served[s] += len(group)
            miss = s in self._offdevice and s not in self._needs_rebuild
            if miss:
                self.stats["tier_misses"] += 1
                self._warm_ticks[s] = 0
                self._promote_pending.add(s)
            landed = False
            for feats in feats_list:
                ch = group[0]
                self._retire_prog = 0
                if self._retire(feats, [(ch.ticket, ch.n, ch.dest, 0)]):
                    landed = True
                del group[0]
            if landed:
                self._cv.notify_all()
            self._pump_taken = None
            self._busy[s] -= 1
            self._maybe_rebalance_locked()
            if miss:
                self._work.notify_all()   # the promote arm has work now
            if self._all_idle():
                self._idle.notify_all()

    # -- requests -------------------------------------------------------------------
    def _route(self, rows: np.ndarray, lo: int, hi: int):
        """(shard, local_rows, dest) pieces of a request's rows: the whole
        request in shard 0 on a one-shard service (dest None = in order),
        else bucketed by owning IMCU — the clustered fast path (all rows in
        one shard, the per-user block lookup) builds no index."""
        if self._n_shards == 1:
            return [(0, rows, None)]
        return self._sharded_ex.route(rows, lo, hi)

    def submit(self, rows: np.ndarray | None = None, *, where=None,
               deadline_ms: float | None = None,
               klass: str = "default") -> int:
        """Enqueue a featurization request; returns a ticket for the result.

        Only queues: the rows are routed to the shards that own them (one
        shard unsharded), and the pump picks the chunks up, coalesces them
        with other queued work of the same shard and launches — the caller
        goes on submitting while the device gathers. ``deadline_ms`` bounds the request's time in the
        queue: chunks still QUEUED once it expires are dropped before launch
        and the ticket resolves to :class:`DeadlineExceeded` (chunks already
        in flight retire normally).

        ``where=<predicate>`` (instead of ``rows``) is the pushdown form:
        the matching rows are found by the scan kernel over the resident
        words (:meth:`FeatureExecutor.filtered_rows`, a scan per shard on a
        sharded service) and then pumped
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
            rows = self._pushdown(lambda ex: ex.filtered_rows(where))
            if rows.size == 0:
                return self._resolved_empty_ticket(klass)
        elif rows is None:
            raise ValueError("need rows or where")
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if rows.size == 0:
            raise ValueError("empty request")
        lo, hi = int(rows.min()), int(rows.max())
        if lo < 0 or hi >= self.plan.n_rows:
            raise IndexError(f"row indices out of range [0, {self.plan.n_rows})")
        # routing, chunking and the alignment scan are pure functions of
        # the request, done OUTSIDE the lock; a pump-side split may swap
        # the routing table meanwhile, and the generation check below
        # catches that and routes again (a chunk built against stale bounds
        # would land on a shard that no longer owns its rows)
        cap = self.buckets[-1]
        while True:
            gen = self._route_gen
            pieces, padded, aligned = [], 0, 0
            routed = self._route(rows, lo, hi)
            for shard, local, dest in routed:
                for start in range(0, local.shape[0], cap):
                    chunk = local[start:start + cap]
                    bucket = self._bucket(chunk.shape[0])
                    padded += bucket - chunk.shape[0]
                    if self.packed and self._aligned_range(chunk):
                        aligned += 1
                    d = start if dest is None else dest[start:start + cap]
                    pieces.append(_Chunk(0, chunk, chunk.shape[0], bucket,
                                         shard, d))
            with self._lock:
                self._check_pump()
                if self._shutdown:
                    raise RuntimeError("service is shut down")
                if self._route_gen != gen:
                    continue            # routing swapped mid-build: redo
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
                self.stats["packed_ranges"] += aligned
                if len(routed) > 1:
                    self.stats["split_requests"] += 1
                self._chunks_total[ticket] = len(pieces)
                self._ticket_rows[ticket] = rows.size
                self._ticket_class[ticket] = klass
                cs = self._class_stats[klass]
                cs["requests"] += 1
                cs["rows"] += rows.size
                before = {}
                for ch in pieces:
                    ch.ticket = ticket
                    ch.t_enq = now
                    ch.klass = klass
                    q = self._queues[ch.shard]
                    before.setdefault(ch.shard, len(q))
                    q.append(ch)
                for s, n0 in before.items():
                    # wake the parked pump when a shard queue went empty ->
                    # nonempty, when this submit completed a coalescing
                    # group, or when it OUTRANKS the queue's head (a
                    # lingering low-priority group must not make a fresh
                    # high-priority chunk wait out its hold); chunks
                    # landing mid-group ride the pending tick
                    q = self._queues[s]
                    preempt = n0 > 0 and rc.priority > \
                        self._classes[q[0].klass].priority
                    if n0 == 0 or preempt or n0 < self.coalesce <= len(q):
                        self._work.notify_all()
                        break
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

    def _slice_padded(self, rows: np.ndarray, bucket: int) -> np.ndarray:
        """Host work for one int32 chunk: fancy-index + right-pad to bucket."""
        rows = pad_rows_edge(rows, bucket)
        if self.sharded and not self.packed:
            return self._gather_sharded_codes(rows)
        return self.plan.host_codes(rows)

    def _gather_sharded_codes(self, rows: np.ndarray) -> np.ndarray:
        """int32 sharding: route rows to their IMCU partitions and gather
        partition-local code slices — only the HOST side is partitioned,
        one pump serves every launch. Rows appended after the plan was
        compiled lie past the last IMCU bound and come from the plan's own
        code matrix tail."""
        out = np.empty((len(self.plan.plans), rows.shape[0]), np.int32)
        tail_start = self._shard_bounds[-1][1]
        tail = rows >= tail_start
        if tail.any():
            out[:, tail] = self.plan.codes_matrix[:, rows[tail]]
        rows_in, (idx_in,) = rows[~tail], np.nonzero(~tail)
        shard_of = np.searchsorted(self._starts, rows_in, side="right") - 1
        for s in np.unique(shard_of):
            mask = shard_of == s
            local = rows_in[mask] - self._shard_bounds[s][0]
            out[:, idx_in[mask]] = self._shards[s].codes_matrix[:, local]
        return out

    @staticmethod
    def _aligned_range(rows: np.ndarray) -> bool:
        """True for a word-aligned contiguous run (the scan pattern),
        counted in ``stats['packed_ranges']``; it is served by the same
        rows launch as any row set. The O(1) checks gate the O(n) one:
        this runs on every submit."""
        if rows.shape[0] == 0 or int(rows[0]) % 32 or \
                int(rows[-1]) - int(rows[0]) != rows.shape[0] - 1:
            return False
        return bool((np.diff(rows) == 1).all())

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
        return not any(q or i or b for q, i, b in
                       zip(self._queues, self._inflights, self._busy))

    def _streams(self, s: int) -> int:
        """Launch streams serving shard s (1 + replicas). Each stream gets
        its own ``prefetch``-deep in-flight window, so a hot shard's window
        grows with its replicas."""
        return self._sharded_ex.n_streams(s) if self._sharded_ex else 1

    def _pick_action(self):
        """The pump's next action (lock held): ``("hostserve", shard)``
        for queued work of a shard with no live stream or off the device
        (served from host words); ``("launch", shard)`` for the first shard
        whose window has room and whose selected class's group is ready;
        else ``("retire", shard)`` for the OLDEST launch in flight, from a
        shard whose full window dams its queue first; then, on a free
        beat, ``("rebuild", shard)`` (only while a device survives, so a
        wholly dead pool settles into host serving) and ``("promote",
        shard)`` (the hottest pending tier miss); ``("wait", timeout)`` or
        ``("exit", None)``. A lingering partial group or a queue whose
        every class is in retry backoff launches nothing, but its deadline
        bounds the wait."""
        held = self._paused and not self._shutdown
        linger_min = None
        now = time.perf_counter()
        for s in range(self._n_shards):
            queue = self._queues[s]
            if not queue or held:
                continue
            if s in self._needs_rebuild or s in self._offdevice:
                return "hostserve", s
            if len(self._inflights[s]) >= self.prefetch * self._streams(s):
                continue
            klass, head, hold = self._select_class(queue, now)
            if klass is None:
                linger_min = hold if linger_min is None \
                    else min(linger_min, hold)
                continue
            rc = self._classes[klass]
            if self._linger_for(rc) > 0 and self._coalesce_for(rc) > 1 \
                    and not self._shutdown and not self._flushes:
                left = self._linger_left(queue, klass, head, now)
                if left > 0:
                    linger_min = left if linger_min is None \
                        else min(linger_min, left)
                    continue
            return "launch", s
        oldest, oldest_full = None, None
        for s in range(self._n_shards):
            infl = self._inflights[s]
            if not infl:
                continue
            seq = infl[0][0]
            if oldest is None or seq < self._inflights[oldest][0][0]:
                oldest = s
            if len(infl) >= self.prefetch * self._streams(s) and (
                    oldest_full is None
                    or seq < self._inflights[oldest_full][0][0]):
                oldest_full = s
        if oldest_full is not None:
            return "retire", oldest_full
        if oldest is not None and linger_min is None:
            return "retire", oldest
        if self._needs_rebuild and not self._shutdown and \
                self._device_health.survivors(self._sharded_ex.device_pool):
            return "rebuild", min(self._needs_rebuild)
        if self._promote_pending and not held and not self._shutdown:
            # a promotion never blocks a request: misses keep being served
            # from the host while the put runs
            return "promote", max(self._promote_pending,
                                  key=lambda i: self._mon_ewma[i])
        if self._shutdown and self._all_idle() and not self._admin_q:
            return "exit", None
        return "wait", linger_min

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
                        self._fail_admin(e)
                        self._notify_everyone()
                        return
                    self._pump_restarts_used += 1
                    self.stats["pump_restarts"] += 1
                    self._recover_pump_locked()

    def _recover_pump_locked(self) -> None:
        """Restore the ledger's invariants after a pump crash (lock held):
        clear the busy markers, and put back at the head of its shard's
        queue, in order, a group the dying pump had taken but not recorded
        in flight, and the not-yet-distributed chunks of a retire it was
        part way through (``_retire_prog`` marks where it stopped)."""
        self._busy = [0] * self._n_shards
        if self._pump_taken is not None:
            s, group = self._pump_taken
            for ch in reversed(group):
                self._queues[s].appendleft(ch)
            self._pump_taken = None
        if self._pump_retiring is not None:
            s, fl = self._pump_retiring
            for ch in reversed(fl.group[self._retire_prog:]):
                if ch.ticket in self._chunks_total:
                    self._queues[s].appendleft(ch)
            self._pump_retiring = None
        self._work.notify_all()

    def _pump_loop(self) -> None:
        """ONE pump multiplexes every shard: coalesce -> launch -> retire
        until shutdown, with a ``prefetch``-deep in-flight window per
        launch stream. The only thread that launches kernels or waits on
        their results; launches are asynchronous, each on its stream's own
        CUDA stream, so the shards' gathers overlap on the device while the
        pump prepares the next group.

        Shard-set mutations (the admin queue, rebuilds, promotions) run on
        this thread, when no launch or retire is mid-flight, so a split, a
        replica swap or a tier flip never races a dispatch or a host
        gather. Fault isolation: dispatching a launch and waiting on its
        result are guarded per launch group — an exception there goes to
        :meth:`_handle_launch_failure` (retry, failover or backoff, else a
        per-ticket ServeError) and the loop goes on; an exception in the
        loop's own logic lands in the supervisor (:meth:`_pump_main`).
        """
        while True:
            with self._lock:
                while True:
                    self._drain_admin()
                    action, arg = self._pick_action()
                    if action != "wait":
                        break
                    if self._all_idle():
                        self._idle.notify_all()
                    self._work.wait(timeout=arg)
                if action == "exit":
                    return
                s = arg
                if action == "rebuild":
                    self._rebuild_shard_locked(s)
                    continue
                if action == "promote":
                    # pending clears whatever the outcome: a promotion that
                    # cannot fit leaves the shard off the device until the
                    # next miss marks it again (no spinning on a full card)
                    self._try_promote_locked(s)
                    self._promote_pending.discard(s)
                    if self._all_idle():
                        self._idle.notify_all()
                    continue
                if action in ("launch", "hostserve"):
                    if action == "hostserve":
                        # retry backoffs are void: the host path cannot
                        # fail the way the launch did
                        for ch in self._queues[s]:
                            ch.not_before = 0.0
                    group = self._take_group(self._queues[s],
                                             time.perf_counter())
                    if not group:
                        # the whole head group was evicted (failed or
                        # deadline-expired tickets) — nothing to launch
                        if self._all_idle():
                            self._idle.notify_all()
                        continue
                    self._pump_taken = (s, group)
                if action == "launch":
                    ex, stream = self._pick_stream(s, group[0].avoid)
                    if group[0].avoid and \
                            ex.stream_token not in group[0].avoid:
                        # a retry reached a stream it had not failed on
                        self.stats["failovers"] += 1
                elif action == "retire":
                    _, fl = self._inflights[s].popleft()
                    group, ex = fl.group, fl.ex
                    self._pump_retiring = (s, fl)
                    self._retire_prog = 0
                self._busy[s] += 1
            if action == "hostserve":
                # gathered and retired outside the lock; journaled in
                # _pump_taken like a launch
                self._host_serve(s, group)
                continue
            try:
                if action == "launch":
                    fl, nbytes = self._launch(group, s, ex, stream)
                else:
                    arr, win_ex, dt, by_hedge = self._await_flight(fl)
            except Exception as e:
                with self._lock:
                    self._handle_launch_failure(s, group, ex, e)
                    self._pump_taken = self._pump_retiring = None
                    self._busy[s] -= 1
                    if self._all_idle():
                        self._idle.notify_all()
                continue
            with self._lock:
                if action == "launch":
                    self._seq += 1
                    self._inflights[s].append((self._seq, fl))
                    self._pump_taken = None
                    self.stats["launches"] += 1
                    self.stats["batches"] += len(fl.parts)
                    self.stats["bytes_h2d"] += nbytes
                    self.stats["shard_launches"][s] += 1
                    self.stats["shard_batches"][s] += len(fl.parts)
                    self.stats["shard_bytes_h2d"][s] += nbytes
                    self.stats["max_inflight"] = max(
                        self.stats["max_inflight"],
                        sum(len(i) for i in self._inflights))
                    self._busy[s] -= 1
                    self._maybe_rebalance_locked()
                else:
                    now = time.perf_counter()
                    self._observe_latency_locked(s, win_ex, dt, now)
                    if by_hedge:
                        # the primary lost the race to its own duplicate:
                        # that IS a straggler strike
                        self.stats["hedge_wins"] += 1
                        self._strike_locked(fl.ex, now)
                    if self._retire(arr, fl.parts):
                        self._cv.notify_all()
                    self._pump_retiring = None
                    self._busy[s] -= 1
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
                    ticket=ch.ticket, shard=ch.shard), timeout=True)
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

    def _launch(self, group: list[_Chunk], s: int, ex: FeatureExecutor,
                stream: int) -> tuple[_Flight, int]:
        """Dispatch ONE launch for a coalesced group on ``ex``, the shard-
        ``s`` stream :meth:`_pick_stream` chose (pump thread only); returns
        the flight and the host->device bytes it shipped.

        The chaos hook fires first, before any dispatch, so an injected
        fault or delay lands where a real device error would; its return
        value is the launch's injected stall, which gates the flight's
        retire (``ready_at``).

        Packed plans: a flat (coalesce * bucket,) int32 SHARD-LOCAL index
        vector — padded to the full coalesce width so every launch of a
        bucket has one shape — into the packed rows kernel; the indices are
        all that crosses to the device. int32 plans: the (C, bucket) code
        slice of a single chunk into the int32 kernel. Either way the
        launch buffer is a flat (rows, F) array and each part records its
        chunk's row offset into it. On a CUDA device everything — the index
        or code copy, the kernel, the copy into pinned host memory and the
        event behind it — runs on the executor's stream (the current
        stream for an executor without one).
        """
        t0 = time.perf_counter()
        stall = 0.0
        if self._faults is not None:
            stall = self._faults.before_launch(s, stream, device=ex.device,
                                               klass=group[0].klass)
        ready_at = t0 + stall if stall else 0.0
        bucket = group[0].bucket
        with (torch.cuda.stream(ex.stream) if ex.stream is not None
              else contextlib.nullcontext()):
            if self.packed:
                mat = np.empty((self.coalesce, bucket), np.int32)
                for i, ch in enumerate(group):
                    mat[i] = pad_rows_edge(ch.rows, bucket)
                mat[len(group):] = mat[len(group) - 1]   # surplus lanes unread
                dev = ex._rows_future(mat.reshape(-1))
                nbytes = mat.nbytes
            else:
                codes = self._slice_padded(group[0].rows, bucket)
                dev = ex.gather_device(to_device(codes, ex.device))
                nbytes = int(codes.nbytes)
            parts = [(ch.ticket, ch.n, ch.dest, i * bucket)
                     for i, ch in enumerate(group)]
            if dev.device.type != "cuda":
                return _Flight(dev, None, parts, group, ex, t0, ready_at,
                               s), nbytes
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev.device))
        return _Flight(host, event, parts, group, ex, t0, ready_at,
                       s), nbytes

    def _maybe_rebalance_locked(self) -> None:
        """A monitor tick every ``rebalance_every`` launches and host
        gathers (lock held, pump thread): a workload served all from the
        host must still tick, or nothing would ever promote."""
        if self.rebalance_every and (
                self.stats["launches"] + self.stats["host_gathers"]
                - self._mon_mark >= self.rebalance_every):
            self._rebalance_locked()

    # -- retire, hedged (speculative duplicate launches) ------------------------------
    @staticmethod
    def _buf_ready(fl: _Flight, now: float) -> bool:
        """A copy is ready once its injected stall has passed and its event
        has completed (no event: a CPU launch, ready at once)."""
        return now >= fl.ready_at and (fl.event is None or fl.event.query())

    def _await_flight(self, fl: _Flight):
        """Wait (outside the lock) until one copy of the flight is on the
        host; returns ``(features, winning executor, round-trip seconds,
        won_by_hedge)``. A fault in the launch surfaces here and goes to
        the retry path.

        With no injected stall and hedging not armed: a non-blocking
        ``Event.query()``, then a blocking wait on the event only if the
        copy is still running. Hedging arms when the policy allows it, the
        shard has more than one stream and its straggler detector is past
        warmup (an untrained EWMA would hedge the first launches); then,
        and under a stall, the events are polled 0.2 ms apart, and once
        the wait crosses :meth:`StragglerDetector.hedge_cutoff` ONE
        duplicate is launched (:meth:`_try_hedge`) and the two race."""
        s = fl.shard
        det = self._stragglers[s]
        p = self._policy
        can_hedge = (p.hedge and self._sharded_ex is not None
                     and det.n > det.warmup
                     and self._sharded_ex.n_streams(s) > 1)
        if not can_hedge and not fl.ready_at:
            if fl.event is not None and not fl.event.query():
                fl.event.synchronize()
            return fl.host.numpy(), fl.ex, time.perf_counter() - fl.t0, \
                False
        cutoff = det.hedge_cutoff(p.hedge_factor, p.hedge_min_s)
        while True:
            now = time.perf_counter()
            dup = fl.hedge
            if dup is not None and self._buf_ready(dup, now):
                return dup.host.numpy(), dup.ex, now - dup.t0, True
            if self._buf_ready(fl, now):
                return fl.host.numpy(), fl.ex, now - fl.t0, False
            if can_hedge and not fl.hedge_done and now - fl.t0 >= cutoff:
                self._try_hedge(fl)
            time.sleep(2e-4)

    def _try_hedge(self, fl: _Flight) -> None:
        """Launch ONE duplicate of the flight's group on another healthy
        stream of its shard (pump thread; the lock taken briefly to pick
        the stream). At most one attempt per flight; a duplicate that fails
        to launch strikes ITS stream's breaker and the wait goes on, so a
        hedge never makes an outcome worse. The duplicate has its own
        output, pinned buffer and event, and the layout of ``fl.parts``."""
        fl.hedge_done = True
        s = fl.shard
        avoid = frozenset({fl.ex.stream_token}) | fl.group[0].avoid
        with self._lock:
            now = time.perf_counter()
            if not any(e.stream_token not in avoid
                       for e in self._healthy_streams(s, now)):
                return                    # nowhere healthy to hedge to
            ex2, st2 = self._pick_stream(s, avoid)
            if ex2.stream_token == fl.ex.stream_token:
                return
        try:
            dup, _nbytes = self._launch(fl.group, s, ex2, st2)
        except Exception:
            with self._lock:
                self._strike_locked(ex2, time.perf_counter())
            return
        fl.hedge = dup
        with self._lock:
            self.stats["hedges"] += 1

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
                if isinstance(dest, np.ndarray):
                    buf[dest] = piece
                else:
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

    # -- adaptive shard management ---------------------------------------------------
    def _drain_admin(self) -> None:
        """Run queued shard-set mutations (lock held, pump thread only)."""
        while self._admin_q:
            fn, ev, box = self._admin_q.popleft()
            try:
                box.append(fn())
            except BaseException as e:
                box.append(e)
            ev.set()

    def _fail_admin(self, err: BaseException) -> None:
        """Unblock admin waiters when the pump dies (lock held)."""
        while self._admin_q:
            _, ev, box = self._admin_q.popleft()
            box.append(err)
            ev.set()

    def _run_admin(self, fn):
        """Run ``fn`` under the lock ON THE PUMP THREAD and return its
        result. The pump is the only thread that launches, so a shard-set
        mutation marshalled onto it can never race a launch; one asked for
        by the pump itself (the monitor) runs inline."""
        if threading.current_thread() is self._pump:
            return fn()
        ev = threading.Event()
        box: list = []
        with self._lock:
            self._check_pump()
            if self._shutdown:
                raise RuntimeError("service is shut down")
            self._admin_q.append((fn, ev, box))
            self._work.notify_all()
        while not ev.wait(timeout=0.5):
            with self._lock:
                self._check_pump()
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]

    def _require_mesh(self) -> None:
        if self._sharded_ex is None:
            raise RuntimeError("adaptive shard management needs a "
                               "sharded=True service over a packed plan")

    def _add_replica_locked(self, shard: int, device=None,
                            avoid: frozenset = frozenset()):
        """The one replica-add path (lock held, pump thread), shared by the
        public mutator and the monitor. ``avoid`` (devices) keeps failover
        from replicating onto a device whose stream breaker is open, and
        the budget from one without headroom; a dead device is always
        avoided."""
        avoid = frozenset(avoid) | frozenset(self._device_health.down)
        ex = self._sharded_ex.add_replica(shard, device, avoid=avoid)
        self.stats["replicas_added"] += 1
        self._work.notify_all()         # the shard's window just widened
        return ex.device

    def _drop_replica_locked(self, shard: int):
        ex = self._sharded_ex.drop_replica(shard)
        self._discard_breaker_locked(ex)
        self.stats["replicas_dropped"] += 1
        return ex.device

    def add_replica(self, shard: int, device=None):
        """Replicate ``shard``'s resident word stream to ``device`` (default:
        the least loaded pool device not already holding a copy) and fan
        reads out across the copies; returns the replica's device. A
        configured ``max_replicas`` bounds this call too."""
        self._require_mesh()

        def op():
            if self.max_replicas is not None and \
                    len(self._sharded_ex.replicas[shard]) >= self.max_replicas:
                raise ValueError(f"shard {shard} already has "
                                 f"max_replicas={self.max_replicas} replicas")
            return self._add_replica_locked(shard, device)
        return self._run_admin(op)

    def drop_replica(self, shard: int):
        """Retire one replica of ``shard`` (its launches in flight finish;
        routing changes at once). Returns the dropped replica's device."""
        self._require_mesh()
        return self._run_admin(lambda: self._drop_replica_locked(shard))

    def split_tail(self, cut: int | None = None, device=None) -> int:
        """Split the open tail shard at parent row ``cut`` (default: its
        word-aligned midpoint) and swap the routing table atomically:
        queued chunks of the old tail are re-routed (split in two where
        they straddle the cut) with their tickets, order and linger
        deadlines intact. Returns the new shard's index."""
        self._require_mesh()
        return self._run_admin(lambda: self._apply_split_locked(cut, device))

    def rebalance(self) -> dict:
        """Run the load monitor's policies NOW (on the pump thread) and
        return the actions taken: ``{'split': [(old, new, cut)],
        'replicated': [(shard, device)], 'dropped': [(shard, device)],
        'failover_replicated': [(shard, device)], 'rebuilt': [(shard,
        device)], 'demoted': [(shard, tier)], 'promoted': [shard]}``. A
        no-op on unsharded services."""
        return self._run_admin(self._rebalance_locked)

    def _unhealthy_devices(self, now: float) -> set:
        """Devices that are down or behind an OPEN stream breaker right now
        (lock held): placement to avoid when re-replicating for
        failover."""
        thr = self._policy.breaker_fails
        return set(self._device_health.down) | {
            ex.device for s in range(self._n_shards)
            for ex in self._shard_streams(s)
            if self._breaker(ex).is_open(thr, now)}

    def _rebalance_locked(self) -> dict:
        """Monitor tick (lock held, pump thread): update the per-shard
        request-rate EWMA from the ``shard_batches`` and host-served
        deltas, then split the tail shard past its row budget, rebuild the
        shards device loss left with no live stream, replicate the hottest
        resident shard or shed a replica of a cooled one, re-replicate
        shards whose streams went unhealthy (failover), and run the tier
        policies. One action of each kind per tick keeps rebalancing
        incremental."""
        actions: dict = {"split": [], "replicated": [], "dropped": [],
                         "failover_replicated": [], "rebuilt": [],
                         "demoted": [], "promoted": []}
        sx = self._sharded_ex
        if sx is None:
            return actions
        self.stats["rebalances"] += 1
        self._mon_mark = self.stats["launches"] + self.stats["host_gathers"]
        sb = self.stats["shard_batches"]
        a = self._mon_alpha
        for s in range(len(sb)):
            # host-served chunks are load too: a warm shard's misses never
            # reach shard_batches, and promotion orders by this heat
            total = sb[s] + self._host_served[s]
            delta = total - self._mon_last[s]
            self._mon_last[s] = total
            self._mon_ewma[s] = a * delta + (1 - a) * self._mon_ewma[s]
        # -- policy 1: tail re-shard under streaming growth --
        if self.row_budget is not None and sx.tail_rows() > self.row_budget:
            old = len(sx.shards) - 1
            start, _ = sx.shards[old].shard_bounds
            cut = start + max(32, self.row_budget // 32 * 32)
            new = self._apply_split_locked(cut)
            actions["split"].append((old, new, cut))
        # -- policy 4: rebuild the shards with no live stream, before the
        #    replica policies, so they see the rebuilt set --
        for s in sorted(self._needs_rebuild):
            if self._rebuild_shard_locked(s):
                actions["rebuilt"].append((s, sx.devices[s]))
        now = time.perf_counter()
        sick = {s for s in range(self._n_shards)
                if len(self._healthy_streams(s, now))
                < len(self._shard_streams(s))}
        cap = self.max_replicas
        if cap is None:
            cap = len(set(sx.device_pool)) - 1
        # -- policy 2: hot-shard replication / cold-shard shedding --
        ewma = self._mon_ewma
        mean = sum(ewma) / max(len(ewma), 1)
        if mean > 0 and len(ewma) > 1:
            # a shard served from the host (rebuild pending, warm or cold)
            # reads its load as a promotion signal, not a replication one
            hot = max((s for s in range(len(ewma))
                       if s not in self._needs_rebuild
                       and s not in self._offdevice),
                      key=lambda s: ewma[s], default=None)
            # hot = hot_factor x the mean of the OTHER shards: with the
            # hot shard in the mean, a hot_factor >= n_shards could never
            # be reached
            if hot is not None:
                others = (sum(ewma) - ewma[hot]) / (len(ewma) - 1)
                if ewma[hot] > self.hot_factor * others \
                        and len(sx.replicas[hot]) < cap:
                    # a replica is stream bytes too: place it around
                    # devices without budget headroom, or not at all
                    bavoid = self._budget_avoid_locked(
                        sx.executors[hot].stream_nbytes())
                    if any(d not in bavoid for d in sx.device_pool):
                        actions["replicated"].append(
                            (hot, self._add_replica_locked(
                                hot, avoid=bavoid)))
            for s in range(len(ewma)):
                # never shed a replica of a shard with an unhealthy stream:
                # the copies are its availability margin
                if s != hot and sx.replicas[s] and ewma[s] < mean \
                        and s not in sick:
                    actions["dropped"].append(
                        (s, self._drop_replica_locked(s)))
                    break
        # -- policy 3: failover re-replication around unhealthy streams --
        if sick:
            bad = self._unhealthy_devices(now)
            for s in sorted(sick):
                # a rebuild-pending shard is policy 4's, and an off-device
                # one is served from the host by design: no replica
                if s in self._needs_rebuild or s in self._offdevice:
                    continue
                if len(self._healthy_streams(s, now)) < 2 \
                        and len(sx.replicas[s]) < cap:
                    avoid = bad | self._budget_avoid_locked(
                        sx.executors[s].stream_nbytes())
                    actions["failover_replicated"].append(
                        (s, self._add_replica_locked(s, avoid=avoid)))
        # -- policies 5-7: the tiered-residency ladder --
        self._tier_policy_locked(actions)
        return actions

    def _apply_split_locked(self, cut: int | None = None,
                            device=None) -> int:
        """Tail split + atomic routing swap (lock held, pump thread): the
        executor-level swap first (new shard and stream committed, bounds
        flipped, old tail closed), then one new queue, in-flight window and
        stats lane APPENDED (existing shard indices never move), the old
        tail's queued chunks re-routed to whichever side of the cut owns
        their rows, and the route generation bumped so a submit that raced
        the swap builds its chunks again."""
        self._require_mesh()
        sx = self._sharded_ex
        old = len(sx.shards) - 1
        new = sx.split_tail(cut=cut, device=device)
        self._queues.append(deque())
        self._inflights.append(deque())
        self._busy.append(0)
        for k in ("shard_launches", "shard_batches", "shard_bytes_h2d"):
            self.stats[k].append(0)
        self._mon_ewma.append(0.0)
        self._mon_last.append(0)
        self._stream_rr.append(0)
        self._stragglers.append(self._new_straggler())
        # the fresh tail commits hot; if that overflows the budget the next
        # tier-policy tick demotes the coldest resident
        self._tier.append("hot")
        self.stats["tier_hot"] += 1
        self._warm_ticks.append(0)
        self._host_served.append(0)
        self._n_shards += 1
        self.stats["shard_splits"] += 1
        self._reroute_after_split(old, new)
        self._route_gen += 1
        self._work.notify_all()         # the new queue may be launchable
        return new

    def _reroute_after_split(self, old: int, new: int) -> None:
        """Move queued old-tail chunks whose rows now belong to the new
        shard (lock held). A chunk straddling the cut splits in two: its
        ticket's chunk count grows by one and each piece keeps its output
        positions, so the request retires complete and in order."""
        sx = self._sharded_ex
        cut_local = int(sx.shards[new]._start - sx.shards[old]._start)
        q = self._queues[old]
        if not q:
            return
        keep: deque = deque()
        moved: deque = deque()
        for ch in q:
            below = ch.rows < cut_local
            if below.all():
                keep.append(ch)
                continue
            if not below.any():
                ch.rows = ch.rows - cut_local
                ch.shard = new
                moved.append(ch)
                continue
            pos = (ch.dest + np.arange(ch.n)
                   if isinstance(ch.dest, (int, np.integer)) else ch.dest)
            ra, rb = ch.rows[below], ch.rows[~below] - cut_local
            ka = _Chunk(ch.ticket, ra, ra.shape[0],
                        self._bucket(ra.shape[0]), old, pos[below],
                        ch.t_enq, klass=ch.klass)
            kb = _Chunk(ch.ticket, rb, rb.shape[0],
                        self._bucket(rb.shape[0]), new, pos[~below],
                        ch.t_enq, klass=ch.klass)
            keep.append(ka)
            moved.append(kb)
            self._chunks_total[ch.ticket] += 1
            # keep the submit-time accounting honest: the two pieces pad
            # (and range-classify) differently than the chunk they replace
            self.stats["padded_rows"] += (ka.bucket - ka.n) + \
                (kb.bucket - kb.n) - (ch.bucket - ch.n)
            self.stats["packed_ranges"] += (
                int(self._aligned_range(ka.rows)) +
                int(self._aligned_range(kb.rows)) -
                int(self._aligned_range(ch.rows)))
        q.clear()
        q.extend(keep)
        self._queues[new].extend(moved)

    # -- tiered residency (hot / warm / cold) ----------------------------------------
    def _set_tier_locked(self, s: int, tier: str) -> None:
        """Flip one shard's tier label, its gauge stats and the off-device
        set (lock held): the ONE place tier state changes."""
        old = self._tier[s]
        if old == tier:
            return
        self.stats["tier_" + old] -= 1
        self.stats["tier_" + tier] += 1
        self._tier[s] = tier
        if tier == "hot":
            self._offdevice.discard(s)
        else:
            self._offdevice.add(s)

    def _budget_avoid_locked(self, need: int) -> frozenset:
        """Devices WITHOUT headroom for ``need`` more stream bytes (empty
        when uncapped): the placement-avoid set of replica adds, so read
        fan-out keeps to the budget too."""
        sx = self._sharded_ex
        if sx is None or sx.hbm_budget_bytes is None:
            return frozenset()
        ledger = sx.budget_ledger()
        return frozenset(d for d in sx.device_pool
                         if not ledger.fits(d, need))

    def _demote_shard_locked(self, s: int, tier: str = "warm") -> int:
        """Move shard ``s`` down the ladder (lock held, pump thread);
        returns the device bytes freed. ``warm`` drops every replica and
        the primary's words (launches in flight keep theirs: the words
        were allocated on the executor's stream); ``cold`` also turns the
        host packed copy into RLE runs. The open tail cannot go cold.
        Queued and later requests for the shard are served from the host
        as soon as the tier flips."""
        sx = self._sharded_ex
        sp = sx.shards[s]
        if tier == "cold" and sp._last:
            raise ValueError("the open tail shard cannot go cold (its RLE "
                             "runs would close a still-appending range); "
                             "demote to 'warm' or split_tail() first")
        if self._tier[s] == "cold" and tier == "warm":
            # up the ladder within the host tiers: the packed copy comes
            # back, nothing on the device changes
            if sp.is_cold:
                sp.rehydrate()
                self.stats["rehydrations"] += 1
            self._set_tier_locked(s, "warm")
            return 0
        if self._tier[s] == tier:
            return 0
        while sx.replicas[s]:
            self._drop_replica_locked(s)
        freed = sx.executors[s].evict_words()
        if tier == "cold" and not sp.is_cold:
            sp.demote_cold()
        self._set_tier_locked(s, tier)
        self._warm_ticks[s] = 0
        # a demoted shard is served from the host by design: it no longer
        # needs the rebuild a device loss may have queued
        self._needs_rebuild.discard(s)
        self.stats["demotions"] += 1
        return freed

    def _promote_shard_locked(self, s: int) -> bool:
        """Commit shard ``s``'s words on the device again (lock held, pump
        thread): a cold shard rehydrates first, and a shard whose home
        device is down is rebuilt on a survivor. False when no device
        survives (a cold shard has still moved up to warm)."""
        sx = self._sharded_ex
        if self._tier[s] == "hot":
            return True
        sp = sx.shards[s]
        if sp.is_cold:
            sp.rehydrate()
            self.stats["rehydrations"] += 1
            if self._tier[s] == "cold":
                self._set_tier_locked(s, "warm")
        ex = sx.executors[s]
        down = set(self._device_health.down)
        if ex.device in down:
            try:
                sx.rebuild_on(s, lost=down)
            except ValueError:
                return False        # no surviving device: stay on the host
            self._discard_breaker_locked(ex)
        else:
            ex.ensure_range_capacity(sp.n_rows)
        self._set_tier_locked(s, "hot")
        self._warm_ticks[s] = 0
        self._promote_pending.discard(s)
        self.stats["promotions"] += 1
        self._work.notify_all()     # the shard's queue launches again
        return True

    def _try_promote_locked(self, s: int) -> bool:
        """Promotion within the budget (lock held, pump thread): demote
        strictly COLDER resident shards (lower EWMA: equal heat never
        thrashes) off the target device until ``s`` fits, then promote.
        False when the stream can never fit, nothing colder is left to
        displace, or no device survives."""
        sx = self._sharded_ex
        if sx is None or s in self._needs_rebuild:
            return False
        if self._tier[s] == "hot":
            return True                   # a free-beat promote came first
        budget = sx.hbm_budget_bytes
        if budget is not None:
            ex = sx.executors[s]
            need = ex.stream_nbytes()
            if need > budget:
                return False              # a stream that can NEVER fit
            # a dead home device: the promote rebuilds on a survivor and
            # the enforcement after it settles any overshoot there
            dev = None if self._device_health.is_down(ex.device) \
                else ex.device
            guard = 0
            while dev is not None and not sx.budget_ledger().fits(dev, need):
                victims = [v for v in range(self._n_shards)
                           if v != s and self._tier[v] == "hot"
                           and self._mon_ewma[v] < self._mon_ewma[s]
                           and any(e.device == dev and e.resident_bytes() > 0
                                   for e in sx.stream_executors(v))]
                guard += 1
                if not victims or guard > self._n_shards:
                    return False          # nothing colder to displace
                self._demote_shard_locked(
                    min(victims, key=lambda v: self._mon_ewma[v]), "warm")
        ok = self._promote_shard_locked(s)
        if ok and budget is not None:
            self._enforce_budget_locked()
        return ok

    def _enforce_budget_locked(self, actions: dict | None = None) -> None:
        """Settle every device under the byte budget (lock held): first
        drop the words a pushdown scan put for a warm or cold shard, then
        demote the coldest hot shard holding a stream on an over-budget
        device until none is over. Measured from the tensors actually held
        (:meth:`ShardedFeatureExecutor.device_bytes`), so what splits,
        rebuilds, replica adds and pushdown put settles here."""
        sx = self._sharded_ex
        if sx is None or sx.hbm_budget_bytes is None:
            return
        budget = sx.hbm_budget_bytes
        over = {d for d, b in sx.device_bytes().items() if b > budget}
        for v in self._offdevice:
            if sx.executors[v].device in over:
                sx.executors[v].evict_words()
        for _ in range(4 * self._n_shards + 8):
            over = [d for d, b in sx.device_bytes().items() if b > budget]
            if not over:
                return
            victims = [v for v in range(self._n_shards)
                       if self._tier[v] == "hot"
                       and any(e.device == over[0] and e.resident_bytes() > 0
                               for e in sx.stream_executors(v))]
            if not victims:
                return
            v = min(victims, key=lambda x: self._mon_ewma[x])
            self._demote_shard_locked(v, "warm")
            if actions is not None:
                actions["demoted"].append((v, "warm"))

    def _tier_policy_locked(self, actions: dict) -> None:
        """The monitor's residency policies, at the end of every tick (lock
        held, pump thread): settle over-budget devices; age a warm, closed
        shard quiet for ``cold_after`` ticks to cold; promote the hottest
        off-device shard with load (tier misses also promote sooner, on a
        free beat of the pump)."""
        sx = self._sharded_ex
        if sx is None:
            return
        self._enforce_budget_locked(actions)
        for s in range(self._n_shards):
            if self._tier[s] != "warm" or s in self._needs_rebuild \
                    or sx.shards[s]._last:
                continue
            self._warm_ticks[s] += 1
            if self._warm_ticks[s] >= self.cold_after:
                self._demote_shard_locked(s, "cold")
                actions["demoted"].append((s, "cold"))
        cand = [s for s in self._offdevice
                if s not in self._needs_rebuild and self._mon_ewma[s] > 0]
        if cand:
            s = max(cand, key=lambda i: self._mon_ewma[i])
            if self._try_promote_locked(s):
                actions["promoted"].append(s)

    @property
    def tiers(self) -> list[str]:
        """Residency tier per shard: 'hot', 'warm' or 'cold'."""
        with self._lock:
            return list(self._tier)

    def device_bytes(self) -> dict:
        """Resident word-stream bytes per device (keyed by the device), as
        the tensors held say: what the budget is enforced against. Empty
        for unsharded services."""
        with self._lock:
            return ({} if self._sharded_ex is None
                    else self._sharded_ex.device_bytes())

    def demote(self, shard: int, tier: str = "warm") -> int:
        """Move ``shard`` down the ladder ('warm' frees its device words,
        'cold' also turns its host copy into RLE runs), on the pump like
        every shard-set mutation; returns the device bytes freed. Requests
        keep being served bit-exact from the host."""
        if tier not in ("warm", "cold"):
            raise ValueError(f"tier must be 'warm' or 'cold', got {tier!r}")
        self._require_mesh()
        return self._run_admin(lambda: self._demote_shard_locked(shard, tier))

    def promote(self, shard: int) -> bool:
        """Promote ``shard`` to the hot tier within the budget (colder
        residents are displaced to warm when the device is full). False
        when it cannot fit or no device survives: the shard keeps being
        served from the host."""
        self._require_mesh()
        return self._run_admin(lambda: self._try_promote_locked(shard))

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
            return any(self._queues)
        return any(ch.ticket == ticket for q in self._queues for ch in q)

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

    # -- predicate pushdown queries -------------------------------------------------
    def _pushdown(self, query):
        """Run ``query`` on the executor pushdown scans: the service's
        one, or the sharded one (a scan per shard, matches found where the
        data lives). On a sharded service the query runs ON THE PUMP
        THREAD (:meth:`_run_admin`): the scan re-puts a warm shard's words
        and rehydrates a cold one, and the pump's tier moves, evictions
        and rebuilds swap executors and word streams, so both kinds of
        change stay on one thread and a scan never meets a half-moved
        shard. It needs a live pump, and serving waits while it scans."""
        if not self.packed:
            raise RuntimeError("predicate pushdown needs a packed plan "
                               "(resident word streams)")
        sx = self._sharded_ex
        if sx is None:
            return query(self._executor)
        return self._run_admin(lambda: query(sx))

    def filtered_rows(self, where) -> np.ndarray:
        """Matching row indices via the device predicate scan."""
        return self._pushdown(lambda ex: ex.filtered_rows(where))

    def count_where(self, where) -> int:
        """SELECT COUNT(*) WHERE — one scan launch."""
        return self._pushdown(lambda ex: ex.count_where(where))

    def groupby_where(self, column: str, where):
        """GROUP BY column COUNT(*) WHERE — masked device histogram."""
        return self._pushdown(lambda ex: ex.groupby_where(column, where))

    def agg_where(self, where, column: str, agg: str = "count") -> float:
        """Masked count/sum/mean of ``column`` under a predicate."""
        return self._pushdown(lambda ex: ex.agg_where(where, column, agg))

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
