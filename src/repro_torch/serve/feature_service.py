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

Each launch copies its features into a pinned host buffer asynchronously
and records a CUDA event behind the copy; retiring a launch waits on that
event (``Event.query()`` first, blocking only when the copy is not yet
done), so the pump never synchronises the whole device.

``linger_us`` adds bounded-latency coalescing: under light load the pump
may hold a PARTIAL launch group open until its oldest chunk has been
queued ``linger_us`` microseconds. ``linger_us=0`` (default) launches
whatever is queued.

A launch or retire that raises fails ONLY its own launch group: each of
its tickets resolves to a :class:`ServeError` (chained to the cause) that
:meth:`result` raises, and the service keeps serving. ``deadline_ms`` on
:meth:`submit` evicts a request's still-queued chunks once expired (the
ticket resolves to :class:`DeadlineExceeded`, also a ``TimeoutError``);
``timeout=`` on :meth:`result`/:meth:`drain`/:meth:`collect` bounds every
blocking wait, so a device fault can never hang a caller.

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
from repro_torch.serve.classes import LatencyHistogram
from repro_torch.serve.faults import DeadlineExceeded, ServeError

DEFAULT_BUCKETS = (64, 256, 1024)


@dataclass
class _Chunk:
    """One bucket-shaped slice of a request, queued for the pump."""
    ticket: int
    rows: np.ndarray        # raw (unpadded) row indices
    n: int                  # valid rows (== rows.shape[0])
    bucket: int             # static launch shape this chunk pads to
    dest: int               # first row of this chunk in the request output
    t_enq: float = 0.0


@dataclass
class _Flight:
    """One dispatched launch awaiting retire (pump thread only)."""
    host: torch.Tensor              # pinned copy of the launch buffer
    event: torch.cuda.Event | None  # recorded after the copy (None on CPU)
    parts: list                     # (ticket, n, dest, row_off) per chunk
    group: list                     # the _Chunks this launch covers


class FeatureService:
    """Request-queue-driven feature serving over a compiled FeaturePlan."""

    def __init__(self, plan: FeaturePlan | FeaturePipeline, *,
                 prefetch: int = 2,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 coalesce: int = 4, linger_us: float = 0.0):
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
        self._errors: dict[int, ServeError] = {}
        self._dead: set[int] = set()        # failed tickets: drop chunks
        self._deadlines: dict[int, float] = {}
        self._claimed: set[int] = set()     # tickets a result() call waits on
        self._submitted_at: dict[int, float] = {}
        self._next_ticket = 0
        self._paused = False
        self._shutdown = False
        self._flushes = 0               # drain()s in progress: no lingering
        self._pump_error: BaseException | None = None
        self.latencies: deque[float] = deque(maxlen=8192)  # per-ticket s
        self._lat_hist = LatencyHistogram()
        self.stats = {"requests": 0, "rows": 0, "padded_rows": 0,
                      "batches": 0, "launches": 0, "max_inflight": 0,
                      "latency_s_total": 0.0, "completed": 0,
                      "bytes_h2d": 0, "failed_tickets": 0, "timeouts": 0}
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

    # -- requests -------------------------------------------------------------------
    def submit(self, rows: np.ndarray, deadline_ms: float | None = None) -> int:
        """Enqueue a featurization request; returns a ticket for the result.

        Only queues: the pump picks the chunks up, coalesces them with other
        queued work and launches — the caller goes on submitting while the
        device gathers. ``deadline_ms`` bounds the request's time in the
        queue: chunks still QUEUED once it expires are dropped before launch
        and the ticket resolves to :class:`DeadlineExceeded` (chunks already
        in flight retire normally).
        """
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
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
            self.stats["rows"] += rows.size
            self.stats["padded_rows"] += padded
            self._chunks_total[ticket] = len(pieces)
            self._ticket_rows[ticket] = rows.size
            n0 = len(self._queue)
            for ch in pieces:
                ch.ticket = ticket
                ch.t_enq = now
                self._queue.append(ch)
            # wake the parked pump when the queue went empty -> nonempty or
            # this submit completed a coalescing group; chunks landing
            # mid-group ride the pending tick
            if n0 == 0 or n0 < self.coalesce <= len(self._queue):
                self._work.notify_all()
            return ticket

    def _bucket(self, n: int) -> int:
        """Smallest static bucket >= n (largest bucket caps a chunk)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -- the pump -------------------------------------------------------------------
    def _all_idle(self) -> bool:
        return not (self._queue or self._inflight or self._busy)

    def _linger_left(self, now: float) -> float:
        """Seconds the head launch group should stay open: 0 once a full
        group of the head's bucket is queued, else until the head chunk
        has waited ``linger_us``."""
        head = self._queue[0]
        n_match = 0
        for ch in self._queue:
            if ch.bucket == head.bucket:
                n_match += 1
                if n_match >= self.coalesce:
                    return 0.0
        return head.t_enq + self._linger_s - now

    def _pick_action(self):
        """The pump's next action (lock held): ``("launch", None)`` when the
        in-flight window has room and a group is ready, else ``("retire",
        None)`` for the oldest launch, ``("wait", timeout)`` or
        ``("exit", None)``. A lingering partial group is not launched, but
        its deadline bounds the wait."""
        linger = None
        if self._queue and not (self._paused and not self._shutdown) \
                and len(self._inflight) < self.prefetch:
            if self._linger_s > 0 and self.coalesce > 1 \
                    and not self._shutdown and not self._flushes:
                left = self._linger_left(time.perf_counter())
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
        """The thread target: run the pump; an error in its own control
        logic (not a guarded launch/retire) poisons the service and wakes
        every waiter, so no caller blocks forever, then ends the thread."""
        try:
            self._pump_loop()
        except BaseException as e:
            with self._lock:
                self._pump_error = e
                self._notify_everyone()
            raise

    def _pump_loop(self) -> None:
        """Coalesce -> launch -> retire until shutdown, with a
        ``prefetch``-deep in-flight window. The only thread that launches
        kernels or waits on their results; launches are asynchronous, so
        the device works while the pump prepares the next group.

        Fault isolation: dispatching a launch and waiting on its result are
        guarded per launch group — an exception there fails exactly that
        group's tickets (:meth:`_fail_group_locked`) and the loop goes on.
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
                    group = self._take_group(time.perf_counter())
                    if not group:
                        # the whole head group was evicted (failed or
                        # deadline-expired tickets) — nothing to launch
                        if self._all_idle():
                            self._idle.notify_all()
                        continue
                else:
                    fl = self._inflight.popleft()
                    group = fl.group
                self._busy = True
            try:
                if action == "launch":
                    fl, nbytes = self._launch(group)
                else:
                    arr = self._await_flight(fl)
            except Exception as e:
                with self._lock:
                    self._fail_group_locked(group, e)
                    self._busy = False
                    if self._all_idle():
                        self._idle.notify_all()
                continue
            with self._lock:
                if action == "launch":
                    self._inflight.append(fl)
                    self.stats["launches"] += 1
                    self.stats["batches"] += len(fl.parts)
                    self.stats["bytes_h2d"] += nbytes
                    self.stats["max_inflight"] = max(
                        self.stats["max_inflight"], len(self._inflight))
                elif self._retire(arr, fl.parts):
                    self._cv.notify_all()
                self._busy = False
                if self._all_idle():
                    self._idle.notify_all()

    def _take_group(self, now: float) -> list[_Chunk]:
        """Pop one launch group (lock held): up to ``coalesce`` queued
        chunks sharing the head's bucket shape, FIFO; chunks of other
        buckets keep their place. Chunks of failed tickets are dropped on
        sight, and a chunk whose ticket's deadline expired resolves it to
        :class:`DeadlineExceeded` before launch — so the group may come
        back empty."""
        queue = self._queue
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
            if len(group) >= self.coalesce:
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

        Packed plans: a flat (coalesce * bucket,) int32 index vector —
        padded to the full coalesce width so every launch of a bucket has
        one shape — into the packed rows kernel; the indices are all that
        crosses to the device. int32 plans: the (C, bucket) code slice of a
        single chunk into the int32 kernel. Either way the launch buffer is
        a flat (rows, F) array and each part records its chunk's row offset
        into it; on a CUDA device it is copied to pinned host memory
        asynchronously, with an event recorded behind the copy.
        """
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
            return _Flight(dev, None, parts, group), nbytes
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        return _Flight(host, event, parts, group), nbytes

    @staticmethod
    def _await_flight(fl: _Flight) -> np.ndarray:
        """The flight's features on the host, once its copy has landed:
        a non-blocking ``Event.query()``, then a blocking wait on the event
        only if the copy is still running. A fault in the launch surfaces
        here and fails just this group."""
        if fl.event is not None and not fl.event.query():
            fl.event.synchronize()
        return fl.host.numpy()

    def _retire(self, arr: np.ndarray, parts: list) -> bool:
        """Distribute one retired launch buffer to its tickets (lock held);
        True if any ticket completed (its waiters need a wake).

        Single-chunk requests take the sliced piece directly (copied when
        small, so the result does not pin the whole coalesced launch buffer
        for its lifetime); multi-chunk requests assemble into a per-ticket
        (rows, F) buffer at each chunk's destination.
        """
        landed = False
        for ticket, n, dest, off in parts:
            total = self._chunks_total.get(ticket)
            if total is None:
                continue                # dropped by shutdown(drain=False)
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
                self.latencies.append(lat)
                self._lat_hist.record(lat)
        return landed

    # -- failures ---------------------------------------------------------------------
    def _fail_ticket_locked(self, ticket: int, err: ServeError, *,
                            timeout: bool = False) -> None:
        """Resolve ``ticket`` to a typed error (lock held): the ledger
        entries go, the error is retrievable via poll/result/collect, and
        chunks of this ticket still queued are dropped on sight. Idempotent
        for already-resolved tickets."""
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
        if timeout:
            self.stats["timeouts"] += 1
        self._cv.notify_all()

    def _fail_group_locked(self, group: list[_Chunk], err: Exception) -> None:
        """A launch or retire raised: fail every ticket of its group with a
        :class:`ServeError` chained to ``err``; nothing else is touched."""
        for ch in group:
            if ch.ticket not in self._chunks_total:
                continue
            e = ServeError(f"request failed in its launch: {err!r}",
                           ticket=ch.ticket, shard=0, attempts=1)
            e.__cause__ = err
            self._fail_ticket_locked(ch.ticket, e)

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

    # -- reporting --------------------------------------------------------------
    def latency_percentile(self, q: float) -> float:
        """The q-th per-ticket latency percentile in SECONDS over every
        completed ticket (streaming histogram, ~10% resolution)."""
        with self._lock:
            return self._lat_hist.percentile(q)

    def throughput_stats(self, wall_s: float) -> dict:
        rows = self.stats["rows"]
        done = self.stats["completed"]
        resolved = done + self.stats["failed_tickets"]
        wall_ok = wall_s > 0
        return {**self.stats, "wall_s": wall_s,
                "wall_s_invalid": not wall_ok,
                "rows_per_s": rows / wall_s if wall_ok else 0.0,
                "mean_latency_s": (self.stats["latency_s_total"] / done
                                   if done else 0.0),
                "pending": max(self.stats["requests"] - resolved, 0),
                "availability": done / resolved if resolved else 1.0,
                "pad_overhead": (self.stats["padded_rows"] /
                                 max(rows + self.stats["padded_rows"], 1))}
