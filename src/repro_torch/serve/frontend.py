"""Multi-tenant front door for :class:`~repro_torch.serve.FeatureService`.

The production request boundary the ROADMAP's front-door item asks for:
many concurrent analysis consumers reach ONE pump-driven service through
per-tenant **request classes** with admission control, backpressure, and
per-class tail-latency accounting — instead of every caller holding the
raw executor (the in-database-AI framing: the data system mediates the
workload, NeurDB-style, rather than handing out engines).

Division of labor with the service:

- the **service** owns the pump: per-class priority scheduling with
  anti-starvation aging, per-class coalescing/linger, per-class latency
  histograms, typed per-ticket errors (all added alongside this module —
  construct the service with ``classes=`` and the frontend reads them);
- the **frontend** owns the boundary: per-class admission windows
  (``max_inflight`` outstanding admitted freely, ``queue_depth`` more
  admitted as queued work, then typed :class:`Overloaded` rejection with
  a retry-after hint — queue growth is BOUNDED by construction), per-
  tenant attribution, an asyncio-friendly ``featurize`` coroutine, and a
  dict-based request/response handler (:meth:`handle`) as the network-
  style edge. Phase 2 (see ROADMAP) puts a real socket transport and
  cross-process tenants in front of ``handle``; in-process it already
  defines the wire contract.

Outstanding work is counted submit -> resolution-retrieval: a ticket
occupies its class's window until the caller (or ``collect``) retrieves
its result or typed error. That makes the window END-TO-END flow
control — a consumer that submits but never collects saturates its own
class and gets Overloaded, instead of growing an unbounded uncollected-
results heap inside the service.
"""
from __future__ import annotations

import asyncio
import threading

import numpy as np

from repro_torch.serve.classes import (Overloaded, RequestClass,
                                       default_classes)
from repro_torch.serve.faults import ServeError
from repro_torch.serve.feature_service import FeatureService


class FeatureFrontend:
    """The front door over one :class:`FeatureService` (see module doc).

    The service must carry the request classes (``FeatureService(...,
    classes=...)``); :meth:`for_plan` builds both in one call. Thread-
    safe: admission state lives under its own lock (never held across
    service calls), tickets remain plain service tickets — mixing
    frontend and direct service access works, but only frontend-submitted
    tickets are admission-tracked.
    """

    def __init__(self, service: FeatureService, *,
                 default_klass: str | None = None):
        classes = {n: rc for n, rc in service.classes.items()
                   if n != "default"}
        if not classes:
            raise ValueError(
                "service has no request classes — construct it with "
                "classes= (e.g. default_classes()) before fronting it")
        self.service = service
        self._classes = classes
        if default_klass is None:
            default_klass = max(classes,
                                key=lambda n: classes[n].priority)
        if default_klass not in classes:
            raise ValueError(f"unknown default class {default_klass!r}")
        self.default_klass = default_klass
        self._lock = threading.Lock()
        self._outstanding = {n: 0 for n in classes}
        self._tickets: dict[int, tuple[str, str]] = {}  # -> (klass, tenant)
        self._admission = {n: {"admitted": 0, "admitted_queued": 0,
                               "rejected": 0}
                           for n in classes}
        self._tenants: dict[str, dict] = {}

    @classmethod
    def for_plan(cls, plan, *,
                 classes: tuple[RequestClass, ...] | None = None,
                 default_klass: str | None = None,
                 **service_kw) -> "FeatureFrontend":
        """Build service + frontend in one call (the
        :func:`default_classes` presets when ``classes`` is omitted);
        ``service_kw`` passes through to :class:`FeatureService`."""
        svc = FeatureService(plan, classes=classes or default_classes(),
                             **service_kw)
        return cls(svc, default_klass=default_klass)

    # -- lifecycle -------------------------------------------------------------------
    def __enter__(self) -> "FeatureFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self, drain: bool = True) -> None:
        self.service.shutdown(drain=drain)

    # -- admission -------------------------------------------------------------------
    def _retry_after(self, rc: RequestClass, outstanding: int) -> float:
        """Backoff hint for an Overloaded rejection: the class's observed
        p50 latency (floored at 1 ms pre-warmup) scaled by how many
        window-widths deep the backlog is — a rough when-will-a-slot-free
        estimate, not a promise."""
        p50 = self.service.latency_percentile(50, rc.name)
        depth = max(1.0, (outstanding - rc.max_inflight + 1)
                    / max(rc.max_inflight, 1))
        return max(p50, 1e-3) * depth

    def submit(self, rows: np.ndarray | None = None, *,
               klass: str | None = None, tenant: str = "anon",
               where=None, deadline_ms: float | None = None) -> int:
        """Admission-controlled :meth:`FeatureService.submit`.

        Admits while the class's outstanding count (submitted minus
        retrieved) is under ``max_inflight + queue_depth`` — past
        ``max_inflight`` the admit is counted as QUEUED, so backpressure
        is visible before rejection starts — and raises
        :class:`Overloaded` with a ``retry_after_s`` hint at the bound.
        Never drops a ticket: a rejected submit enqueued nothing, an
        admitted one returns a normal service ticket (collect it via
        this frontend so the window frees).
        """
        if klass is None:
            klass = self.default_klass
        rc = self._classes.get(klass)
        if rc is None:
            raise ValueError(f"unknown request class {klass!r} "
                             f"(registered: {sorted(self._classes)})")
        bound = rc.max_inflight + rc.queue_depth
        with self._lock:
            out = self._outstanding[klass]
            ten = self._tenants.setdefault(
                tenant, {"requests": 0, "admitted": 0, "rejected": 0})
            ten["requests"] += 1
            if out >= bound:
                self._admission[klass]["rejected"] += 1
                ten["rejected"] += 1
                reject = Overloaded(
                    f"class {klass!r} saturated: {out} outstanding >= "
                    f"window {rc.max_inflight} + queue depth "
                    f"{rc.queue_depth}", klass=klass, tenant=tenant,
                    outstanding=out, bound=bound,
                    retry_after_s=0.0)
            else:
                reject = None
                # reserve the slot before releasing the lock: concurrent
                # submits each see their own reservation, so the bound
                # holds even mid-service-call
                self._outstanding[klass] = out + 1
        if reject is not None:
            # the hint reads service stats — computed outside our lock
            reject.retry_after_s = self._retry_after(rc, out)
            raise reject
        try:
            ticket = self.service.submit(rows, where=where, klass=klass,
                                         deadline_ms=deadline_ms)
        except BaseException:
            with self._lock:
                self._outstanding[klass] -= 1
            raise
        with self._lock:
            self._tickets[ticket] = (klass, tenant)
            adm = self._admission[klass]
            adm["admitted"] += 1
            if out >= rc.max_inflight:
                adm["admitted_queued"] += 1
            ten["admitted"] += 1
        return ticket

    def _release(self, ticket: int) -> None:
        """A frontend-submitted ticket RESOLVED and its outcome was
        retrieved: free its admission slot (idempotent)."""
        with self._lock:
            entry = self._tickets.pop(ticket, None)
            if entry is not None:
                self._outstanding[entry[0]] -= 1

    # -- retrieval -------------------------------------------------------------------
    def poll(self, ticket: int) -> bool:
        return self.service.poll(ticket)

    def result(self, ticket: int,
               timeout: float | None = None) -> np.ndarray:
        """:meth:`FeatureService.result` + admission release: the slot
        frees when the ticket's outcome (features or typed error) is
        retrieved. A plain wait ``timeout`` expiring does NOT free the
        slot — the ticket is still outstanding."""
        try:
            out = self.service.result(ticket, timeout=timeout)
        except (ServeError, KeyError):
            # resolved-to-error (DeadlineExceeded included) or unknown/
            # already-collected: either way it no longer occupies a slot
            self._release(ticket)
            raise
        self._release(ticket)
        return out

    def collect(self, timeout: float | None = None) -> dict:
        """Drain + retrieve everything resolved (features or typed
        errors, like :meth:`FeatureService.collect`), freeing the
        admission slots of every frontend ticket retrieved."""
        out = self.service.collect(timeout)
        for t in out:
            self._release(t)
        return out

    async def featurize(self, rows: np.ndarray | None = None, *,
                        klass: str | None = None, tenant: str = "anon",
                        where=None, deadline_ms: float | None = None,
                        poll_s: float = 0.002) -> np.ndarray:
        """Async request/response: admission-controlled submit, then an
        await-friendly poll until the ticket resolves (the event loop
        stays free — no thread is parked in ``result``). Raises
        :class:`Overloaded` immediately when the class is saturated;
        typed :class:`ServeError` when the ticket fails."""
        ticket = self.submit(rows, klass=klass, tenant=tenant,
                             where=where, deadline_ms=deadline_ms)
        while not self.service.poll(ticket):
            await asyncio.sleep(poll_s)
        return self.result(ticket, timeout=1.0)

    # -- the network-style edge ------------------------------------------------------
    def handle(self, req: dict) -> dict:
        """One request/response exchange over plain dicts — the wire
        contract a phase-2 socket transport serializes. Ops:

        - ``{"op": "featurize", "rows": [...], "klass": ..., "tenant":
          ..., "deadline_ms": ...}`` -> ``{"ok": True, "ticket": t}``, or
          ``{"ok": False, "error": "overloaded", "retry_after_ms": ...}``
        - ``{"op": "result", "ticket": t, "timeout": s}`` -> ``{"ok":
          True, "features": ndarray}`` | ``{"ok": False, "error":
          "serve_error" | "timeout" | "unknown_ticket", "detail": ...}``
        - ``{"op": "stats"}`` -> ``{"ok": True, "stats": ...}``

        Responses are JSON-safe except the ``features`` payload (an
        ndarray — the transport picks its own array encoding).
        """
        op = req.get("op", "featurize")
        try:
            if op == "featurize":
                rows = req.get("rows")
                ticket = self.submit(
                    None if rows is None else np.asarray(rows),
                    klass=req.get("klass"),
                    tenant=req.get("tenant", "anon"),
                    where=req.get("where"),
                    deadline_ms=req.get("deadline_ms"))
                return {"ok": True, "ticket": ticket}
            if op == "result":
                feats = self.result(req["ticket"],
                                    timeout=req.get("timeout"))
                return {"ok": True, "features": feats}
            if op == "stats":
                return {"ok": True, "stats": self.stats()}
            return {"ok": False, "error": "bad_request",
                    "detail": f"unknown op {op!r}"}
        except Overloaded as e:
            return {"ok": False, "error": "overloaded",
                    "klass": e.klass, "tenant": e.tenant,
                    "retry_after_ms": e.retry_after_s * 1e3}
        except ServeError as e:
            return {"ok": False, "error": "serve_error", "detail": str(e)}
        except TimeoutError as e:
            return {"ok": False, "error": "timeout", "detail": str(e)}
        except KeyError as e:
            return {"ok": False, "error": "unknown_ticket",
                    "detail": str(e)}
        except (ValueError, IndexError, RuntimeError) as e:
            return {"ok": False, "error": "bad_request", "detail": str(e)}

    # -- reporting -------------------------------------------------------------------
    def stats(self) -> dict:
        """JSON-safe front-door picture: per class — admission counts,
        current outstanding, and the service's per-class serving stats
        (p50/p99 over ALL completed tickets); per tenant — request/
        admit/reject counts; plus ``availability_admitted``, completed
        over resolved across every class (the >= 1.0 bit-exact SLO gate
        for admitted work — rejected submits never enter it)."""
        svc_classes = self.service.class_stats()
        with self._lock:
            classes = {}
            done = failed = 0
            for name in self._classes:
                svc = svc_classes.get(name, {})
                done += svc.get("completed", 0)
                failed += svc.get("failed", 0)
                classes[name] = {**self._admission[name],
                                 "outstanding": self._outstanding[name],
                                 **svc}
            resolved = done + failed
            return {"classes": classes,
                    "tenants": {t: dict(v)
                                for t, v in self._tenants.items()},
                    "availability_admitted":
                        done / resolved if resolved else 1.0}
