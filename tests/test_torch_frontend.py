"""Port parity, the front door: every test of ``tests/test_frontend.py``
with its seeds and asserts, run on the reference package (``repro``, its
plain jnp gathers) and on the port (``repro_torch``, the kernels' plain
versions on CPU tensors), each over a packed and an int32 plan.

Served features must equal the reference's bit for bit, and the port's
outcome must equal the reference's: which tickets fail, per-class
``class_stats`` counts, ``Overloaded`` counts and bounds, ``handle``
responses key for key, and, where work is staged while the pump is
paused with aging off, the order of launches (each launch's class and
tickets, logged by wrapping ``_launch``). Tests whose outcome rests on
timing (aging, deadlines) hold to their own asserts on both packages and
compare no timings.
"""
import asyncio
import json
import os
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.columnar import Table as JTable
from repro.core import (FeatureExecutor as JExecutor,
                        FeaturePlan as JPlan, FeatureSet as JFeatureSet)
from repro_torch.columnar import Table
from repro_torch.core import FeaturePlan, FeatureSet

PACKED = pytest.mark.parametrize("packed", [True, False],
                                 ids=["packed", "int32"])


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return {"age": rng.integers(18, 80, n),
            "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
            "income": rng.integers(20, 200, n) * 1000}


def _jplan(data, packed):
    fs = (JFeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return JPlan(JTable.from_data(data, imcu_rows=700), fs, packed=packed)


def _tplan(data, packed):
    fs = (FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return FeaturePlan(Table.from_data(data, imcu_rows=700), fs,
                       packed=packed, device="cpu")


SIDES = (SimpleNamespace(name="repro", S=jserve, plan=_jplan),
         SimpleNamespace(name="repro_torch", S=tserve, plan=_tplan))


def _reference(requests, n=3000):
    """Fault-free ground truth: the reference's int32 executor."""
    ex = JExecutor(_jplan(_data(n), False))
    return [np.asarray(ex.batch(r)) for r in requests]


def _svc(side, packed, classes, n=3000, **kw):
    """A service of ``side`` over the mixed table; ``classes`` is a
    function of the side's RequestClass (or None)."""
    S = side.S
    return S.FeatureService(side.plan(_data(n), packed),
                            classes=None if classes is None
                            else classes(S.RequestClass), **kw)


def _log_launches(svc) -> list:
    """Record (class, tickets) of each launch, in order."""
    log, orig = [], svc._launch

    def logged(group, *args):
        log.append((group[0].klass, [ch.ticket for ch in group]))
        return orig(group, *args)
    svc._launch = logged
    return log


def _counts(class_stats: dict) -> dict:
    """class_stats without its latency figures (counts only)."""
    keys = ("requests", "completed", "failed", "pending", "rows", "samples")
    return {k: {f: v[f] for f in keys} for k, v in class_stats.items()}


def _both(run, *args):
    """Run one scenario on the reference and on the port."""
    return [run(side, *args) for side in SIDES]


# -- request classes / construction --------------------------------------------------
def test_request_class_validation():
    for S in (jserve, tserve):
        RC = S.RequestClass
        for bad in ({"name": ""}, {"name": "x", "priority": -1},
                    {"name": "x", "deadline_ms": 0},
                    {"name": "x", "max_inflight": 0},
                    {"name": "x", "queue_depth": -1},
                    {"name": "x", "coalesce": 0},
                    {"name": "x", "aging_s": 0}):
            with pytest.raises(ValueError):
                RC(**bad)
        names = [rc.name for rc in S.default_classes()]
        assert names == ["interactive", "batch", "background"]
    assert tserve.default_classes() == tuple(
        tserve.RequestClass(**vars(rc)) for rc in jserve.default_classes())


@PACKED
def test_service_rejects_duplicate_and_unknown_classes(packed):
    def run(side, packed):
        S = side.S
        with pytest.raises(ValueError):
            _svc(side, packed, lambda RC: (RC("a"), RC("a")), n=1400)
        with _svc(side, packed, lambda RC: (RC("a"),), n=1400) as svc:
            with pytest.raises(ValueError):
                svc.submit(np.arange(8), klass="nope")
            assert set(svc.classes) == {"default", "a"}
            assert isinstance(svc.classes["a"], S.RequestClass)
        return sorted(svc.classes)
    ref, port = _both(run, packed)
    assert port == ref


@PACKED
def test_frontend_needs_classes(packed):
    def run(side, packed):
        S = side.S
        with _svc(side, packed, None, n=1400) as svc:
            with pytest.raises(ValueError):
                S.FeatureFrontend(svc)
        with _svc(side, packed, lambda RC: S.default_classes(),
                  n=1400) as svc:
            with pytest.raises(ValueError):
                S.FeatureFrontend(svc, default_klass="nope")
            fe = S.FeatureFrontend(svc)
            assert fe.default_klass == "interactive"
            with pytest.raises(ValueError):
                fe.submit(np.arange(8), klass="nope")
        return fe.default_klass
    ref, port = _both(run, packed)
    assert port == ref


# -- LatencyHistogram: the unbiased-p99 fix ------------------------------------------
def test_histogram_unbiased_where_sliding_window_lies():
    out = []
    for S in (jserve, tserve):
        window = deque(maxlen=64)
        hist = S.LatencyHistogram()
        for _ in range(100):
            window.append(0.1)
            hist.record(0.1)
        for _ in range(900):
            window.append(0.001)
            hist.record(0.001)
        assert np.percentile(window, 99) == pytest.approx(0.001)
        assert hist.count == 1000
        assert hist.percentile(99) == pytest.approx(0.1, rel=0.15)
        assert hist.percentile(50) == pytest.approx(0.001, rel=0.15)
        assert hist.mean_s == pytest.approx(0.0109, rel=1e-6)
        s = hist.summary()
        assert s["samples"] == 1000
        assert s["min_ms"] == pytest.approx(1.0)
        assert s["max_ms"] == pytest.approx(100.0)
        json.dumps(s, allow_nan=False)
        out.append((s, hist.counts.copy()))
    assert out[0][0] == out[1][0]
    assert np.array_equal(out[0][1], out[1][1])


def test_histogram_edges_and_merge():
    out = []
    for S in (jserve, tserve):
        h = S.LatencyHistogram()
        assert h.percentile(99) == 0.0 and h.mean_s == 0.0
        assert h.summary()["min_ms"] == 0.0
        with pytest.raises(ValueError):
            h.percentile(101)
        with pytest.raises(ValueError):
            S.LatencyHistogram(lo_s=0)
        h.record(1e-9)
        h.record(5e3)
        assert h.percentile(0) == pytest.approx(1e-9)
        assert h.percentile(100) == pytest.approx(5e3)
        other = S.LatencyHistogram()
        other.record(0.01)
        h.merge(other)
        assert h.count == 3 and h.max_s == 5e3
        with pytest.raises(ValueError):
            h.merge(S.LatencyHistogram(buckets_per_decade=12))
        out.append((h.summary(), [h.percentile(q) for q in (1, 50, 99)],
                    h.counts.copy()))
    assert out[0][:2] == out[1][:2]
    assert np.array_equal(out[0][2], out[1][2])


@PACKED
def test_service_percentiles_cover_all_ticket_history(packed):
    def run(side, packed):
        svc = _svc(side, packed,
                   lambda RC: (RC("interactive", priority=3),))
        with svc:
            svc.latencies = deque(maxlen=32)
            fe = side.S.FeatureFrontend(svc)
            for i in range(100):
                fe.submit(np.arange(i % 600, i % 600 + 24),
                          klass="interactive")
            out = fe.collect(timeout=60)
            assert svc.stats["latency_samples_total"] == 100
            assert len(svc.latencies) == 32
            cs = svc.class_stats()["interactive"]
            assert cs["samples"] == cs["completed"] == 100
            assert svc.latency_percentile(99) > 0.0
            assert svc.latency_percentile(99, "interactive") > 0.0
            svc.reset_latency_window()
            assert svc.stats["latency_samples_total"] == 0
            assert len(svc.latencies) == 0
            after = svc.class_stats()
            assert after["interactive"]["samples"] == 0
            assert after["interactive"]["completed"] == 100
        return [out[t] for t in sorted(out)], _counts(after)
    (ref, ref_cs), (got, got_cs) = _both(run, packed)
    want = _reference([np.arange(i % 600, i % 600 + 24) for i in range(100)])
    for g, r, w in zip(got, ref, want):
        assert np.array_equal(g, w) and np.array_equal(r, w)
    assert got_cs == ref_cs


# -- throughput_stats: inf + availability fixes --------------------------------------
@PACKED
def test_throughput_stats_json_safe_at_zero_wall(packed):
    def run(side, packed):
        with _svc(side, packed, None) as svc:
            tk = svc.submit(np.arange(64))
            feats = svc.result(tk, timeout=30)
            for wall in (0.0, -1.0):
                st = svc.throughput_stats(wall)
                assert st["wall_s_invalid"] is True
                assert st["rows_per_s"] == 0.0
                json.dumps(st, allow_nan=False)
            ok = svc.throughput_stats(1.0)
            assert ok["wall_s_invalid"] is False
            assert ok["rows_per_s"] == pytest.approx(64.0)
        return feats, ok
    (rf, rst), (tf, tst) = _both(run, packed)
    assert np.array_equal(tf, rf)
    assert np.array_equal(tf, _reference([np.arange(64)])[0])
    for key in ("requests", "rows", "padded_rows", "completed", "launches",
                "batches", "bytes_h2d", "failed_tickets", "pending",
                "availability", "rows_per_s", "latency_samples_total"):
        assert tst[key] == rst[key], key


@PACKED
def test_availability_reports_pending_not_failed(packed):
    def run(side, packed):
        with _svc(side, packed, None) as svc:
            svc.pause()
            tks = [svc.submit(np.arange(16 * i, 16 * i + 16))
                   for i in range(3)]
            st = svc.throughput_stats(1.0)
            assert st["pending"] == 3
            assert st["completed"] == 0
            assert st["availability"] == 1.0
            svc.resume()
            got = [svc.result(tk, timeout=30) for tk in tks]
            st2 = svc.throughput_stats(1.0)
            assert st2["pending"] == 0
            assert st2["completed"] == 3 and st2["availability"] == 1.0
        return got, [(s["pending"], s["completed"], s["availability"])
                     for s in (st, st2)]
    (rg, rs), (tg, ts) = _both(run, packed)
    assert ts == rs
    for t, r in zip(tg, rg):
        assert np.array_equal(t, r)


# -- priority pump scheduling --------------------------------------------------------
@PACKED
def test_priority_classes_drain_strictly_by_priority(packed):
    reqs_bg = [np.arange(700 * 2 + 32 * i, 700 * 2 + 32 * i + 32)
               for i in range(6)]
    reqs_in = [np.arange(32 * i, 32 * i + 32) for i in range(6)]
    want = _reference(reqs_bg + reqs_in)

    def run(side, packed):
        svc = _svc(side, packed, lambda RC: (
            RC("interactive", priority=3, aging_s=1000.0),
            RC("background", priority=1, aging_s=1000.0)))
        log = _log_launches(svc)
        with svc:
            svc.pause()
            tks = [svc.submit(r, klass="background") for r in reqs_bg]
            tks += [svc.submit(r, klass="interactive") for r in reqs_in]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tks]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        cs = svc.class_stats()
        assert cs["interactive"]["completed"] == 6
        assert cs["background"]["completed"] == 6
        assert cs["interactive"]["max_ms"] < cs["background"]["min_ms"]
        return log, _counts(cs)
    (rlog, rcs), (tlog, tcs) = _both(run, packed)
    assert tlog == rlog
    assert tcs == rcs
    # interactive drains first, in submission order
    assert [k for k, _ in tlog] == sorted((k for k, _ in tlog),
                                          key=lambda k: k != "interactive")


@PACKED
def test_aging_rescues_background_from_starvation(packed):
    reqs_in = [np.arange(s, s + 48) for s in
               np.linspace(0, 2300, 60).astype(int)]
    reqs_bg = [np.arange(1400 + 64 * i, 1400 + 64 * i + 64)
               for i in range(2)]
    want = _reference(reqs_in + reqs_bg)

    def run(side, packed):
        svc = _svc(side, packed, lambda RC: (
            RC("interactive", priority=3, aging_s=1000.0),
            RC("background", priority=1, aging_s=0.001)))
        with svc:
            svc.pause()
            tks = [svc.submit(r, klass="interactive") for r in reqs_in]
            tks += [svc.submit(r, klass="background") for r in reqs_bg]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tks]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        cs = svc.class_stats()
        assert cs["background"]["completed"] == 2
        assert cs["background"]["max_ms"] < cs["interactive"]["max_ms"]
        return _counts(cs)
    ref, port = _both(run, packed)
    assert port == ref


# -- admission control ---------------------------------------------------------------
@PACKED
def test_admission_bounds_and_recovers(packed):
    reqs = [np.arange(24 * i, 24 * i + 24) for i in range(5)]
    want = _reference(reqs)

    def run(side, packed):
        S = side.S
        svc = _svc(side, packed, lambda RC: (
            RC("interactive", priority=3, max_inflight=2, queue_depth=2),))
        with svc:
            fe = S.FeatureFrontend(svc)
            svc.pause()
            tks = [fe.submit(r, tenant="app") for r in reqs[:4]]
            with pytest.raises(S.Overloaded) as ei:
                fe.submit(reqs[4], tenant="app")
            e = ei.value
            assert e.klass == "interactive" and e.tenant == "app"
            assert e.outstanding == 4 and e.bound == 4
            assert e.retry_after_s > 0
            st = fe.stats()
            adm = st["classes"]["interactive"]
            assert adm["admitted"] == 4 and adm["rejected"] == 1
            assert adm["admitted_queued"] == 2
            assert adm["outstanding"] == 4
            assert st["tenants"]["app"] == {
                "requests": 5, "admitted": 4, "rejected": 1}
            svc.resume()
            got = [fe.result(tk, timeout=30) for tk in tks]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            tk = fe.submit(reqs[4], tenant="app")
            np.testing.assert_array_equal(fe.result(tk, timeout=30),
                                          want[4])
            st2 = fe.stats()
            assert st2["classes"]["interactive"]["outstanding"] == 0
            assert st2["availability_admitted"] == 1.0
        return ((e.klass, e.tenant, e.outstanding, e.bound),
                {k: adm[k] for k in ("admitted", "admitted_queued",
                                     "rejected", "outstanding")},
                st["tenants"], _counts(svc.class_stats()))
    ref, port = _both(run, packed)
    assert port == ref


@PACKED
def test_admission_zero_queue_depth_rejects_at_window(packed):
    def run(side, packed):
        S = side.S
        svc = _svc(side, packed, lambda RC: (
            RC("solo", max_inflight=1, queue_depth=0),))
        with svc:
            fe = S.FeatureFrontend(svc)
            svc.pause()
            fe.submit(np.arange(16))
            with pytest.raises(S.Overloaded) as ei:
                fe.submit(np.arange(16))
            svc.resume()
            first = fe.collect(timeout=30)
            fe.submit(np.arange(16))
            second = fe.collect(timeout=30)
        return (ei.value.outstanding, ei.value.bound,
                fe.stats()["classes"]["solo"]["rejected"],
                [first[t] for t in first] + [second[t] for t in second])
    ref, port = _both(run, packed)
    assert port[:3] == ref[:3] == (1, 1, 1)
    want = _reference([np.arange(16)])[0]
    for g in ref[3] + port[3]:
        assert np.array_equal(g, want)


@PACKED
def test_admission_slot_survives_timeout_releases_on_error(packed):
    want = _reference([np.arange(32)])[0]

    def run(side, packed):
        S = side.S
        inj = S.FaultInjector().delay_launches(0.25, 1, shard=0)
        svc = _svc(side, packed, lambda RC: (
            RC("a", max_inflight=1, queue_depth=0),), faults=inj)
        with svc:
            fe = S.FeatureFrontend(svc)
            tk = fe.submit(np.arange(32))
            with pytest.raises(TimeoutError):
                fe.result(tk, timeout=0.01)
            assert fe.stats()["classes"]["a"]["outstanding"] == 1
            with pytest.raises(S.Overloaded):
                fe.submit(np.arange(32))
            got = fe.result(tk, timeout=30)
            np.testing.assert_array_equal(got, want)
            assert fe.stats()["classes"]["a"]["outstanding"] == 0
            with pytest.raises(KeyError):
                fe.result(999_999)
            assert fe.stats()["classes"]["a"]["outstanding"] == 0
        return inj.delays_injected, fe.stats()["classes"]["a"]["rejected"]
    ref, port = _both(run, packed)
    assert port == ref == (1, 1)


@PACKED
def test_admission_releases_on_serve_error(packed):
    def run(side, packed):
        S = side.S
        inj = S.FaultInjector().fail_launches(10, shard=0)
        pol = S.FaultPolicy(max_retries=1, backoff_s=0.001,
                            breaker_fails=100)
        svc = _svc(side, packed, lambda RC: (
            RC("a", max_inflight=1, queue_depth=0),), faults=inj,
            fault_policy=pol)
        with svc:
            fe = S.FeatureFrontend(svc)
            tk = fe.submit(np.arange(16))
            with pytest.raises(S.ServeError) as ei:
                fe.result(tk, timeout=30)
            st = fe.stats()
            assert st["classes"]["a"]["outstanding"] == 0
            assert st["classes"]["a"]["failed"] == 1
            assert st["availability_admitted"] == 0.0
        assert isinstance(ei.value.__cause__, S.InjectedFault)
        return (ei.value.attempts, inj.faults_injected,
                svc.stats["retries"], svc.stats["failed_tickets"])
    ref, port = _both(run, packed)
    assert port == ref == (2, 2, 1, 1)


# -- per-class deadlines -------------------------------------------------------------
@PACKED
def test_class_default_deadline_applies_and_overrides(packed):
    want = _reference([np.arange(24)])[0]

    def run(side, packed):
        S = side.S
        svc = _svc(side, packed, lambda RC: (RC("tight", deadline_ms=20.0),))
        with svc:
            fe = S.FeatureFrontend(svc)
            svc.pause()
            tk_default = fe.submit(np.arange(24))
            tk_long = fe.submit(np.arange(24), deadline_ms=60_000.0)
            time.sleep(0.08)
            svc.resume()
            with pytest.raises(S.DeadlineExceeded):
                fe.result(tk_default, timeout=30)
            np.testing.assert_array_equal(fe.result(tk_long, timeout=30),
                                          want)
            st = fe.stats()
            assert st["classes"]["tight"]["outstanding"] == 0
            assert st["classes"]["tight"]["failed"] == 1
        return svc.stats["timeouts"], _counts(svc.class_stats())
    ref, port = _both(run, packed)
    assert port == ref


# -- class-scoped fault injection ----------------------------------------------------
def test_faults_scope_to_request_class():
    seen = []
    for S in (jserve, tserve):
        inj = S.FaultInjector().fail_launches(2, klass="batch")
        with pytest.raises(S.InjectedFault):
            inj.before_launch(0, 0, klass="batch")
        inj.before_launch(0, 0, klass="interactive")
        inj.before_launch(0, 0)
        with pytest.raises(S.InjectedFault):
            inj.before_launch(1, 2, klass="batch")
        assert inj.faults_injected == 2
        seen.append((inj.launches_seen, inj.faults_injected))
    assert seen[0] == seen[1]


@PACKED
def test_class_scoped_chaos_isolates_one_tenant_class(packed):
    """Work staged while paused and singleton launches (``coalesce=1``, an
    int32 plan's own depth), so the fault script plays out on the same
    launch sequence on both packages."""
    reqs_in = [np.arange(48 * i, 48 * i + 48) for i in range(4)]
    reqs_ba = [np.arange(1400 + 48 * i, 1400 + 48 * i + 48)
               for i in range(3)]
    want = _reference(reqs_in)

    def run(side, packed):
        S = side.S
        inj = S.FaultInjector().fail_launches(50, klass="batch")
        pol = S.FaultPolicy(max_retries=1, backoff_s=0.001,
                            breaker_fails=1000)
        svc = _svc(side, packed, lambda RC: (
            RC("interactive", priority=3), RC("batch", priority=2)),
            faults=inj, fault_policy=pol, coalesce=1)
        log = _log_launches(svc)
        with svc:
            fe = S.FeatureFrontend(svc)
            svc.pause()
            tks_in = [fe.submit(r, klass="interactive") for r in reqs_in]
            tks_ba = [fe.submit(r, klass="batch") for r in reqs_ba]
            svc.resume()
            for tk, w in zip(tks_in, want):
                np.testing.assert_array_equal(fe.result(tk, timeout=60), w)
            errs = []
            for tk in tks_ba:
                with pytest.raises(S.ServeError) as ei:
                    fe.result(tk, timeout=60)
                assert isinstance(ei.value.__cause__, S.InjectedFault)
                errs.append(ei.value.attempts)
        cs = svc.class_stats()
        assert cs["interactive"]["completed"] == 4
        assert cs["interactive"]["failed"] == 0
        assert cs["batch"]["failed"] == 3
        assert inj.faults_injected >= 6
        return (log, errs, inj.faults_injected, svc.stats["retries"],
                _counts(cs))
    ref, port = _both(run, packed)
    assert port == ref
    assert port[1] == [2, 2, 2]


# -- the async + dict edges ----------------------------------------------------------
@PACKED
def test_async_featurize_bit_exact(packed):
    reqs = [np.arange(64), np.arange(800, 880), np.arange(1500, 1532)]
    want = _reference(reqs)

    def run(side, packed):
        S = side.S

        async def go(fe):
            return await asyncio.gather(
                fe.featurize(reqs[0], klass="interactive"),
                fe.featurize(reqs[1], klass="batch"),
                fe.featurize(reqs[2], klass="background"))

        with _svc(side, packed, lambda RC: S.default_classes()) as svc:
            fe = S.FeatureFrontend(svc)
            got = asyncio.run(go(fe))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert fe.stats()["availability_admitted"] == 1.0
        return _counts(svc.class_stats())
    ref, port = _both(run, packed)
    assert port == ref


@PACKED
def test_handle_request_response_contract(packed):
    want = _reference([np.arange(40)])[0]

    def run(side, packed):
        S = side.S
        svc = _svc(side, packed, lambda RC: (
            RC("interactive", priority=3, max_inflight=1, queue_depth=0),
            RC("batch", priority=2)))
        responses = []
        with svc:
            fe = S.FeatureFrontend(svc)
            r = fe.handle({"op": "featurize", "rows": np.arange(40),
                           "klass": "batch", "tenant": "app"})
            assert r["ok"] and isinstance(r["ticket"], int)
            out = fe.handle({"op": "result", "ticket": r["ticket"],
                             "timeout": 30})
            assert out["ok"]
            np.testing.assert_array_equal(out["features"], want)
            st = fe.handle({"op": "stats"})
            assert st["ok"]
            json.dumps(st["stats"], allow_nan=False)
            bad = fe.handle({"op": "transmogrify"})
            unknown = fe.handle({"op": "result", "ticket": 12345})
            badk = fe.handle({"op": "featurize", "rows": [0, 1],
                              "klass": "nope"})
            assert bad["error"] == "bad_request"
            assert unknown["error"] == "unknown_ticket"
            assert badk["error"] == "bad_request"
            svc.pause()
            t1 = fe.handle({"op": "featurize", "rows": np.arange(8),
                            "klass": "interactive"})
            assert t1["ok"]
            over = fe.handle({"op": "featurize", "rows": np.arange(8),
                              "klass": "interactive", "tenant": "greedy"})
            assert over["error"] == "overloaded"
            assert over["klass"] == "interactive"
            assert over["tenant"] == "greedy"
            assert over["retry_after_ms"] > 0
            svc.resume()
            fe.collect(timeout=30)
            responses = [r, out, st, bad, unknown, badk, t1, over]
        return responses
    ref, port = _both(run, packed)
    for r, p in zip(ref, port):
        assert p.keys() == r.keys()
        for k in p:
            if k == "features":
                assert np.array_equal(p[k], r[k])
            elif k == "stats":
                assert p[k].keys() == r[k].keys()
                assert p[k]["tenants"] == r[k]["tenants"]
                assert _counts(p[k]["classes"]) == _counts(r[k]["classes"])
            elif k not in ("retry_after_ms", "detail"):
                assert p[k] == r[k], k


# -- randomized sweep (FRONTEND_SWEEP_SEEDS, as the reference's) ---------------------
@PACKED
@pytest.mark.parametrize("seed", range(int(
    os.environ.get("FRONTEND_SWEEP_SEEDS", 2))))
def test_frontend_sweep_mixed_classes_bit_exact(seed, packed):
    rng = np.random.default_rng(100 + seed)
    names = ("interactive", "batch", "background")
    reqs = []
    for _ in range(24):
        lo = int(rng.integers(0, 2900))
        n = int(rng.integers(8, 96))
        reqs.append((np.arange(lo, min(lo + n, 3000)),
                     names[int(rng.integers(0, 3))]))
    want = _reference([r for r, _ in reqs])

    def run(side, packed):
        S = side.S
        svc = _svc(side, packed, lambda RC: (
            RC("interactive", priority=3, coalesce=1, linger_us=0,
               max_inflight=64, queue_depth=64),
            RC("batch", priority=2, max_inflight=64, queue_depth=64),
            RC("background", priority=1, aging_s=0.01,
               max_inflight=64, queue_depth=64)))
        with svc:
            fe = S.FeatureFrontend(svc)
            tks = [fe.submit(r, klass=k, tenant=f"t{i % 3}")
                   for i, (r, k) in enumerate(reqs)]
            got = [fe.result(tk, timeout=60) for tk in tks]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        st = fe.stats()
        assert st["availability_admitted"] == 1.0
        assert sum(c["outstanding"] for c in st["classes"].values()) == 0
        assert sum(c["pending"] for c in st["classes"].values()) == 0
        assert svc.stats["latency_samples_total"] == 24
        ts = svc.throughput_stats(1.0)
        assert ts["availability"] == 1.0 and ts["pending"] == 0
        json.dumps(st, allow_nan=False)
        return st["tenants"], _counts(svc.class_stats())
    ref, port = _both(run, packed)
    assert port == ref
