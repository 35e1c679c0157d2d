"""Port parity, tiered residency: the ten tests of
``tests/test_tiered_residency.py`` run on both packages.

The ladder, bottom up: :class:`DeviceBudget`; the cold tier of a shard
plan (``demote_cold``, ``rehydrate``, ``rle_bytes``, codes read from the
runs); an executor's residency accounting (``commit=False``,
``evict_words``, ``stream_nbytes``); budgeted commits of
``ShardedFeatureExecutor(hbm_budget_bytes=...)``; and the service's tier
moves: warm shards served from the host, the monitor promoting a hot
shard and aging an idle one to cold under the budget, explicit
``demote``/``promote``, refresh with shards off the device, and a seeded
sweep of admin moves under skewed traffic; and, on the port alone, tier
flips under more client threads than cores.

Each scenario runs on ``repro`` (over its first CPU device: another test
of the process may have forced JAX to several host devices) and on
``repro_torch`` with ``devices=[torch.device("cpu")]``. Every answer must
equal the reference's host features bit for bit, and the tiers, the live
device bytes (keyed by ``id(device)`` in the reference, by the device in
the port: the values are compared), ``rle_bytes`` and the tier stats must
be equal between the packages where the reference's test asserts them.
"""
import os
import sys
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.columnar import Table as JTable
from repro.distributed import sharding as jsharding
from repro_torch.columnar import Table
from repro_torch.columnar import query as Q
from repro_torch.distributed import sharding as tsharding

CPU = torch.device("cpu")
N_SEEDS = int(os.environ.get("TIER_SWEEP_SEEDS", "2"))
TIER_STATS = ("promotions", "demotions", "rehydrations", "tier_misses",
              "tier_hot", "tier_warm", "tier_cold")

SIDES = (SimpleNamespace(name="repro", C=jcore, S=jserve, Table=JTable,
                         sharding=jsharding,
                         plan=lambda t, fs, packed=True: jcore.FeaturePlan(
                             t, fs, packed=packed),
                         devices=lambda: jax.devices()[:1]),
         SimpleNamespace(name="repro_torch", C=tcore, S=tserve, Table=Table,
                         sharding=tsharding,
                         plan=lambda t, fs, packed=True: tcore.FeaturePlan(
                             t, fs, packed=packed, device="cpu"),
                         devices=lambda: [CPU]))


def _both(run, *args):
    return [run(side, *args) for side in SIDES]


def _host(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _table(side, n=3000, imcu_rows=700, seed=0):
    rng = np.random.default_rng(seed)
    t = side.Table.from_data({
        "age": rng.integers(18, 80, n),
        "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
        "income": rng.integers(20, 200, n) * 1000,
    }, imcu_rows=imcu_rows)
    fs = (side.C.FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return t, fs


def _service(side, plan, **kw):
    return side.S.FeatureService(plan, sharded=True,
                                 devices=side.devices(), **kw)


def _sharded_ex(side, plan, **kw):
    return side.C.ShardedFeatureExecutor(plan, devices=side.devices(), **kw)


def _bytes(d: dict) -> list:
    """A device-bytes map's values (its keys differ by package)."""
    return sorted(d.values())


def _tier_stats(svc) -> dict:
    return {k: svc.stats[k] for k in TIER_STATS}


def _budget_one_stream(side, t, fs):
    """The byte budget that fits the largest single shard stream."""
    sx = _sharded_ex(side, side.plan(t, fs))
    return max(e.stream_nbytes() for e in sx.executors)


# -- DeviceBudget (test_tiered_residency.py:46) -----------------------------------
def test_device_budget_semantics():
    def run(side):
        DeviceBudget = side.sharding.DeviceBudget
        b = DeviceBudget(100)
        out = [b.fits(1, 100), b.fits(1, 101)]
        b.charge(1, 60)
        b.charge(2, 40)
        out += [b.bytes(1), b.bytes(2), b.bytes(3), b.headroom(1),
                b.fits(1, 40), b.fits(1, 41)]
        b.release(1, 20)
        out.append(b.bytes(1))
        with pytest.raises(ValueError):
            b.release(1, 41)
        b.charge(2, 70)
        out.append(b.over_budget())
        free = DeviceBudget(None)
        free.charge(1, 1 << 40)
        out += [free.fits(1, 1 << 40), free.headroom(1), free.over_budget()]
        return out
    ref, port = _both(run)
    assert port == ref == [True, False, 60, 40, 0, 40, True, False, 40,
                           {2: 10}, True, None, {}]


# -- the cold tier of a shard plan (:68) ----------------------------------------
def test_shard_plan_cold_roundtrip():
    def run(side):
        t, fs = _table(side)
        plan = side.plan(t, fs)
        shards = plan.imcu_shards()
        sp = shards[1]
        ref = sp.host_codes(np.arange(sp.n_rows))
        assert not sp.is_cold and sp.rle_bytes() == 0
        held = sp.demote_cold()
        assert sp.is_cold and held == sp.rle_bytes() > 0
        assert sp.demote_cold() == held
        cold_all = sp.host_codes(np.arange(sp.n_rows))
        rows = np.random.default_rng(3).integers(0, sp.n_rows, 200)
        cold_rows = sp.host_codes(rows)
        assert np.array_equal(cold_all, ref)
        assert np.array_equal(cold_rows, ref[:, rows])
        words = sp._shard_words(0)
        assert words.dtype == np.uint32
        sp.rehydrate()
        assert not sp.is_cold and sp.rle_bytes() == 0
        assert sp.stats["rehydrated"] >= 1
        assert np.array_equal(sp.host_codes(np.arange(sp.n_rows)), ref)
        with pytest.raises(ValueError):
            shards[-1].demote_cold()
        return (ref, cold_rows, words, held, sp.stats["rle_encoded"],
                sp.stats["rehydrated"], plan.stats["rle_encoded"])
    ref, port = _both(run)
    for r, p in zip(ref[:3], port[:3]):
        assert r.dtype == p.dtype and np.array_equal(r, p)
    assert port[3:] == ref[3:]


# -- executor residency accounting (:95) ------------------------------------------
def test_executor_residency_accounting():
    def run(side):
        t, fs = _table(side, n=1400, imcu_rows=1400)
        plan = side.plan(t, fs)
        want = plan.host_features(np.arange(64))
        ex = side.C.FeatureExecutor(plan, commit=False)
        out = [ex.resident_bytes(), ex.stream_nbytes()]
        ex.ensure_range_capacity(plan.n_rows)
        assert np.array_equal(_host(ex.batch(np.arange(64))), want)
        out += [ex.resident_bytes(), ex.stream_nbytes()]
        out.append(ex.evict_words())
        out += [ex.resident_bytes(), ex.stream_nbytes()]
        assert np.array_equal(_host(ex.batch(np.arange(64))), want)
        out.append(ex.resident_bytes())
        return want, out
    (ref_want, ref), (port_want, port) = _both(run)
    assert np.array_equal(ref_want, port_want)
    assert port == ref
    need = port[1]
    assert port[0] == 0 and need > 0 and port[2] == port[3] == need
    assert port[4] > 0 and port[5] == 0 and port[6] == need and port[7] > 0


# -- budgeted commits (:114) ------------------------------------------------------
def test_sharded_executor_budget_gates_commits():
    def run(side):
        t, fs = _table(side)
        full = _sharded_ex(side, side.plan(t, fs))
        per_shard = [e.stream_nbytes() for e in full.executors]
        sx = _sharded_ex(side, side.plan(t, fs), hbm_budget_bytes=1)
        nothing = [e.resident_bytes() for e in sx.executors]
        assert not any(nothing)
        assert all(v == 0 for v in sx.device_bytes().values())
        budget = max(per_shard)
        sx2 = _sharded_ex(side, side.plan(t, fs), hbm_budget_bytes=budget)
        resident = [e.resident_bytes() for e in sx2.executors]
        assert any(resident)
        assert all(v <= budget for v in sx2.device_bytes().values())
        assert sx2.budget_ledger().over_budget() == {}
        assert all(e.resident_bytes() > 0 for e in full.executors)
        return (per_shard, nothing, resident, _bytes(sx2.device_bytes()),
                _bytes(full.device_bytes()))
    ref, port = _both(run)
    assert port == ref


# -- service tier moves (:144-:281) -------------------------------------------------
def test_service_all_warm_serves_bitexact():
    """budget=1: nothing fits on the device, every shard is served from the
    host — misses count, availability holds, answers are bit-exact."""
    rng = np.random.default_rng(11)
    reqs = [rng.integers(0, 3000, 128) for _ in range(12)]

    def run(side):
        t, fs = _table(side)
        want = side.plan(t, fs, packed=False)
        with _service(side, side.plan(t, fs), hbm_budget_bytes=1,
                      buckets=(64,), max_replicas=0) as svc:
            tiers = svc.tiers
            tickets = [svc.submit(r) for r in reqs]
            got = [svc.result(tk, timeout=60) for tk in tickets]
            for r, g in zip(reqs, got):
                assert np.array_equal(g, want.host_features(r))
            st = svc.stats
            assert st["host_gathers"] > 0 and st["tier_misses"] > 0
            assert all(v == 0 for v in svc.device_bytes().values())
            return (got, tiers, st["promotions"], st["tier_hot"],
                    st["tier_warm"] + st["tier_cold"], svc.n_shards,
                    st["launches"])
    ref, port = _both(run)
    for r, p in zip(ref[0], port[0]):
        assert np.array_equal(r, p)
    assert port[1:] == ref[1:]
    assert port[1] == ["warm"] * 5 and port[2:] == (0, 0, 5, 5, 0)


def test_monitor_promotes_hot_and_demotes_idle():
    """One-stream budget and traffic hammering a warm shard: the monitor
    promotes it (displacing colder residents), an idle warm shard ages to
    cold, the budget holds at every drain, every answer is bit-exact."""
    def run(side):
        t, fs = _table(side)
        want = side.plan(t, fs, packed=False)
        budget = _budget_one_stream(side, t, fs)
        rng = np.random.default_rng(12)
        with _service(side, side.plan(t, fs), hbm_budget_bytes=budget + 1,
                      buckets=(64,), rebalance_every=4, cold_after=2,
                      max_replicas=0) as svc:
            tail = svc.n_shards - 1
            svc.demote(tail, "warm")
            svc.demote(1, "warm")
            base_demotions = svc.stats["demotions"]
            tail_lo = 700 * (svc.n_shards - 1)
            reqs = [np.sort(rng.integers(tail_lo, 3000, 64))
                    for _ in range(40)]
            tickets, outs = [], {}
            for i, r in enumerate(reqs):
                tickets.append(svc.submit(r))
                if i % 8 == 7:
                    outs.update(svc.drain(timeout=60))
                    assert all(v <= budget + 1
                               for v in svc.device_bytes().values())
            outs.update(svc.drain(timeout=60))
            got = [outs[tk] for tk in tickets]
            for r, g in zip(reqs, got):
                assert np.array_equal(g, want.host_features(r))
            st = dict(svc.stats)
            tiers = svc.tiers
            assert st["promotions"] >= 1, (tiers, st)
            assert st["demotions"] > base_demotions, (tiers, st)
            assert all(v <= budget + 1 for v in svc.device_bytes().values())
            assert st["tier_hot"] + st["tier_warm"] + st["tier_cold"] == \
                svc.n_shards
            assert st["tier_hot"] == tiers.count("hot")
            return got, (tiers[1], tiers[tail], base_demotions)
    ref, port = _both(run)
    for r, p in zip(ref[0], port[0]):
        assert np.array_equal(r, p)
    assert port[1] == ref[1]
    assert port[1][:2] == ("cold", "hot")


def test_explicit_demote_promote_roundtrip():
    rows = np.arange(700, 764)                   # shard 1 only

    def run(side):
        t, fs = _table(side)
        want = side.plan(t, fs, packed=False)
        base = want.host_features(rows)
        r = np.random.default_rng(13).integers(0, 3000, 300)
        with _service(side, side.plan(t, fs), buckets=(64,),
                      max_replicas=0) as svc:
            out = [svc.tiers]
            freed = svc.demote(1, "warm")
            out += [freed, svc.tiers[1], _bytes(svc.device_bytes())]
            assert np.array_equal(svc.result(svc.submit(rows), timeout=60),
                                  base)
            svc.demote(1, "cold")
            out += [svc.tiers[1], svc._sharded_ex.shards[1].rle_bytes()]
            assert np.array_equal(svc.result(svc.submit(rows), timeout=60),
                                  base)
            out += [svc.promote(1), svc.tiers[1]]
            assert np.array_equal(svc.result(svc.submit(rows), timeout=60),
                                  base)
            out.append(svc.promote(1))
            with pytest.raises(ValueError):
                svc.demote(svc.n_shards - 1, "cold")
            with pytest.raises(ValueError):
                svc.demote(0, "lukewarm")
            got = svc.result(svc.submit(r), timeout=60)
            assert np.array_equal(got, want.host_features(r))
            out += [_tier_stats(svc), _bytes(svc.device_bytes())]
            return got, out
    (ref_got, ref), (port_got, port) = _both(run)
    assert np.array_equal(ref_got, port_got)
    assert port == ref
    assert port[0] == ["hot"] * 5 and port[1] > 0
    assert port[-2]["demotions"] == 2 and port[-2]["rehydrations"] >= 1


def test_demoted_shard_serves_through_refresh():
    """Appends land in the open tail while other shards sit warm and cold;
    the demoted shards keep serving the grown table bit-exact."""
    mixed = np.array([0, 799, 800, 1999, 2000, 2001])

    def run(side):
        t, fs = _table(side, n=2000, imcu_rows=800)
        plan_p, plan_i = side.plan(t, fs), side.plan(t, fs, packed=False)
        with _service(side, plan_p, buckets=(64,), max_replicas=0) as svc:
            svc.demote(0, "cold")
            svc.demote(1, "warm")
            tiers = svc.tiers
            new = {"age": t["age"].dictionary.add_rows(np.array([150, 151])),
                   "state": t["state"].dictionary.add_rows(
                       np.array(["CA", "OR"])),
                   "income": t["income"].dictionary.add_rows(
                       np.array([40000, 60000]))}
            plan_p.refresh(new)
            plan_i.refresh(new)
            want = plan_i.host_features(mixed)
            got = [svc.result(svc.submit(mixed), timeout=60)]
            promoted = svc.promote(0)
            got.append(svc.result(svc.submit(mixed), timeout=60))
        for g in got:
            assert np.array_equal(g, want)
        return got, tiers, promoted
    (ref_got, *ref), (port_got, *port) = _both(run)
    for r, p in zip(ref_got, port_got):
        assert np.array_equal(r, p)
    assert port == ref == [["cold", "warm", "hot"], True]


def test_tiered_stats_validation():
    def run(side):
        S = side.S
        t, fs = _table(side, n=1400, imcu_rows=700)
        for kw in ({"hbm_budget_bytes": 1 << 20},
                   {"sharded": True, "hbm_budget_bytes": 1 << 20,
                    "cold_after": 0},
                   {"sharded": True, "host_gather_workers": 0}):
            with pytest.raises(ValueError):
                S.FeatureService(side.plan(t, fs), devices=side.devices(),
                                 **kw)
        with _service(side, side.plan(t, fs)) as svc:
            return sorted(svc.stats), sorted(svc.rebalance())
    ref, port = _both(run)
    assert port == ref


# -- seeded sweep (:286) ------------------------------------------------------------
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_tier_chaos_sweep(seed):
    """Random promote/demote admin moves between skewed requests: no ticket
    is dropped, every answer is bit-exact, the budget holds at every drain
    and the tier gauges add up."""
    def run(side):
        rng = np.random.default_rng(100 + seed)
        t, fs = _table(side, seed=seed)
        want = side.plan(t, fs, packed=False)
        budget = _budget_one_stream(side, t, fs)
        served = []
        with _service(side, side.plan(t, fs), hbm_budget_bytes=budget + 1,
                      buckets=(64,), rebalance_every=3, cold_after=2,
                      max_replicas=0) as svc:
            closed = [s for s in range(svc.n_shards)
                      if s != svc.n_shards - 1]
            pending: list[tuple[np.ndarray, int]] = []
            for op in range(30):
                r = np.sort(rng.integers(0, 3000, int(rng.integers(16, 128))))
                pending.append((r, svc.submit(r)))
                k = rng.integers(0, 5)
                if k == 0:
                    svc.demote(int(rng.choice(closed)),
                               "cold" if rng.integers(0, 2) else "warm")
                elif k == 1:
                    svc.promote(int(rng.integers(0, svc.n_shards)))
                if op % 10 == 9:
                    out = svc.drain(timeout=60)
                    assert {tk for _, tk in pending} <= set(out)
                    for r, tk in pending:
                        assert np.array_equal(out[tk], want.host_features(r))
                        served.append(out[tk])
                    pending.clear()
                    assert all(v <= budget + 1
                               for v in svc.device_bytes().values())
            st = svc.stats
            assert st["tier_hot"] + st["tier_warm"] + st["tier_cold"] == \
                svc.n_shards
            return served, st["failed_tickets"]
    ref, port = _both(run)
    assert len(ref[0]) == len(port[0]) == 30
    for r, p in zip(ref[0], port[0]):
        assert np.array_equal(r, p)
    assert port[1] == ref[1] == 0


def test_tier_flips_under_client_threads_stress():
    """Port only, a stress run: more client threads than cores submit and
    collect against a tiered service (a one-stream budget, the monitor
    every 3 launches, an 8-thread host-gather pool) while the main thread
    demotes and promotes shards and one more thread runs pushdown, with
    the interpreter switching threads every microsecond. No ticket may be
    lost or cross-served, every pushdown answer must equal the unsharded
    executor's (a scan that met a half-moved shard would not), and the
    tier gauges must match the labels (a lost update in the pump's or the
    pool's bookkeeping would break them)."""
    side = SIDES[1]
    t, fs = _table(side)
    want = side.plan(t, fs, packed=False)
    budget = _budget_one_stream(side, t, fs)
    pred = Q.gt("age", 40) & Q.lt("income", 120000)
    flat = tcore.FeatureExecutor(side.plan(t, fs))
    want_push = (flat.count_where(pred), flat.filtered_rows(pred),
                 flat.groupby_where("state", pred))
    n_clients = max(8, 2 * (os.cpu_count() or 1))
    errors: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _service(side, side.plan(t, fs), hbm_budget_bytes=budget + 1,
                      buckets=(64,), rebalance_every=3, cold_after=2,
                      max_replicas=0, host_gather_workers=8) as svc:
            def client(i):
                rng = np.random.default_rng(i)
                try:
                    for _ in range(6):
                        rows = rng.integers(0, 3000,
                                            int(rng.integers(1, 200)))
                        got = svc.result(svc.submit(rows), timeout=60)
                        assert np.array_equal(got, want.host_features(rows))
                except Exception as e:         # surfaced below
                    errors.append(e)

            def pusher():
                try:
                    for _ in range(6):
                        got = (svc.count_where(pred),
                               svc.filtered_rows(pred),
                               svc.groupby_where("state", pred))
                        assert got[0] == want_push[0]
                        assert np.array_equal(got[1], want_push[1])
                        for g, w in zip(got[2], want_push[2]):
                            assert np.array_equal(g, w)
                except Exception as e:         # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            threads.append(threading.Thread(target=pusher))
            for th in threads:
                th.start()
            for s, tier in ((1, "cold"), (0, "warm"), (2, "cold")):
                svc.demote(s, tier)
                svc.promote(s)
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
            assert not errors, errors
            assert svc.drain(timeout=60) == {}
            # pushdown re-puts a warm shard's words; the next monitor tick
            # settles the budget again
            svc.rebalance()
            st, tiers = svc.stats, svc.tiers
            assert st["requests"] == st["completed"] == 6 * n_clients
            assert st["failed_tickets"] == 0
            assert [st["tier_" + k] for k in ("hot", "warm", "cold")] == \
                [tiers.count(k) for k in ("hot", "warm", "cold")]
            assert all(v <= budget + 1 for v in svc.device_bytes().values())
    finally:
        sys.setswitchinterval(old)
