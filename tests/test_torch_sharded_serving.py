"""Port parity, sharded serving: the tests of ``tests/test_sharded_serving.py``
and the sharded tests of ``tests/test_feature_service.py``,
``tests/test_packed_path.py`` and ``tests/test_filtered_serving.py``, run on
both packages.

Each scenario runs once on ``repro`` (its XLA path over its one CPU device)
and once on ``repro_torch`` with ``devices=[torch.device("cpu")]`` (the
kernels' plain versions), with the same seeds. Features must be equal bit
for bit between the packages and to the host reference; shard bounds,
routing, per-shard stats, replicas and splits must be equal. Where the
reference parametrises ``use_kernel``, the mirror parametrises the serve
pool instead: one CPU device, or two equal ``torch.device("cpu")`` objects,
which are ONE device (one copy of the tables). Work whose grouping is
compared is staged while the pump is paused, so no outcome rests on host
speed.
"""
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.columnar import Table as JTable
from repro.columnar import query as JQ
from repro.columnar.column import Column as JColumn
from repro.core.pipeline import _PackedShardPlan as JShardPlan
from repro.distributed import sharding as jsharding
from repro_torch.columnar import Table
from repro_torch.columnar import query as TQ
from repro_torch.columnar.column import Column
from repro_torch.core.pipeline import _PackedShardPlan
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels.bitunpack.kernel import tpu_width

CPU = torch.device("cpu")
BITS_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16)
POOLS = pytest.mark.parametrize("pool", [1, 2], ids=["one-cpu",
                                                    "equal-cpus"])

SIDES = (SimpleNamespace(name="repro", C=jcore, S=jserve, Table=JTable,
                         Column=JColumn, Q=JQ, sharding=jsharding,
                         ShardPlan=JShardPlan,
                         plan=lambda t, fs, packed=False: jcore.FeaturePlan(
                             t, fs, packed=packed),
                         pool=lambda k: {}),
         SimpleNamespace(name="repro_torch", C=tcore, S=tserve, Table=Table,
                         Column=Column, Q=TQ, sharding=tsharding,
                         ShardPlan=_PackedShardPlan,
                         plan=lambda t, fs, packed=False: tcore.FeaturePlan(
                             t, fs, packed=packed, device="cpu"),
                         pool=lambda k: {"devices": [torch.device("cpu")
                                                     for _ in range(k)]}))


def _both(run, *args):
    """Run one scenario on the reference and on the port."""
    return [run(side, *args) for side in SIDES]


def _same(ref, port):
    """Equal outcomes: arrays bit for bit, the rest with ==."""
    if hasattr(ref, "shape") or hasattr(port, "shape"):
        ref, port = np.asarray(ref), np.asarray(port)
        assert ref.dtype == port.dtype and ref.shape == port.shape
        assert np.array_equal(ref, port)
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(port)
        for r, p in zip(ref, port):
            _same(r, p)
    elif isinstance(ref, dict):
        assert ref.keys() == port.keys()
        for k in ref:
            _same(ref[k], port[k])
    else:
        assert ref == port


def _host(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _column_data(rng, bits, n):
    """Integer column whose dictionary needs exactly ``bits`` bits."""
    k = 2 if bits == 1 else (1 << (bits - 1)) + 1
    return np.concatenate([np.arange(k), rng.integers(0, k, n - k)])


def _mixed(side, n=3000, imcu_rows=700, seed=0):
    rng = np.random.default_rng(seed)
    t = side.Table.from_data({
        "age": rng.integers(18, 80, n),
        "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
        "income": rng.integers(20, 200, n) * 1000,
    }, imcu_rows=imcu_rows)
    fs = (side.C.FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return t, fs


def _sharded_ex(side, plan, pool=1):
    return side.C.ShardedFeatureExecutor(plan, **side.pool(pool))


def _service(side, plan, pool=1, **kw):
    return side.S.FeatureService(plan, sharded=True, **side.pool(pool), **kw)


def _append(t, rows):
    """Dictionary appends for the mixed table's three columns."""
    return {"age": t["age"].dictionary.add_rows(np.asarray(rows["age"])),
            "state": t["state"].dictionary.add_rows(
                np.asarray(rows["state"])),
            "income": t["income"].dictionary.add_rows(
                np.asarray(rows["income"]))}


def _shard_picture(sx):
    """Bounds, routing starts, replica counts and the per-shard stream
    counters both packages keep (the reference also counts puts of its
    per-column tables, which the port's direct gather has no need of)."""
    return ([sp.shard_bounds for sp in sx.shards], list(sx.starts),
            [len(r) for r in sx.replicas],
            [(st["words_put"], st["words_repacked"])
             for st in sx.plan.stats["per_shard"]])


# -- packed shard plans (the host-side half) ----------------------------------------
def test_packed_imcu_shards_structure_and_seam_repack():
    """Aligned boundaries slice zero-copy, unaligned seams repack only the
    shard's rows, the fused tables stay shared; shard codes equal the
    parent's windows, on both packages."""
    def run(side):
        rng = np.random.default_rng(1)
        t = side.Table.from_data({"a": rng.integers(0, 100, 1024),
                                  "b": rng.integers(0, 3, 1024)},
                                 imcu_rows=256)
        fs = side.C.FeatureSet().add("a", "zscore").add("b", "onehot")
        plan = side.plan(t, fs, True)
        shards = plan.imcu_shards()
        assert len(shards) == 4 and all(isinstance(s, side.ShardPlan)
                                        for s in shards)
        w = shards[1]._shard_words(0)
        assert w.base is plan.packed_words[0] or \
            w.base is plan.packed_words[0].base
        assert shards[0].fused_tables() is plan.fused_tables()
        t2, fs2 = _mixed(side)
        plan2 = side.plan(t2, fs2, True)
        sh2 = plan2.imcu_shards()
        words = sh2[1].packed_words
        return (plan.stats["words_repacked"], w,
                shards[2].host_codes(np.arange(0, 256)),
                plan.host_codes(np.arange(512, 768)), words,
                sh2[1].stats["words_repacked"],
                sh2[1].host_codes(np.arange(0, 700)),
                plan2.host_codes(np.arange(700, 1400)))
    ref, port = _both(run)
    _same(ref, port)
    assert port[0] == 0 and port[5] >= 1
    _same(port[2], port[3])
    _same(port[6], port[7])


def test_shard_stats_attributed_and_rolled_up():
    def run(side):
        t, fs = _mixed(side, n=2048, imcu_rows=1024)
        plan = side.plan(t, fs, True)
        base = plan.stats["words_put"]
        shx = _sharded_ex(side, plan)
        per_shard = plan.stats["per_shard"]
        assert [s.stats for s in shx.shards] == per_shard
        plan_i = side.plan(t, fs)
        shards_i = plan_i.imcu_shards()
        return ([s["words_put"] for s in per_shard],
                plan.stats["words_put"] - base,
                [dict(s.stats)["words_put"] for s in shards_i])
    ref, port = _both(run)
    assert ref == port == ([1, 1], 2, [0, 0])


# -- routed executor -----------------------------------------------------------------
@POOLS
def test_sharded_executor_bit_exact_across_bits(pool):
    """Sharded == unsharded for aligned ranges and arbitrary rows at every
    storage width 1-16, rows straddling shard boundaries."""
    def run(side, pool):
        rng = np.random.default_rng(7)
        n = 33024
        data = {f"c{b}": _column_data(rng, b, n) for b in BITS_SWEEP}
        table = side.Table.from_data(data, imcu_rows=8256)
        fs = side.C.FeatureSet()
        for b in BITS_SWEEP:
            fs = fs.add(f"c{b}", "zscore")
        plan_p = side.plan(table, fs, True)
        assert [tpu_width(b) for b in BITS_SWEEP] == plan_p.device_bits
        ex_i = side.C.FeatureExecutor(side.plan(table, fs))
        shx = _sharded_ex(side, plan_p, pool)
        assert shx.n_shards == 4
        out = []
        for start, m in ((0, 128), (8256 - 64, 128), (8256 * 2 - 32, 96)):
            idx = np.arange(start, start + m)
            got = _host(shx.batch(idx))
            assert np.array_equal(got, _host(ex_i.batch(idx)))
            out.append(got)
        bounds = np.array([8256, 8256 * 2, 8256 * 3])
        rows = np.concatenate([bounds - 1, bounds, bounds + 1,
                               rng.integers(0, n, 300)])
        got = _host(shx.batch(rows))
        assert np.array_equal(got, _host(ex_i.batch(rows)))
        assert np.array_equal(got, plan_p.host_features(rows))
        return out + [got]
    _same(*_both(run, pool))


def test_sharded_executor_routing_and_error_contract():
    def run(side):
        t, fs = _mixed(side)
        shx = _sharded_ex(side, side.plan(t, fs, True))
        [(s, local, dest)] = shx.route(np.arange(1400, 1450))
        pieces = shx.route(np.array([2999, 0, 700]))
        with pytest.raises(IndexError):
            shx.batch(np.array([3000]))
        empty = tuple(shx.batch(np.array([], np.int64)).shape)
        with pytest.raises(ValueError):
            side.C.ShardedFeatureExecutor(side.plan(t, fs))
        return (shx.n_shards, s, local, dest, [p[0] for p in pieces],
                [p[1] for p in pieces], [p[2] for p in pieces],
                shx.shard_of(np.array([0, 699, 700, 2999])), empty)
    ref, port = _both(run)
    _same(ref, port)
    assert port[:2] == (5, 2) and port[3] is None
    assert port[4] == [0, 1, 4] and port[8] == (0, 6)


def test_sharded_executor_serves_refresh_appends_in_last_shard():
    def run(side):
        rng = np.random.default_rng(3)
        t, fs = _mixed(side, n=2048, imcu_rows=512)
        plan_p = side.plan(t, fs, True)
        shx = _sharded_ex(side, plan_p)
        _host(shx.batch(np.arange(2048 - 64, 2048)))
        plan_p.refresh(_append(t, {
            "age": rng.integers(18, 80, 40),
            "state": np.array(["CA", "NY"] * 20),
            "income": rng.integers(20, 200, 40) * 1000}))
        rows = np.concatenate([np.arange(2040, 2088),
                               rng.integers(0, 2088, 200)])
        got = _host(shx.batch(rows))
        assert np.array_equal(got, plan_p.host_features(rows))
        return shx.shards[-1].n_rows, got, _shard_picture(shx)
    ref, port = _both(run)
    _same(ref, port)
    assert port[0] == 512 + 40


def test_append_resyncs_only_last_shard_stream():
    """An append re-puts the open tail's stream only, and executors on one
    device share ONE placed table set."""
    def run(side):
        t, fs = _mixed(side, n=2048, imcu_rows=512)
        plan_p = side.plan(t, fs, True)
        shx = _sharded_ex(side, plan_p)
        all_rows = np.arange(0, 2048, 7)
        _host(shx.batch(all_rows))
        puts0 = [s.stats["words_put"] for s in shx.shards]
        plan_p.refresh(_append(t, {"age": [77], "state": ["CA"],
                                   "income": [50000]}))
        rows = np.concatenate([all_rows, [2048]])
        got = _host(shx.batch(rows))
        assert np.array_equal(got, plan_p.host_features(rows))
        puts1 = [s.stats["words_put"] for s in shx.shards]
        if len(set(map(id, shx.devices))) == 1:
            # one device (the reference spreads shards over every JAX
            # device when a test run has forced several)
            assert shx.executors[0]._tcache is shx.executors[1]._tcache
        return got, puts0, puts1
    ref, port = _both(run)
    _same(ref, port)
    _, puts0, puts1 = port
    assert puts1[-1] == puts0[-1] + 1 and puts1[:-1] == puts0[:-1]


def test_equal_devices_hold_one_table_copy():
    """Keying by the device itself: a pool of two equal
    ``torch.device("cpu")`` objects is ONE device — one table cache, one
    load entry, every shard reading the same placed tables."""
    t, fs = _mixed(SIDES[1], n=2048, imcu_rows=512)
    plan = SIDES[1].plan(t, fs, True)
    shx = tcore.ShardedFeatureExecutor(
        plan, devices=[torch.device("cpu"), torch.device("cpu")])
    assert shx.device_pool == [CPU, CPU]
    assert len(shx._caches) == 1
    placed = {id(ex._device_fused()) for ex in shx.executors}
    assert len(placed) == 1 and plan.stats["fused_rebuilds"] == 1
    assert shx.device_load() == {CPU: 4}
    assert shx.device_bytes() == {CPU: sum(ex.resident_bytes()
                                           for ex in shx.executors)}
    shx.add_replica(0)
    assert len(shx._caches) == 1 and shx.device_load() == {CPU: 5}
    assert len({id(ex._device_fused()) for ex in
                shx.stream_executors(0)}) == 1


def test_pool_naming_another_card_is_refused():
    """The launchers take cuda:0 only: a pool naming another card is
    refused before anything is put there (no CUDA is touched to say so)."""
    t, fs = _mixed(SIDES[1], n=1400)
    plan = SIDES[1].plan(t, fs, True)
    with pytest.raises(ValueError, match="cuda:0 only"):
        tcore.ShardedFeatureExecutor(plan,
                                     devices=[torch.device("cuda:1")])
    with pytest.raises(ValueError, match="cuda:0 only"):
        tserve.FeatureService(plan, sharded=True,
                              devices=[CPU, torch.device("cuda", 1)])
    with pytest.raises(ValueError):
        tcore.ShardedFeatureExecutor(plan, devices=[])


def test_serve_mesh_and_devices_rules():
    """Round-robin placement, the replica rule's least-loaded choice and
    its cornered fallback, on both packages (the port keys by the device,
    the reference by ``id``)."""
    def run(side):
        sh = side.sharding
        pool = [object(), object()]
        devs = sh.serve_devices(5, pool)
        with pytest.raises(ValueError):
            sh.serve_devices(0, pool)
        a, b, c = object(), object(), object()
        key = (lambda d: d) if side.name == "repro_torch" else id
        picks = [sh.replica_device([a, b, c], {}),
                 sh.replica_device([a, b, c], {key(a): 2, key(b): 1,
                                               key(c): 3}),
                 sh.replica_device([a, b, c], {key(a): 1, key(b): 1},
                                   exclude={key(c)}),
                 sh.replica_device([a, b, c], {key(a): 2, key(b): 1,
                                               key(c): 3},
                                   exclude={key(a), key(b), key(c)})]
        with pytest.raises(ValueError):
            sh.replica_device([], {})
        return ([pool.index(d) for d in devs],
                [[a, b, c].index(p) for p in picks])
    ref, port = _both(run)
    assert ref == port == ([0, 1, 0, 1, 0], [0, 1, 0, 1])
    assert tsharding.serve_mesh(["cpu", torch.device("cuda")]) == \
        [CPU, torch.device("cuda", 0)]


# -- sharded FeatureService ----------------------------------------------------------
@POOLS
def test_sharded_service_matches_pipeline(pool):
    def run(side, pool):
        t, fs = _mixed(side)
        plan = side.plan(t, fs, True)
        rng = np.random.default_rng(5)
        reqs = [np.arange(0, 256), np.arange(672, 736),
                rng.integers(0, 3000, 400),
                np.array([699, 700, 1399, 1400, 2099, 2100]),
                np.arange(2980, 3000)]
        with _service(side, plan, pool, buckets=(64, 256)) as svc:
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tickets]
            st = {k: svc.stats[k] for k in
                  ("split_requests", "launches", "batches", "bytes_h2d",
                   "padded_rows", "packed_ranges", "shard_launches",
                   "shard_batches", "shard_bytes_h2d")}
            n_shards = svc.n_shards
        for r, g in zip(reqs, got):
            assert np.array_equal(g, plan.host_features(r))
        return n_shards, got, st
    ref, port = _both(run, pool)
    _same(ref, port)
    n_shards, _, st = port
    assert n_shards == 5 and st["split_requests"] >= 3
    assert sum(st["shard_launches"]) == st["launches"] > 0
    assert sum(st["shard_bytes_h2d"]) == st["bytes_h2d"]
    assert sum(1 for x in st["shard_launches"] if x) >= 4


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "int32"])
def test_sharded_service_serves_refresh_appends(packed):
    """Rows appended after the plan was built serve from the open tail
    shard (packed) or the plan's code tail (int32 host routing)."""
    def run(side, packed):
        t, fs = _mixed(side, n=2000, imcu_rows=800)
        plan = side.plan(t, fs, packed)
        with _service(side, plan, buckets=(64,)) as svc:
            first = svc.result(svc.submit(np.arange(64)), timeout=60)
            plan.refresh(_append(t, {"age": [150, 151],
                                     "state": ["CA", "OR"],
                                     "income": [40000, 60000]}))
            mixed = np.array([0, 799, 800, 1999, 2000, 2001])
            got = svc.result(svc.submit(mixed), timeout=60)
            n_shards = svc.n_shards
        assert np.array_equal(got, plan.host_features(mixed))
        return n_shards, first, got
    ref, port = _both(run, packed)
    _same(ref, port)
    assert port[0] == (3 if packed else 1)


def test_sharded_service_concurrent_shard_pumps():
    """Whole-shard requests land on their own queues; drain collects them
    all and every per-shard window respects prefetch."""
    def run(side):
        t, fs = _mixed(side, n=4096, imcu_rows=1024)
        plan = side.plan(t, fs, True)
        rng = np.random.default_rng(8)
        with _service(side, plan, prefetch=2, buckets=(64,)) as svc:
            reqs = [np.arange(s, s + 64)
                    for s in rng.integers(0, 4096 - 64, 40)]
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            out = svc.drain(timeout=60)
            assert set(out) == set(tickets)
            assert svc.stats["max_inflight"] <= 2 * svc.n_shards
            st = (svc.stats["launches"], svc.stats["shard_launches"],
                  svc.stats["split_requests"], svc.stats["packed_ranges"])
        for r, tk in zip(reqs, tickets):
            assert np.array_equal(out[tk], plan.host_features(r))
        return [out[tk] for tk in tickets], st
    _same(*_both(run))


def test_linger_coalesces_partial_groups():
    """A generous linger holds partial groups open until the burst is in:
    four 128-row ranges serve in ONE launch."""
    def run(side):
        rng = np.random.default_rng(9)
        t = side.Table.from_data({"a": rng.integers(0, 100, 4096)})
        plan = side.plan(t, side.C.FeatureSet().add("a", "zscore"), True)
        with side.S.FeatureService(plan, buckets=(128,), coalesce=4,
                                   linger_us=2_000_000) as svc:
            starts = [0, 512, 1024, 2048]
            tickets = [svc.submit(np.arange(s, s + 128)) for s in starts]
            out = [svc.result(tk, timeout=60) for tk in tickets]
            launches = svc.stats["launches"]
        for s, got in zip(starts, out):
            assert np.array_equal(got,
                                  plan.host_features(np.arange(s, s + 128)))
        return out, launches
    ref, port = _both(run)
    _same(ref, port)
    assert port[1] == 1


def test_linger_latency_is_bounded():
    """A lone request completes within about its linger; a full group
    launches at once even under a 10 s linger."""
    def run(side):
        rng = np.random.default_rng(10)
        t = side.Table.from_data({"a": rng.integers(0, 100, 1024)})
        fs = side.C.FeatureSet().add("a", "zscore")
        with side.S.FeatureService(side.plan(t, fs, True), buckets=(64,),
                                   coalesce=4, linger_us=50_000) as svc:
            t0 = time.perf_counter()
            got = svc.result(svc.submit(np.arange(64)), timeout=30)
            assert time.perf_counter() - t0 < 20.0
            one = svc.stats["launches"]
        with side.S.FeatureService(side.plan(t, fs, True), buckets=(64,),
                                   coalesce=2,
                                   linger_us=10_000_000) as svc:
            svc.pause()
            a = svc.submit(np.arange(64))
            b = svc.submit(np.arange(64, 128))
            svc.resume()
            t0 = time.perf_counter()
            pair = (svc.result(a, timeout=30), svc.result(b, timeout=30))
            assert time.perf_counter() - t0 < 5.0
            two = svc.stats["launches"]
        return got, one, pair, two
    ref, port = _both(run)
    _same(ref, port)
    assert port[0].shape == (64, 1) and port[1] == port[3] == 1


def test_linger_rejects_negative():
    for side in SIDES:
        t = side.Table.from_data({"a": np.arange(64)})
        with pytest.raises(ValueError):
            side.S.FeatureService(side.plan(
                t, side.C.FeatureSet().add("a", "zscore"), True),
                linger_us=-1)


# -- adaptive shard management -------------------------------------------------------
def test_chaos_clients_race_live_rebalance():
    """Client threads submit/poll/result while replicas come and go and
    the tail splits: no ticket is lost, every result is bit-exact, and the
    shard set ends the same on both packages. The shard-set mutations are
    staged between bursts the clients submit while the pump is paused, so
    what each burst is served by does not rest on host speed."""
    def run(side):
        t, fs = _mixed(side, n=8192, imcu_rows=2048)
        plan = side.plan(t, fs, True)
        errors: list = []
        served: dict = {}
        results: dict = {}
        with _service(side, plan, buckets=(64, 256), coalesce=4) as svc:
            def client(seed, burst):
                rng = np.random.default_rng(seed * 100 + burst)
                try:
                    for i in range(4):
                        rows = rng.integers(0, 8192,
                                            int(rng.integers(8, 300)))
                        served[(seed, burst, i)] = (rows, svc.submit(rows))
                except Exception as e:         # surfaced below
                    errors.append(e)

            rng = np.random.default_rng(99)
            cuts = iter((7168, 7680, 7936))
            for burst in range(9):
                svc.pause()
                threads = [threading.Thread(target=client, args=(s, burst))
                           for s in range(3)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=30)
                kind = burst % 3
                if kind == 0:
                    svc.add_replica(int(rng.integers(0, svc.n_shards)))
                elif kind == 1:
                    cut = next(cuts, None)
                    if cut is not None:
                        svc.split_tail(cut)
                else:
                    cands = [s for s in range(svc.n_shards)
                             if svc.replicas[s]]
                    if cands:
                        svc.drop_replica(int(rng.choice(cands)))
                svc.resume()
                for key in sorted(k for k in served if k[1] == burst):
                    rows, tk = served[key]
                    if key[2] % 3 == 0:
                        deadline = time.perf_counter() + 30
                        while not svc.poll(tk):
                            assert time.perf_counter() < deadline
                            time.sleep(0)
                    got = svc.result(tk, timeout=60)
                    assert np.array_equal(got, plan.host_features(rows))
                    results[key] = got
            leftovers = svc.drain(timeout=60)
            assert not errors, errors
            assert not svc._chunks_total and not leftovers
            assert sum(svc.stats["shard_launches"]) == svc.stats["launches"]
            return (svc.n_shards, svc.shard_starts, svc.replicas,
                    [results[k] for k in sorted(results)],
                    {k: svc.stats[k] for k in
                     ("shard_splits", "replicas_added", "replicas_dropped",
                      "requests", "split_requests")})
    ref, port = _both(run)
    _same(ref, port)
    assert port[0] >= 7


def test_drain_during_migration_force_flushes():
    """drain() while a split lands under a 30 s linger flushes the
    re-routed chunks at once and loses nothing; the straddling chunk's
    re-split restates ``padded_rows`` and ``packed_ranges``."""
    def run(side):
        t, fs = _mixed(side, n=4096, imcu_rows=1024)
        plan = side.plan(t, fs, True)
        with _service(side, plan, buckets=(64,), coalesce=8,
                      linger_us=30_000_000) as svc:
            reqs = [np.arange(3072, 3136), np.arange(3800, 3864),
                    np.arange(4000, 4064)]
            tickets = [svc.submit(r) for r in reqs]
            svc.split_tail(3840)
            t0 = time.perf_counter()
            out = svc.drain(timeout=60)
            assert time.perf_counter() - t0 < 10.0
            assert set(out) == set(tickets)
            st = {k: svc.stats[k] for k in ("padded_rows", "packed_ranges",
                                            "launches", "shard_launches")}
        for r, tk in zip(reqs, tickets):
            assert np.array_equal(out[tk], plan.host_features(r))
        return [out[tk] for tk in tickets], st
    ref, port = _both(run)
    _same(ref, port)
    assert port[1]["padded_rows"] == 64 and port[1]["packed_ranges"] == 3


def test_pause_rebalance_resume_bit_exact():
    """pause -> rebalance() (the monitor splits the over-budget tail AND
    replicates the heated shard) -> resume: chunks queued across the swap,
    one straddling the new cut, serve bit-exact."""
    def run(side):
        t, fs = _mixed(side, n=5000, imcu_rows=2048)
        plan = side.plan(t, fs, True)
        rng = np.random.default_rng(12)
        with _service(side, plan, buckets=(64,), coalesce=2,
                      row_budget=512, hot_factor=2.0,
                      max_replicas=2) as svc:
            for _ in range(6):
                svc.result(svc.submit(rng.integers(0, 2048, 64)),
                           timeout=60)
            svc.pause()
            reqs = [np.arange(4544, 4672), rng.integers(0, 5000, 200),
                    np.arange(4096, 5000)]
            tickets = [svc.submit(r) for r in reqs]
            actions = svc.rebalance()
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tickets]
            st = (svc.stats["shard_splits"], svc.stats["replicas_added"],
                  svc.replicas, svc.shard_starts)
        for r, g in zip(reqs, got):
            assert np.array_equal(g, plan.host_features(r))
        return actions["split"], actions["replicated"][0][0], got, st
    ref, port = _both(run)
    _same(ref, port)
    assert port[0] == [(2, 3, 4608)] and port[1] == 0
    assert port[3][:2] == (1, 1)


def test_auto_monitor_replicates_and_splits():
    """The pump-driven monitor (``rebalance_every``) sees the skew in the
    per-shard stats and replicates the hot shard; the row budget splits
    the oversized tail — mid-traffic, bit-exact."""
    def run(side):
        t, fs = _mixed(side, n=5000, imcu_rows=2048)
        plan = side.plan(t, fs, True)
        rng = np.random.default_rng(13)
        with _service(side, plan, buckets=(64,), coalesce=2,
                      rebalance_every=4, row_budget=512, hot_factor=2.0,
                      max_replicas=2) as svc:
            reqs = [rng.integers(0, 2048, 64) for _ in range(30)]
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            out = svc.drain(timeout=60)
            for r, tk in zip(reqs, tickets):
                assert np.array_equal(out[tk], plan.host_features(r))
            mixed = np.concatenate([np.arange(4544, 4672),
                                    rng.integers(0, 5000, 300)])
            got = svc.result(svc.submit(mixed), timeout=60)
            assert np.array_equal(got, plan.host_features(mixed))
            return ([out[tk] for tk in tickets], got,
                    {k: svc.stats[k] for k in
                     ("rebalances", "replicas_added", "shard_splits",
                      "replicas_dropped", "launches")},
                    svc.replicas, svc.shard_starts)
    ref, port = _both(run)
    _same(ref, port)
    st, replicas = port[2], port[3]
    assert st["rebalances"] >= 1 and st["replicas_added"] >= 1
    assert replicas[0] and st["shard_splits"] >= 1


def test_auto_monitor_default_hot_factor_reachable():
    """The hot test compares with the mean of the OTHER shards, so the
    default hot_factor (4.0) triggers on 4 shards under pure skew."""
    def run(side):
        t, fs = _mixed(side, n=4096, imcu_rows=1024)
        rng = np.random.default_rng(14)
        with _service(side, side.plan(t, fs, True), buckets=(64,),
                      coalesce=2, rebalance_every=4, max_replicas=1) as svc:
            assert svc.n_shards == 4 and svc.hot_factor == 4.0
            svc.pause()
            for _ in range(24):
                svc.submit(rng.integers(0, 1024, 64))
            svc.resume()
            svc.drain(timeout=60)
            return svc.stats["replicas_added"], svc.replicas
    ref, port = _both(run)
    assert ref == port and port[0] >= 1 and port[1][0] == 1


def test_manual_add_replica_respects_configured_cap():
    def run(side):
        t, fs = _mixed(side, n=2048, imcu_rows=1024)
        with _service(side, side.plan(t, fs, True), max_replicas=1) as svc:
            svc.add_replica(0)
            with pytest.raises(ValueError):
                svc.add_replica(0)
            capped = svc.replicas
        with _service(side, side.plan(t, fs, True)) as svc:
            svc.add_replica(1)
            svc.add_replica(1)
            free = svc.replicas
        return capped, free
    ref, port = _both(run)
    assert ref == port == ([1, 0], [0, 2])


def test_split_tail_default_cut_clamps_on_short_tail():
    def run(side):
        t, fs = _mixed(side, n=2048 + 20, imcu_rows=1024)
        sx = _sharded_ex(side, side.plan(t, fs, True))
        tail = sx.tail_rows()
        new = sx.split_tail()
        rows = np.arange(2040, 2068)
        got = _host(sx.batch(rows))
        assert np.array_equal(got, sx.plan.host_features(rows))
        return tail, new, sx.shards[new].n_rows, got, _shard_picture(sx)
    ref, port = _both(run)
    _same(ref, port)
    assert port[:3] == (20, 3, 0)


def test_adaptive_args_validation():
    def run(side):
        t, fs = _mixed(side, n=1400, imcu_rows=700)
        plan_i = side.plan(t, fs)
        with pytest.raises(ValueError):
            side.S.FeatureService(plan_i, rebalance_every=4)
        with pytest.raises(ValueError):
            _service(side, side.plan(t, fs, True), row_budget=16)
        with pytest.raises(ValueError):
            _service(side, side.plan(t, fs, True), hot_factor=0.5)
        with side.S.FeatureService(plan_i) as svc:
            with pytest.raises(RuntimeError):
                svc.add_replica(0)
            with pytest.raises(RuntimeError):
                svc.split_tail()
            return svc.rebalance(), svc.n_shards, svc.replicas, \
                svc.shard_starts
    ref, port = _both(run)
    assert port[0] == ref[0] == {
        "split": [], "replicated": [], "dropped": [],
        "failover_replicated": [], "rebuilt": [], "demoted": [],
        "promoted": []}
    assert ref[1:] == port[1:] == (1, [0], [0])
    t, fs = _mixed(SIDES[1], n=1400, imcu_rows=700)
    plan = SIDES[1].plan(t, fs, True)
    for out_of_scope in ("use_kernel",):
        with pytest.raises(TypeError):
            tserve.FeatureService(plan, sharded=True, **{out_of_scope: 1})


def test_sharded_service_serves_widened_plan_after_refresh():
    """A refresh that GROWS a dictionary (onehot widens, out_dim grows)
    keeps the pump serving multi-chunk, multi-shard requests."""
    def run(side):
        rng = np.random.default_rng(30)
        t, fs = _mixed(side, n=2048, imcu_rows=512)
        plan = side.plan(t, fs, True)
        with _service(side, plan, buckets=(64,)) as svc:
            first = svc.result(svc.submit(np.arange(64)), timeout=60)
            plan.refresh(_append(t, {"age": [150], "state": ["TX"],
                                     "income": [12345]}))
            assert plan.out_dim > 6
            rows = rng.integers(0, plan.n_rows, 400)
            got = svc.result(svc.submit(rows), timeout=60)
        assert np.array_equal(got, plan.host_features(rows))
        return first, got, plan.out_dim
    _same(*_both(run))


# -- sharded tests of test_feature_service.py / test_packed_path.py ------------------
def _toy(side, n, imcu_rows):
    rng = np.random.default_rng(0)
    t = side.Table.from_data({
        "age": rng.integers(18, 80, size=n),
        "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
        "income": rng.integers(20, 200, size=n) * 1000}, imcu_rows=imcu_rows)
    fs = (side.C.FeatureSet().add("age", "zscore")
          .add("age", "bucketize", boundaries=(30.0, 50.0, 65.0))
          .add("state", "onehot").add("income", "minmax"))
    return t, fs


def test_service_sharded_routing():
    """int32 sharding routes host code slices per IMCU partition."""
    def run(side):
        t, fs = _toy(side, 3000, 700)
        assert t["age"].n_imcus == 5
        plan = side.plan(t, fs)
        rng = np.random.default_rng(4)
        rows = rng.integers(0, 3000, 900)
        with _service(side, plan) as svc:
            got = svc.result(svc.submit(rows), timeout=60)
            st = (svc.n_shards, svc.stats["launches"],
                  svc.stats["bytes_h2d"])
        assert np.array_equal(got, plan.host_features(rows))
        return got, st
    _same(*_both(run))


def test_sharded_service_serves_rows_appended_after_refresh():
    def run(side):
        t, fs = _toy(side, 2000, 800)
        plan = side.plan(t, fs)
        with _service(side, plan) as svc:
            svc.result(svc.submit(np.arange(64)), timeout=60)
            plan.refresh(_append(t, {"age": [150, 151],
                                     "state": ["CA", "OR"],
                                     "income": [40000, 60000]}))
            mixed = np.array([0, 799, 800, 1999, 2000, 2001])
            got = svc.result(svc.submit(mixed), timeout=60)
        assert np.array_equal(got, plan.host_features(mixed))
        return got
    _same(*_both(run))


def test_shard_fused_tables_shared_and_refresh_invalidates_all_views():
    def run(side):
        t, fs = _toy(side, 1600, 800)
        plan = side.plan(t, fs)
        shards = plan.imcu_shards()
        f0 = shards[0].fused_tables()
        assert shards[1].fused_tables() is f0 and plan.fused_tables() is f0
        rebuilds = plan.stats["fused_rebuilds"]
        t["age"].dictionary.add_rows(np.array([150]))
        assert plan.refresh() >= 1
        f1 = shards[1].fused_tables()
        assert f1 is not f0
        assert shards[0].fused_tables() is f1 and plan.fused_tables() is f1
        return rebuilds, plan.stats["fused_rebuilds"]
    ref, port = _both(run)
    assert ref == port == (1, 2)


def test_packed_sharding_supported_but_no_codes_matrix():
    def run(side):
        rng = np.random.default_rng(10)
        t = side.Table.from_data({"a": rng.integers(0, 10, 256)},
                                 imcu_rows=128)
        plan = side.plan(t, side.C.FeatureSet().add("a", "zscore"), True)
        shards = plan.imcu_shards()
        with pytest.raises(RuntimeError):
            plan.codes_matrix
        with pytest.raises(RuntimeError):
            shards[0].codes_matrix
        with pytest.raises(RuntimeError):
            shards[0].refresh()
        with _service(side, plan, buckets=(64,)) as svc:
            rows = rng.integers(0, 256, 100)
            got = svc.result(svc.submit(rows), timeout=60)
            n_shards = svc.n_shards
        assert np.array_equal(got, plan.host_features(rows))
        return [s.n_rows for s in shards], n_shards, got
    ref, port = _both(run)
    _same(ref, port)
    assert port[:2] == ([128, 128], 2)


# -- sharded pushdown (test_filtered_serving.py) --------------------------------------
def _filtered(side, n=4000, imcu_rows=700):
    rng = np.random.default_rng(0)
    cols = dict(age=rng.integers(18, 91, n), state=rng.integers(0, 51, n),
                income=np.round(rng.lognormal(10, 1, n), -2),
                device=rng.integers(0, 5, n))
    t = side.Table({c: side.Column.from_data(v, c, imcu_rows=imcu_rows)
                    for c, v in cols.items()})
    fs = (side.C.FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax").add("income", "log")
          .add("device", "onehot"))
    pred = side.Q.isin("state", [3, 7, 11]) & side.Q.gt("age", 60)
    mask = np.isin(cols["state"], [3, 7, 11]) & (cols["age"] > 60)
    return t, fs, cols, pred, mask


def test_sharded_pushdown_serves_matches_locally():
    def run(side):
        t, fs, cols, pred, exp = _filtered(side)
        plan = side.plan(t, fs, True)
        sx = _sharded_ex(side, plan)
        assert sx.n_shards > 1
        rows, feats = sx.batch_where(pred)
        assert np.array_equal(rows, np.flatnonzero(exp))
        assert np.array_equal(_host(feats), plan.host_features(rows))
        vals, counts = sx.groupby_where("device", pred)
        assert np.array_equal(
            counts, np.bincount(t["device"].codes()[exp], minlength=5))
        return (sx.count_where(pred), sx.filtered_rows(pred), rows,
                _host(feats), vals, counts,
                sx.agg_where(pred, "age", "mean"),
                sx.agg_where(pred, "income", "sum"))
    ref, port = _both(run)
    _same(ref, port)
    _, _, cols, _, exp = _filtered(SIDES[1])
    assert port[0] == int(exp.sum())
    assert np.isclose(port[6], cols["age"][exp].mean())


@pytest.mark.parametrize("sharded", [False, True])
def test_service_filtered_submit(sharded):
    def run(side, sharded):
        t, fs, cols, pred, exp = _filtered(side)
        plan = side.plan(t, fs, True)
        exp_rows = np.flatnonzero(exp)
        with side.S.FeatureService(plan, sharded=sharded,
                                   **(side.pool(1) if sharded else {})) \
                as svc:
            ref = svc.result(svc.submit(exp_rows), timeout=60)
            out = svc.result(svc.submit(where=pred), timeout=60)
            assert np.array_equal(out, ref)
            _, counts = svc.groupby_where("device", pred)
            return (out, svc.stats["filtered_requests"],
                    svc.count_where(pred), svc.filtered_rows(pred), counts,
                    svc.agg_where(pred, "age", "mean"), svc.n_shards)
    ref, port = _both(run, sharded)
    _same(ref, port)
    assert port[1] == 1 and port[6] == (6 if sharded else 1)


def test_executor_commit_evict_and_stream_bytes():
    """``commit=False`` defers the word-stream put to the first launch;
    ``stream_nbytes`` gives a full commit's bytes either way;
    ``evict_words`` frees the stream and the next launch re-puts it — the
    same on both packages, bit for bit."""
    def run(side):
        t, fs = _mixed(side, n=2048, imcu_rows=512)
        plan = side.plan(t, fs, True)
        ex = side.C.FeatureExecutor(plan, commit=False)
        deferred = (ex.resident_bytes(), ex.stream_nbytes(),
                    plan.stats["words_put"])
        rows = np.arange(100, 300)
        first = _host(ex.batch(rows))
        held = ex.resident_bytes()
        freed = ex.evict_words()
        again = _host(ex.batch(rows))
        assert np.array_equal(first, plan.host_features(rows))
        return (deferred, held, freed, ex.resident_bytes(),
                plan.stats["words_put"], first, again)
    ref, port = _both(run)
    _same(ref, port)
    (resident, nbytes, puts), held, freed, after, puts2 = port[:5]
    assert resident == 0 and puts == 0 and nbytes == held == freed
    assert after == held and puts2 == 2


def test_sharded_service_stress_clients_and_mutations():
    """Port only, a stress run: more client threads than cores submit and
    collect against a sharded service while the main thread adds and
    drops replicas and splits the tail, with the interpreter switching
    threads every microsecond. No ticket may be lost or cross-served, and
    the per-shard counters must add up to the totals (a lost update in
    the pump's bookkeeping would break them)."""
    t, fs = _mixed(SIDES[1], n=8192, imcu_rows=2048)
    plan = SIDES[1].plan(t, fs, True)
    n_clients = max(8, 2 * (os.cpu_count() or 1))
    errors: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tserve.FeatureService(plan, sharded=True, devices=[CPU],
                                   buckets=(64, 256), coalesce=4,
                                   linger_us=100.0) as svc:
            def client(seed):
                rng = np.random.default_rng(seed)
                try:
                    for _ in range(6):
                        rows = rng.integers(0, 8192,
                                            int(rng.integers(1, 300)))
                        got = svc.result(svc.submit(rows), timeout=60)
                        assert np.array_equal(got,
                                              plan.host_features(rows))
                except Exception as e:         # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_clients)]
            for th in threads:
                th.start()
            for cut in (7168, 7680):
                svc.add_replica(0)
                svc.split_tail(cut)
                svc.drop_replica(0)
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
            assert not errors, errors
            assert svc.drain(timeout=60) == {}
            st = svc.stats
            assert st["requests"] == st["completed"] == 6 * n_clients
            assert sum(st["shard_launches"]) == st["launches"]
            assert sum(st["shard_batches"]) == st["batches"]
            assert sum(st["shard_bytes_h2d"]) == st["bytes_h2d"]
            assert st["shard_splits"] == 2 and svc.n_shards == 6
            assert not svc._chunks_total
    finally:
        sys.setswitchinterval(old)


def test_device_budget_and_surviving_devices_match_reference():
    """The serve helpers' byte ledger and survivor filter answer as the
    reference's, call for call (keys: the device itself here, ``id`` in
    the reference)."""
    def run(side):
        a, b, c = object(), object(), object()
        key = (lambda d: d) if side.name == "repro_torch" else id
        ledger = side.sharding.DeviceBudget(100)
        out = [ledger.fits(key(a), 100), ledger.fits(key(a), 101)]
        ledger.charge(key(a), 60)
        ledger.charge(key(b), 30)
        ledger.charge(key(a), 50)
        out += [ledger.bytes(key(a)), ledger.headroom(key(a)),
                ledger.fits(key(b), 70), ledger.fits(key(b), 71),
                sorted(ledger.over_budget().values())]
        ledger.release(key(a), 110)
        out += [ledger.bytes(key(a)), ledger.over_budget()]
        with pytest.raises(ValueError):
            ledger.release(key(b), 31)
        with pytest.raises(ValueError):
            side.sharding.DeviceBudget(-1)
        free = side.sharding.DeviceBudget()
        free.charge(key(c), 10 ** 12)
        out += [free.fits(key(c), 10 ** 12), free.headroom(key(c)),
                free.over_budget()]
        pool = [a, b, c]
        out += [[pool.index(d) for d in side.sharding.surviving_devices(
                    pool, {key(b)})],
                side.sharding.surviving_devices(pool, {key(a), key(b),
                                                       key(c)})]
        return out
    ref, port = _both(run)
    assert ref == port
    assert port[:7] == [True, False, 110, -10, True, False, [10]]
