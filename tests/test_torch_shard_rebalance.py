"""Port parity, adaptive shard management: the tests of
``tests/test_shard_rebalance.py`` run on both packages.

Seeded random interleavings of streaming appends (``FeaturePlan.refresh``),
tail splits at aligned and unaligned cuts, replica adds and drops, tier
moves (demote to warm or cold, promote), and aligned-range and
arbitrary-row serving — through the bare
:class:`ShardedFeatureExecutor` and through a sharded ``FeatureService``
(mutations also staged behind ``pause()`` with chunks queued). Each
interleaving runs once on ``repro`` and once on ``repro_torch``
(``devices=[torch.device("cpu")]``) from the same seed; every served batch
must equal the int32 host reference bit for bit, and the two packages must
serve the same features and end with the same shard bounds, replicas and
per-shard stream counters.

Sweep depth follows ``REBALANCE_SWEEP_SEEDS`` (2 seeds per mode unless
set), as in the reference.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve as jserve
import repro_torch.core as tcore
import repro_torch.serve as tserve
from repro.columnar import Table as JTable
from repro_torch.columnar import Table
from repro_torch.distributed.sharding import replica_device

BITS_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16)
N_SEEDS = int(os.environ.get("REBALANCE_SWEEP_SEEDS", "2"))
OPS = ("serve", "serve", "serve", "append", "split", "replica_add",
       "replica_drop", "demote", "promote")

SIDES = (SimpleNamespace(name="repro", C=jcore, S=jserve, Table=JTable,
                         plan=lambda t, fs, packed=False: jcore.FeaturePlan(
                             t, fs, packed=packed),
                         pool={}),
         SimpleNamespace(name="repro_torch", C=tcore, S=tserve, Table=Table,
                         plan=lambda t, fs, packed=False: tcore.FeaturePlan(
                             t, fs, packed=packed, device="cpu"),
                         pool={"devices": [torch.device("cpu")]}))


def _host(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _column_data(rng, bits, n):
    k = 2 if bits == 1 else (1 << (bits - 1)) + 1
    return np.concatenate([np.arange(k), rng.integers(0, k, n - k)])


def _bits_table(side, rng, n=33024, imcu_rows=8256):
    """Every storage width class 1-16, 4 IMCU shards."""
    data = {f"c{b}": _column_data(rng, b, n) for b in BITS_SWEEP}
    fs = side.C.FeatureSet()
    for b in BITS_SWEEP:
        fs = fs.add(f"c{b}", "zscore")
    return side.Table.from_data(data, imcu_rows=imcu_rows), fs


def _mixed_table(side, rng, n=3000, imcu_rows=700):
    """700 % 32 != 0: every shard start sits mid-word."""
    t = side.Table.from_data({
        "age": rng.integers(18, 80, n),
        "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
        "income": rng.integers(20, 200, n) * 1000,
    }, imcu_rows=imcu_rows)
    fs = (side.C.FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("income", "minmax"))
    return t, fs


def _append(rng, table, plan_p, plan_i, columns, grow=False):
    """One streaming insert into both plans; ``grow`` adds novel values,
    so small columns cross device-width boundaries and repack."""
    m = int(rng.integers(1, 160))
    new = {}
    for c in columns:
        d = table[c].dictionary
        vals = d.values[rng.integers(0, d.cardinality, m)]
        if grow and np.issubdtype(d.values.dtype, np.integer):
            fresh = int(d.values.max()) + 1 + np.arange(rng.integers(1, 5))
            vals = np.concatenate([vals, fresh.astype(d.values.dtype)])
        new[c] = d.add_rows(vals)
    m = min(len(v) for v in new.values())
    new = {c: v[:m] for c, v in new.items()}
    plan_p.refresh(new)
    plan_i.refresh(new)


def _pick_cut(rng, sx):
    """A split point inside the open tail: word-aligned half the time,
    deliberately unaligned otherwise."""
    start, stop = sx.shards[-1].shard_bounds
    if stop - start < 64:
        return None
    cut = int(rng.integers(start + 1, stop))
    if rng.random() < 0.5:
        cut = max(start + 32, cut // 32 * 32)
    return cut


def _random_request(rng, n_rows, sx):
    """Aligned range / arbitrary rows / boundary-straddle biased rows."""
    kind = rng.integers(0, 3)
    if kind == 0:
        m = int(rng.integers(1, 8)) * 32
        start = int(rng.integers(0, max((n_rows - m) // 32, 1))) * 32
        return np.arange(start, min(start + m, n_rows))
    rows = rng.integers(0, n_rows, int(rng.integers(16, 400)))
    if kind == 2:
        starts = np.asarray(sx.starts[1:])
        if starts.size:
            edges = np.concatenate([starts - 1, starts,
                                    np.minimum(starts + 1, n_rows - 1)])
            rows = np.concatenate([rows, np.clip(edges, 0, n_rows - 1)])
    return rows


def _picture(sx, counters: bool = True):
    """Shard bounds, routing starts, replica counts and the per-shard
    stream counters. Through a service the counters are left out: which
    copy of a replicated shard serves a launch right after an append (and
    so re-puts its stream) depends on how the pump grouped requests that
    arrived while it ran, in either package."""
    pic = ([sp.shard_bounds for sp in sx.shards], list(sx.starts),
           [len(r) for r in sx.replicas])
    if counters:
        pic += ([(st["words_put"], st["words_repacked"])
                 for st in sx.plan.stats["per_shard"]],)
    return pic


def _run_interleaving(side, seed, table, fs, via_service, n_ops=16):
    """One seeded interleaving of mutations and serving; returns every
    served batch and the final shard picture."""
    rng = np.random.default_rng(seed)
    plan_p = side.plan(table, fs, True)
    plan_i = side.plan(table, fs)
    ex_i = side.C.FeatureExecutor(plan_i)
    columns = plan_p.columns
    svc = None
    if via_service:
        svc = side.S.FeatureService(plan_p, sharded=True, buckets=(64, 256),
                                    coalesce=4, **side.pool)
        sx = svc._sharded_ex
    else:
        sx = side.C.ShardedFeatureExecutor(plan_p, **side.pool)
    pending, served = [], []

    def verify_pending():
        for rows, tk in pending:
            got = svc.result(tk, timeout=60)
            assert np.array_equal(got, _host(ex_i.batch(rows)))
            served.append(got)
        pending.clear()

    def serve_check():
        rows = _random_request(rng, plan_p.n_rows, sx)
        if via_service:
            pending.append((rows, svc.submit(rows)))
            if len(pending) > 4 or rng.random() < 0.4:
                verify_pending()
        else:
            got = _host(sx.batch(rows))
            assert np.array_equal(got, _host(ex_i.batch(rows)))
            served.append(got)

    def mutate(kind):
        target = svc if via_service else sx
        if kind == "split":
            cut = _pick_cut(rng, sx)
            if cut is not None:
                target.split_tail(cut)
        elif kind == "replica_add":
            target.add_replica(int(rng.integers(0, sx.n_shards)))
        elif kind == "replica_drop":
            cands = [s for s in range(sx.n_shards) if sx.replicas[s]]
            if cands:
                target.drop_replica(int(rng.choice(cands)))
        elif kind == "demote":
            s = int(rng.integers(0, sx.n_shards))
            # the open tail refuses cold (appends would stale the runs)
            tier = ("cold" if rng.random() < 0.5
                    and not sx.shards[s]._last else "warm")
            if via_service:
                svc.demote(s, tier)
            else:
                # the bare executor's ladder: evict the primary's words
                # (replicas keep serving, reads fan out regardless)
                sx.executors[s].evict_words()
                if tier == "cold":
                    sx.shards[s].demote_cold()
        elif kind == "promote":
            s = int(rng.integers(0, sx.n_shards))
            if via_service:
                svc.promote(s)
            else:
                sx.shards[s].rehydrate()
                sx.executors[s].ensure_range_capacity(sx.shards[s].n_rows)

    try:
        for _ in range(n_ops):
            op = rng.choice(OPS)
            if op == "serve":
                serve_check()
            elif op == "append":
                # refresh is not atomic w.r.t. requests in flight (the
                # drain-before-refresh contract): settle first
                if via_service:
                    verify_pending()
                _append(rng, table, plan_p, plan_i, columns,
                        grow=rng.random() < 0.4)
                serve_check()
            elif via_service and rng.random() < 0.5:
                # mutate WITH chunks queued behind pause: the routing swap
                # must re-route them, not drop or reorder them
                svc.pause()
                for _ in range(int(rng.integers(1, 4))):
                    rows = _random_request(rng, plan_p.n_rows, sx)
                    pending.append((rows, svc.submit(rows)))
                mutate(op)
                svc.resume()
                verify_pending()
            else:
                mutate(op)
        if via_service:
            verify_pending()
        start, stop = sx.shards[-1].shard_bounds
        if stop - start >= 70:
            cut = start + 33                   # never word-aligned
            (svc if via_service else sx).split_tail(cut)
        _append(rng, table, plan_p, plan_i, columns, grow=True)
        n = plan_p.n_rows
        tail_start = int(sx.starts[-1])
        sweep = [np.arange(0, min(n, 256)),
                 np.arange(max(0, n // 2 // 32 * 32), min(n, n // 2 + 128)),
                 np.arange(tail_start, n),
                 rng.integers(0, n, 500)]
        for rows in sweep:
            if rows.size == 0:
                continue
            if via_service:
                pending.append((rows, svc.submit(rows)))
            else:
                got = _host(sx.batch(rows))
                assert np.array_equal(got, _host(ex_i.batch(rows)))
                served.append(got)
        if via_service:
            verify_pending()
        assert sx.n_shards >= len(table[columns[0]].imcu_bounds())
        return served, _picture(sx, counters=not via_service)
    finally:
        if svc is not None:
            svc.shutdown()


def _same_runs(ref, port):
    (ref_served, ref_pic), (port_served, port_pic) = ref, port
    assert len(ref_served) == len(port_served)
    for r, p in zip(ref_served, port_served):
        assert np.array_equal(np.asarray(r), p)
    assert ref_pic == port_pic


# -- the randomized sweeps -----------------------------------------------------------
@pytest.mark.parametrize("seed", range(N_SEEDS))
@pytest.mark.parametrize("via_service", [False, True],
                         ids=["executor", "service"])
def test_interleaved_rebalance_bits_sweep(seed, via_service):
    """Appends, splits (aligned and unaligned), replica flips and both
    serving patterns over every storage width 1-16 stay bit-exact, and
    the two packages agree."""
    runs = []
    for side in SIDES:
        table, fs = _bits_table(side, np.random.default_rng(1000 + seed))
        runs.append(_run_interleaving(side, seed, table, fs, via_service))
    _same_runs(*runs)


@pytest.mark.parametrize("seed", range(N_SEEDS + 1))
def test_interleaved_rebalance_unaligned_seams(seed):
    """The same harness over word-UNALIGNED IMCU rows (700): every shard
    start sits mid-word, so splits and replicas use seam-repacked
    slices."""
    runs = []
    for side in SIDES:
        table, fs = _mixed_table(side, np.random.default_rng(2000 + seed))
        runs.append(_run_interleaving(side, seed, table, fs,
                                      via_service=(seed % 2 == 0)))
    _same_runs(*runs)


# -- deterministic split coverage ----------------------------------------------------
def _pair(side, seed, n, imcu_rows):
    rng = np.random.default_rng(seed)
    table, fs = _mixed_table(side, rng, n=n, imcu_rows=imcu_rows)
    plan_p = side.plan(table, fs, True)
    plan_i = side.plan(table, fs)
    return (rng, table, plan_p, plan_i,
            side.C.ShardedFeatureExecutor(plan_p, **side.pool),
            side.C.FeatureExecutor(plan_i))


def test_split_unaligned_cut_and_append_into_fresh_tail():
    def run(side):
        rng, table, plan_p, plan_i, sx, ex_i = _pair(side, 5, 2048, 512)
        all_rows = np.arange(0, 2048, 3)
        first = _host(sx.batch(all_rows))
        assert np.array_equal(first, _host(ex_i.batch(all_rows)))
        cut = 1536 + 17
        new = sx.split_tail(cut)
        assert new == 4 and sx.starts[-1] == cut
        assert sx.shards[3].shard_bounds == (1536, cut)
        assert sx.shards[4].shard_bounds == (cut, 2048)
        _append(rng, table, plan_p, plan_i, plan_p.columns, grow=True)
        assert sx.shards[4].shard_bounds[1] == plan_p.n_rows
        rows = np.concatenate([
            np.arange(cut - 40, min(cut + 40, plan_p.n_rows)),
            np.arange(2040, plan_p.n_rows),
            rng.integers(0, plan_p.n_rows, 300)])
        got = _host(sx.batch(rows))
        assert np.array_equal(got, _host(ex_i.batch(rows)))
        return [first, got], _picture(sx)
    _same_runs(*(run(side) for side in SIDES))


def test_split_proactive_at_stop_then_append():
    def run(side):
        rng, table, plan_p, plan_i, sx, ex_i = _pair(side, 6, 1024, 512)
        new = sx.split_tail(1024)
        assert sx.shards[new].n_rows == 0
        _append(rng, table, plan_p, plan_i, plan_p.columns)
        assert sx.shards[new].n_rows == plan_p.n_rows - 1024 > 0
        rows = np.concatenate([np.arange(1000, plan_p.n_rows),
                               rng.integers(0, plan_p.n_rows, 200)])
        got = _host(sx.batch(rows))
        assert np.array_equal(got, _host(ex_i.batch(rows)))
        return [got], _picture(sx)
    _same_runs(*(run(side) for side in SIDES))


def test_split_validation_contract():
    def run(side):
        _, table, plan_p, _, sx, _ = _pair(side, 7, 1400, 700)
        tail = sx.shards[-1]
        errs = []
        for call in (lambda: sx.split_tail(64),      # before the tail
                     lambda: sx.split_tail(1401),    # past the end
                     lambda: plan_p.split_tail_shard(sx.shards[0], 350)):
            with pytest.raises(ValueError) as ei:
                call()
            errs.append(type(ei.value).__name__)
        sx.split_tail(1024)
        with pytest.raises(ValueError):             # the tail is closed
            tail.close_at(1100)
        with pytest.raises(RuntimeError):           # int32 plans don't split
            side.plan(table, side.C.FeatureSet().add("age", "zscore")
                      ).split_tail_shard(tail, 1024)
        return errs, _picture(sx)
    ref, port = (run(side) for side in SIDES)
    assert ref == port


# -- stats continuity across shard-set changes ---------------------------------------
def test_stats_continuity_across_split_and_replica():
    """Per-shard entries keep their identity, a new shard APPENDS, replica
    puts count for their shard, and the plan total is the baseline plus
    the per-shard deltas — with equal counts on both packages."""
    def run(side):
        rng = np.random.default_rng(8)
        table, fs = _mixed_table(side, rng, n=2048, imcu_rows=1024)
        plan_p = side.plan(table, fs, True)
        plan_i = side.plan(table, fs)
        base = plan_p.stats["words_put"]           # pre-shard baseline
        sx = side.C.ShardedFeatureExecutor(plan_p, **side.pool)
        ids0 = [id(s.stats) for s in sx.shards]
        snaps = []

        def check_rollup():
            per = plan_p.stats["per_shard"]
            assert per == [s.stats for s in sx.shards]
            assert plan_p.stats["words_put"] == \
                base + sum(s["words_put"] for s in per)
            snaps.append([s["words_put"] for s in per])

        _host(sx.batch(np.arange(0, 2048, 5)))
        check_rollup()
        sx.add_replica(1)
        _host(sx.batch(np.arange(1024, 2048)))
        _host(sx.batch(np.arange(1024, 2048)))
        check_rollup()
        assert plan_p.stats["per_shard"][1]["words_put"] >= 2
        new = sx.split_tail(1536)
        _host(sx.batch(np.arange(1500, 2048)))
        _host(sx.batch(np.arange(1500, 2048)))
        check_rollup()
        assert len(plan_p.stats["per_shard"]) == 3 and new == 2
        assert [id(s.stats) for s in sx.shards[:2]] == ids0
        puts = [s["words_put"] for s in plan_p.stats["per_shard"]]
        _append(rng, table, plan_p, plan_i, plan_p.columns)
        _host(sx.batch(np.arange(0, plan_p.n_rows, 7)))
        per2 = [s["words_put"] for s in plan_p.stats["per_shard"]]
        assert per2[2] == puts[2] + 1 and per2[:2] == puts[:2]
        check_rollup()
        return snaps
    ref, port = (run(side) for side in SIDES)
    assert ref == port


# -- replica mechanics ---------------------------------------------------------------
def test_replica_resync_after_refresh():
    """A refresh invalidates every copy of the touched shard: primary and
    replica both re-put lazily and keep serving bit-exact."""
    def run(side):
        rng, table, plan_p, plan_i, sx, ex_i = _pair(side, 9, 2048, 512)
        sx.add_replica(3)
        tail_rows = np.arange(1536, 2048)
        out = []
        for _ in range(2):
            got = _host(sx.batch(tail_rows))
            assert np.array_equal(got, _host(ex_i.batch(tail_rows)))
            out.append(got)
        puts0 = plan_p.stats["per_shard"][3]["words_put"]
        _append(rng, table, plan_p, plan_i, plan_p.columns, grow=True)
        rows = np.concatenate([tail_rows, np.arange(2048, plan_p.n_rows)])
        for _ in range(2):
            got = _host(sx.batch(rows))
            assert np.array_equal(got, _host(ex_i.batch(rows)))
            out.append(got)
        assert plan_p.stats["per_shard"][3]["words_put"] >= puts0 + 2
        return out, _picture(sx)
    _same_runs(*(run(side) for side in SIDES))


def test_replica_device_placement_rule():
    """replica_device: least-loaded pool device, devices holding the same
    shard avoided, deterministic ties — keyed by the device itself in the
    port (``id`` in the reference)."""
    a, b, c = object(), object(), object()
    pool = [a, b, c]
    assert replica_device(pool, {}) is a
    assert replica_device(pool, {a: 2, b: 1, c: 3}) is b
    assert replica_device(pool, {a: 1, b: 1}, exclude={c}) is a
    assert replica_device(pool, {a: 2, b: 1, c: 3},
                          exclude={a, b, c}) is b
    assert replica_device(pool, {a: 0, b: 1}, unhealthy={a}) is c
    with pytest.raises(ValueError):
        replica_device([], {})
    cpu = torch.device("cpu")
    assert replica_device([cpu, torch.device("cpu")],
                          {torch.device("cpu"): 3}) == cpu


def test_place_fused_reuse_for_replicas():
    """A replica landing on a device that already holds a shard shares
    that device's ONE placed table set (the table cache)."""
    side = SIDES[1]
    rng, _, plan_p, _, sx, _ = _pair(side, 10, 1024, 512)
    ex = sx.add_replica(0, device=sx.executors[0].device)
    assert ex._tcache is sx.executors[0]._tcache
    assert ex._device_fused() is sx.executors[0]._device_fused()
    assert ex._device_fused() is plan_p.fused_tables()
    assert len(sx._caches) == 1
