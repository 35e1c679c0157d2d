"""Port parity, the single-device service: every test of
``tests/test_random_serving.py`` and the single-device service tests of
``tests/test_packed_path.py`` and ``tests/test_feature_service.py``, run on
both packages.

Each scenario runs once on ``repro`` (its XLA path) and once on
``repro_torch`` (the kernels' plain versions on the CPU) with the same
seeds; features must be equal bit for bit between the packages and to the
plan's host reference, and the counters the scenario fixes (launches,
batches, index bytes, padded rows, ``packed_ranges``) must be equal. Where
the reference parametrises ``use_kernel``, the mirror parametrises packed
and int32 plans. No outcome rests on timing: work whose grouping is
compared is staged while the pump is paused, and every wait has a
timeout.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.columnar import Table as JTable
from repro.core import FeaturePlan as JPlan, FeatureSet as JFeatureSet
from repro_torch.columnar import Table
from repro_torch.core import FeaturePlan, FeatureSet

PACKED = pytest.mark.parametrize("packed", [True, False],
                                 ids=["packed", "int32"])
COUNTERS = ("requests", "rows", "padded_rows", "batches", "launches",
            "bytes_h2d", "packed_ranges", "completed")

SIDES = (SimpleNamespace(name="repro", S=jserve, Table=JTable,
                         FeatureSet=JFeatureSet,
                         plan=lambda t, fs, packed: JPlan(t, fs,
                                                          packed=packed)),
         SimpleNamespace(name="repro_torch", S=tserve, Table=Table,
                         FeatureSet=FeatureSet,
                         plan=lambda t, fs, packed: FeaturePlan(
                             t, fs, packed=packed, device="cpu")))


def _data(n=2048, seed=0, cols=3):
    """``tests/test_random_serving.py``'s table."""
    rng = np.random.default_rng(seed)
    data = {"age": rng.integers(18, 80, n),
            "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
            "income": rng.integers(20, 200, n) * 1000}
    return {k: data[k] for k in list(data)[:cols]}


def _features(fs_cls, cols=3):
    fs = (fs_cls().add("age", "zscore")
          .add("age", "bucketize", boundaries=(30.0, 50.0, 65.0)))
    if cols >= 2:
        fs = fs.add("state", "onehot")
    if cols >= 3:
        fs = fs.add("income", "minmax")
    return fs


def _plan(side, packed=True, n=2048, cols=3, seed=0):
    return side.plan(side.Table.from_data(_data(n, seed, cols)),
                     _features(side.FeatureSet, cols), packed)


def _both(run, *args):
    """Run one scenario on the reference and on the port."""
    return [run(side, *args) for side in SIDES]


def _same(ref, port):
    """Equal outcomes: arrays bit for bit, the rest with ==."""
    if isinstance(ref, np.ndarray) or isinstance(port, np.ndarray):
        ref, port = np.asarray(ref), np.asarray(port)
        assert ref.dtype == port.dtype and np.array_equal(ref, port)
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


def _counters(svc):
    return {k: svc.stats[k] for k in COUNTERS}


# -- tests/test_random_serving.py ------------------------------------------------
@PACKED
def test_random_requests_bit_exact(packed):
    """Uniform arbitrary-row requests of mixed sizes through the coalescer
    equal the host reference, on both packages, with equal counters."""
    def run(side, packed):
        plan = _plan(side, packed)
        rng = np.random.default_rng(1)
        reqs = [rng.integers(0, 2048, sz)
                for sz in (1, 17, 64, 200, 256, 700)]
        with side.S.FeatureService(plan, buckets=(64, 256)) as svc:
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tickets]
        for r, g in zip(reqs, got):
            assert np.array_equal(g, plan.host_features(r))
        return got, _counters(svc)
    _same(*_both(run, packed))


def test_random_requests_ship_index_only_bytes():
    """Index bytes only: 4 B x coalesce x bucket a launch, whatever the
    number of columns, on both packages."""
    def run(side):
        observed = {}
        for cols in (1, 3):
            svc = side.S.FeatureService(_plan(side, cols=cols),
                                        buckets=(128,), coalesce=4)
            rng = np.random.default_rng(2)
            svc.pause()
            for _ in range(8):
                svc.submit(rng.integers(0, 2048, 100))
            svc.resume()
            svc.drain(timeout=60)
            assert svc.stats["launches"] == 2
            assert svc.stats["bytes_h2d"] == 2 * 4 * 4 * 128
            observed[cols] = _counters(svc)
            svc.shutdown()
        assert observed[1]["bytes_h2d"] == observed[3]["bytes_h2d"]
        return observed
    _same(*_both(run))


def test_pump_drains_without_caller_dispatch():
    """A request completes with no poll/result/drain call: the pump is the
    only dispatcher."""
    def run(side):
        plan = _plan(side, n=512)
        svc = side.S.FeatureService(plan, buckets=(64,))
        tk = svc.submit(np.arange(7, 64))          # unaligned, mid-word
        deadline = time.perf_counter() + 30.0
        while svc.stats["completed"] < 1:
            assert time.perf_counter() < deadline, "pump never retired"
            time.sleep(0.001)
        assert svc.poll(tk)
        got = svc.result(tk, timeout=30)
        svc.shutdown()
        assert np.array_equal(got, plan.host_features(np.arange(7, 64)))
        return got, _counters(svc)
    _same(*_both(run))


def test_poll_and_result_never_launch():
    """While paused, poll never makes progress happen."""
    def run(side):
        svc = side.S.FeatureService(_plan(side, n=512), buckets=(64,))
        svc.pause()
        tk = svc.submit(np.arange(64))
        polls = [svc.poll(tk) for _ in range(20)]
        launched = svc.stats["launches"]
        svc.resume()
        got = svc.result(tk, timeout=30)
        svc.shutdown()
        return polls, launched, got
    ref, port = _both(run)
    _same(ref, port)
    assert port[0] == [False] * 20 and port[1] == 0


@PACKED
def test_concurrent_submit_poll_result_threads(packed):
    """Four client threads submit/poll/result against one service; each
    sees its own rows, bit for bit, on both packages."""
    def run(side, packed):
        plan = _plan(side, packed)
        svc = side.S.FeatureService(plan, buckets=(64, 256))
        errors, served = [], {}

        def client(seed):
            try:
                rng = np.random.default_rng(seed)
                out = []
                for _ in range(8):
                    rows = rng.integers(0, 2048, int(rng.integers(1, 300)))
                    tk = svc.submit(rows)
                    if seed % 2:
                        deadline = time.perf_counter() + 30.0
                        while not svc.poll(tk):
                            assert time.perf_counter() < deadline
                            time.sleep(0.0005)
                    got = svc.result(tk, timeout=60)
                    assert np.array_equal(got, plan.host_features(rows))
                    out.append(got)
                served[seed] = out
            except Exception as e:                 # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        svc.shutdown()
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        return [served[i] for i in range(4)], svc.stats["completed"]
    _same(*_both(run, packed))


def test_drain_does_not_steal_claimed_results():
    """A ticket another thread waits on in result() is not swept away by
    a concurrent drain()."""
    def run(side):
        plan = _plan(side)
        svc = side.S.FeatureService(plan, buckets=(64,))
        rng = np.random.default_rng(7)
        rows = rng.integers(0, 2048, 64 * 12)      # multi-chunk
        svc.pause()                                # held until claimed
        tk = svc.submit(rows)
        got, errors = {}, []

        def waiter():
            try:
                got["res"] = svc.result(tk, timeout=60)
            except Exception as e:                 # surfaced below
                errors.append(e)

        # the waiter must claim before it could see the paused queue: claim
        # it under the lock as result() does, then resume and drain
        with svc._lock:
            svc._claimed.add(tk)
        svc.resume()
        th = threading.Thread(target=waiter)
        th.start()
        drained = svc.drain(timeout=60)
        th.join(timeout=60)
        svc.shutdown()
        assert not errors, errors
        assert tk not in drained
        assert np.array_equal(got["res"], plan.host_features(rows))
        return got["res"], sorted(drained)
    _same(*_both(run))


def test_paused_result_and_drain_raise_instead_of_hanging():
    def run(side):
        svc = side.S.FeatureService(_plan(side, n=512), buckets=(64,))
        svc.pause()
        tk = svc.submit(np.arange(64))
        with pytest.raises(RuntimeError, match="paused"):
            svc.result(tk)
        with pytest.raises(RuntimeError, match="pause"):
            svc.drain()
        svc.resume()
        got = svc.result(tk, timeout=30)
        svc.shutdown()
        return got
    _same(*_both(run))


def test_shutdown_drains_and_rejects_new_work():
    def run(side):
        plan = _plan(side, n=512)
        svc = side.S.FeatureService(plan, buckets=(64,))
        rng = np.random.default_rng(3)
        reqs = [rng.integers(0, 512, 64) for _ in range(6)]
        tickets = [svc.submit(r) for r in reqs]
        svc.shutdown()
        assert not svc._pump.is_alive()
        got = [svc.result(tk, timeout=30) for tk in tickets]
        for r, g in zip(reqs, got):
            assert np.array_equal(g, plan.host_features(r))
        with pytest.raises(RuntimeError):
            svc.submit(np.arange(4))
        svc.shutdown()                             # idempotent
        return got
    _same(*_both(run))


def test_shutdown_discard_forgets_queued_tickets():
    def run(side):
        svc = side.S.FeatureService(_plan(side, n=512), buckets=(64,))
        svc.pause()
        tk = svc.submit(np.arange(64))
        svc.shutdown(drain=False)
        with pytest.raises(KeyError):
            svc.poll(tk)
        return svc._pump.is_alive(), svc.stats["launches"]
    ref, port = _both(run)
    assert ref == port == (False, 0)


def test_service_context_manager_and_drain():
    def run(side):
        plan = _plan(side, n=512)
        rng = np.random.default_rng(4)
        reqs = [rng.integers(0, 512, 40) for _ in range(5)]
        with side.S.FeatureService(plan, buckets=(64,)) as svc:
            tickets = [svc.submit(r) for r in reqs]
            out = svc.drain(timeout=60)
            assert set(out) == set(tickets)
        assert not svc._pump.is_alive()
        for r, tk in zip(reqs, tickets):
            assert np.array_equal(out[tk], plan.host_features(r))
        return [out[tk] for tk in tickets]
    _same(*_both(run))


# -- tests/test_packed_path.py's service tests -----------------------------------
def test_packed_service_serves_rows_past_initial_capacity():
    """Rows appended after compile, past the stream's first capacity, serve
    bit-exact (not clipped into another column's words)."""
    def run(side):
        rng = np.random.default_rng(22)
        t = side.Table.from_data({"a": rng.integers(0, 100, 224),
                                  "b": rng.integers(0, 9, 224)})
        fs = side.FeatureSet().add("a", "zscore").add("b", "onehot")
        plan = side.plan(t, fs, True)
        svc = side.S.FeatureService(plan, buckets=(64,))
        first = svc.result(svc.submit(np.arange(64)), timeout=30)
        new = {"a": t["a"].dictionary.add_rows(rng.integers(0, 100, 10)),
               "b": t["b"].dictionary.add_rows(rng.integers(0, 9, 10))}
        plan.refresh(new)
        rows = np.arange(220, 234)
        got = svc.result(svc.submit(rows), timeout=30)
        svc.shutdown()
        assert np.array_equal(got, plan.host_features(rows))
        return first, got
    _same(*_both(run))


@PACKED
def test_packed_service_matches_pipeline(packed):
    """Aligned ranges, arbitrary rows, unaligned runs and multi-chunk
    requests; ``packed_ranges`` counts the word-aligned contiguous
    chunks on both packages."""
    def run(side, packed):
        rng = np.random.default_rng(6)
        n = 2048
        t = side.Table.from_data({
            "age": rng.integers(18, 80, n),
            "state": np.array(["CA", "OR", "WA", "NY"])[rng.integers(0, 4, n)],
            "income": rng.integers(20, 200, n) * 1000})
        fs = (side.FeatureSet().add("age", "zscore").add("state", "onehot")
              .add("income", "minmax"))
        plan = side.plan(t, fs, packed)
        reqs = [np.arange(0, 256), np.arange(992, 1056),
                rng.integers(0, n, 200), np.arange(7, 40),
                np.arange(1984, 2048), np.arange(0, 520)]
        with side.S.FeatureService(plan, buckets=(64, 256)) as svc:
            svc.pause()
            tickets = [svc.submit(r) for r in reqs]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tickets]
        for r, g in zip(reqs, got):
            assert np.array_equal(g, plan.host_features(r))
        if packed:
            assert svc.stats["packed_ranges"] >= 4
        else:
            assert svc.stats["packed_ranges"] == 0
        assert svc.stats["bytes_h2d"] > 0
        return got, _counters(svc)
    _same(*_both(run, packed))


def test_packed_service_coalesces_launches():
    """Six staged 128-row ranges in groups of <= 4: 2 launches and
    ``packed_ranges == 6`` on both packages."""
    def run(side):
        rng = np.random.default_rng(8)
        t = side.Table.from_data({"a": rng.integers(0, 100, 4096)})
        fs = side.FeatureSet().add("a", "zscore")
        plan = side.plan(t, fs, True)
        svc = side.S.FeatureService(plan, buckets=(128,), coalesce=4)
        svc.pause()
        starts = [0, 512, 1024, 2048, 3072, 256]
        tickets = [svc.submit(np.arange(s, s + 128)) for s in starts]
        svc.resume()
        out = svc.drain(timeout=60)
        svc.shutdown()
        assert set(out) == set(tickets)
        for s, tk in zip(starts, tickets):
            assert np.array_equal(out[tk],
                                  plan.host_features(np.arange(s, s + 128)))
        return [out[tk] for tk in tickets], _counters(svc)
    ref, port = _both(run)
    _same(ref, port)
    assert port[1]["launches"] == 2 and port[1]["packed_ranges"] == 6


def test_packed_service_poll_flushes_partial_group():
    """One queued range (a partial coalescing group) completes through
    poll() alone."""
    def run(side):
        rng = np.random.default_rng(9)
        t = side.Table.from_data({"a": rng.integers(0, 100, 512)})
        plan = side.plan(t, side.FeatureSet().add("a", "zscore"), True)
        svc = side.S.FeatureService(plan, buckets=(64,))
        tk = svc.submit(np.arange(64, 128))
        deadline = time.perf_counter() + 30.0
        while not svc.poll(tk):
            assert time.perf_counter() < deadline
            time.sleep(0.001)
        got = svc.result(tk, timeout=30)
        svc.shutdown()
        assert np.array_equal(got, plan.host_features(np.arange(64, 128)))
        return got, _counters(svc)
    _same(*_both(run))


# -- tests/test_feature_service.py's single-device service tests -----------------
def _toy_plan(side, packed, n=2048, seed=0):
    """``tests/test_feature_service.py``'s table and features."""
    return _plan(side, packed, n=n, seed=seed)


@PACKED
def test_service_matches_direct_batch(packed):
    def run(side, packed):
        plan = _toy_plan(side, packed)
        rng = np.random.default_rng(2)
        rows = [rng.integers(0, 2048, sz) for sz in (3, 64, 200, 1024)]
        with side.S.FeatureService(plan) as svc:
            svc.pause()
            tickets = [svc.submit(r) for r in rows]
            svc.resume()
            got = [svc.result(tk, timeout=60) for tk in tickets]
        for r, g in zip(rows, got):
            assert np.array_equal(g, plan.host_features(r))
        return got, _counters(svc)
    _same(*_both(run, packed))


@PACKED
def test_service_double_buffer_depth_and_bucketing(packed):
    """prefetch=3 bounds the window and is reached when the burst is
    staged; a 300-row request splits into largest-bucket chunks; 20-row
    requests pad to the 32 bucket."""
    def run(side, packed):
        plan = _toy_plan(side, packed)
        svc = side.S.FeatureService(plan, prefetch=3, buckets=(32, 128))
        rng = np.random.default_rng(3)
        reqs = [rng.integers(0, 2048, 20) for _ in range(8)]
        big = rng.integers(0, 2048, 300)
        svc.pause()
        tickets = [svc.submit(r) for r in reqs]
        tk = svc.submit(big)
        svc.resume()
        got_big = svc.result(tk, timeout=60)
        out = svc.drain(timeout=60)
        svc.shutdown()
        assert set(out) == set(tickets)
        assert np.array_equal(got_big, plan.host_features(big))
        assert svc.stats["max_inflight"] <= 3
        assert svc.stats["padded_rows"] > 0
        return ([out[t] for t in tickets], got_big, _counters(svc),
                svc.stats["max_inflight"])
    ref, port = _both(run, packed)
    _same(ref, port)
    assert port[3] == 3


def test_service_poll_completes_without_result_call():
    def run(side):
        plan = _toy_plan(side, False, n=256)
        svc = side.S.FeatureService(plan)
        tk = svc.submit(np.arange(32))
        deadline = time.perf_counter() + 30.0
        while not svc.poll(tk):
            assert time.perf_counter() < deadline, "poll never became ready"
            time.sleep(0.001)
        got = svc.result(tk, timeout=30)
        svc.shutdown()
        assert np.array_equal(got, plan.host_features(np.arange(32)))
        return got
    _same(*_both(run))


def test_service_bad_ticket_fails_fast():
    def run(side):
        plan = _toy_plan(side, False, n=256)
        svc = side.S.FeatureService(plan)
        tk = svc.submit(np.arange(16))
        with pytest.raises(KeyError):
            svc.result(9999)
        with pytest.raises(KeyError):
            svc.poll(9999)
        got = svc.result(tk, timeout=30)
        with pytest.raises(KeyError):
            svc.poll(tk)
        svc.shutdown()
        return got
    ref, port = _both(run)
    _same(ref, port)
    assert port.shape[0] == 16


@PACKED
def test_service_window_bounds_chunks_of_one_request(packed):
    """A 20-chunk request's chunks count against the window one by one."""
    def run(side, packed):
        plan = _toy_plan(side, packed)
        rows = np.random.default_rng(0).integers(0, 2048, 64 * 20)
        with side.S.FeatureService(plan, prefetch=2, buckets=(64,)) as svc:
            got = svc.result(svc.submit(rows), timeout=60)
        assert np.array_equal(got, plan.host_features(rows))
        assert svc.stats["batches"] == 20
        assert svc.stats["max_inflight"] <= 2
        return got, svc.stats["batches"], svc.stats["bytes_h2d"]
    _same(*_both(run, packed))


def test_service_rejects_bad_requests():
    def run(side):
        plan = _toy_plan(side, False, n=100)
        svc = side.S.FeatureService(plan)
        errs = []
        for bad in (np.array([], dtype=np.int64), np.array([100])):
            try:
                svc.submit(bad)
            except (ValueError, IndexError) as e:
                errs.append(type(e).__name__)
        try:
            side.S.FeatureService(plan, prefetch=1)
        except ValueError as e:
            errs.append(type(e).__name__)
        svc.shutdown()
        return errs
    ref, port = _both(run)
    assert ref == port == ["ValueError", "IndexError", "ValueError"]
