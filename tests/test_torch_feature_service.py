"""Port parity, the slice as a whole: a ``repro_torch`` FeatureService and a
``repro`` FeatureService (Pallas kernels in interpret mode) get the same
request sequence — arbitrary rows, mixed sizes, chunks past the largest
bucket, coalesced launches — and must return identical features, ship the
same host->device bytes and make the same number of launches. Then the
port's own serving contract: deadlines, per-group failure isolation,
timeouts, pause/drain/shutdown, and ``serve_stream``'s order.
"""
import threading
import time

import numpy as np
import pytest

from repro.columnar import Table as JTable
from repro.core import FeaturePlan as JPlan, FeatureSet as JFeatureSet
from repro.serve import FeatureService as JService
from repro_torch.columnar import Table
from repro_torch.core import FeaturePlan, FeatureSet
from repro_torch.serve import (DeadlineExceeded, FaultPolicy, FeatureService,
                               ServeError)

N = 3001


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return {"age": rng.integers(18, 90, N), "state": rng.integers(0, 50, N),
            "income": rng.integers(20, 250, N) * 1000,
            "device": rng.integers(0, 4, N)}


def _features(fs_cls):
    """The serving feature set: out_dim 58, device widths 8/8/8/2."""
    return (fs_cls().add("age", "zscore")
            .add("age", "bucketize", boundaries=(30.0, 45.0, 65.0))
            .add("state", "onehot")
            .add("income", "minmax").add("income", "log")
            .add("device", "onehot"))


def _plans(packed):
    data = _data()
    return (JPlan(JTable.from_data(data), _features(JFeatureSet),
                  packed=packed),
            FeaturePlan(Table.from_data(data), _features(FeatureSet),
                        packed=packed, device="cpu"))


def _requests(seed=1):
    rng = np.random.default_rng(seed)
    sizes = [1, 17, 128, 256, 300, 512, 700, 1300, 64, 5, 256, 511]
    reqs = [rng.integers(0, N, s) for s in sizes]
    reqs.append(np.arange(1024, 1024 + 256))          # a word-aligned range
    return reqs


def _serve(svc, reqs):
    svc.pause()
    tickets = [svc.submit(r) for r in reqs]
    svc.resume()
    out = svc.collect(timeout=120)
    svc.shutdown()
    return [out[t] for t in tickets]


@pytest.mark.parametrize("packed", [True, False])
def test_service_matches_reference_service(packed):
    jplan, plan = _plans(packed)
    reqs = _requests()
    jsvc = JService(jplan, use_kernel=True, buckets=(256, 512), coalesce=4)
    svc = FeatureService(plan, buckets=(256, 512), coalesce=4)
    want = _serve(jsvc, reqs)
    got = _serve(svc, reqs)
    for r, g, w in zip(reqs, got, want):
        assert g.dtype == np.float32 and g.shape == (r.size, 58)
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, plan.host_features(r))
    for key in ("launches", "batches", "bytes_h2d", "requests", "rows",
                "padded_rows", "packed_ranges", "completed"):
        assert svc.stats[key] == jsvc.stats[key], key
    if packed:
        # index bytes only: 4 B x coalesce x bucket per launch
        assert svc.stats["bytes_h2d"] % (4 * 4 * 256) == 0
        assert svc.stats["launches"] < svc.stats["batches"]   # coalesced


def test_packed_buckets_round_to_words_like_reference():
    jplan, plan = _plans(True)
    with FeatureService(plan, buckets=(1, 33, 100)) as svc, \
            JService(jplan, buckets=(1, 33, 100)) as jsvc:
        assert svc.buckets == jsvc.buckets == (32, 64, 128)
        assert svc.coalesce == 4
    _, iplan = _plans(False)
    with FeatureService(iplan, buckets=(1, 33)) as svc:
        assert svc.buckets == (1, 33) and svc.coalesce == 1


def test_concurrent_submitters_get_their_own_rows():
    _, plan = _plans(True)
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(15):
                r = rng.integers(0, N, int(rng.integers(1, 600)))
                got = svc.result(svc.submit(r), timeout=60)
                assert np.array_equal(got, plan.host_features(r))
        except Exception as e:            # surfaced below
            errors.append(e)

    with FeatureService(plan, buckets=(64, 256), coalesce=4,
                        linger_us=200.0) as svc:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert svc.stats["completed"] == 60
    assert svc.latency_percentile(50) > 0
    stats = svc.throughput_stats(1.0)
    assert stats["availability"] == 1.0 and stats["pending"] == 0


def test_failed_launch_fails_only_its_group():
    """With no retries (the reference's behaviour at ``max_retries=0``) a
    launch that raises fails exactly its group's tickets."""
    _, plan = _plans(True)
    svc = FeatureService(plan, buckets=(64,), coalesce=2,
                         fault_policy=FaultPolicy(max_retries=0))
    real = svc._executor._rows_future
    calls = []

    def flaky(rows):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected kernel fault")
        return real(rows)

    svc._executor._rows_future = flaky
    reqs = [np.arange(i * 10, i * 10 + 10) for i in range(6)]
    svc.pause()
    tickets = [svc.submit(r) for r in reqs]
    svc.resume()
    out = svc.collect(timeout=60)
    svc.shutdown()
    failed = [t for t in tickets if isinstance(out[t], Exception)]
    assert failed == tickets[2:4]           # the second launch's group
    for t in failed:
        assert isinstance(out[t], ServeError)
        assert isinstance(out[t].__cause__, RuntimeError)
    for t, r in zip(tickets, reqs):
        if t not in failed:
            assert np.array_equal(out[t], plan.host_features(r))
    assert svc.stats["failed_tickets"] == 2
    assert svc.throughput_stats(1.0)["availability"] == 4 / 6


def test_failed_retire_raises_from_result():
    """A retire that keeps raising is retried like a failed launch (the
    default policy: 3 retries); then the ticket's ServeError carries the
    attempts and the cause, and the service goes on serving."""
    _, plan = _plans(True)
    with FeatureService(plan, buckets=(64,)) as svc:
        svc._await_flight = lambda fl: (_ for _ in ()).throw(
            RuntimeError("device fault"))
        t = svc.submit(np.arange(5))
        with pytest.raises(ServeError) as ei:
            svc.result(t, timeout=30)
        assert ei.value.attempts == 4
        assert isinstance(ei.value.__cause__, RuntimeError)
        assert svc.stats["retries"] == 3
        del svc._await_flight
        r = np.arange(40, 90)
        assert np.array_equal(svc.result(svc.submit(r), timeout=30),
                              plan.host_features(r))


def test_deadline_evicts_queued_chunks():
    _, plan = _plans(True)
    with FeatureService(plan, buckets=(64,)) as svc:
        svc.pause()
        t = svc.submit(np.arange(10), deadline_ms=1.0)
        ok = svc.submit(np.arange(10))
        time.sleep(0.01)
        svc.resume()
        with pytest.raises(DeadlineExceeded):
            svc.result(t, timeout=30)
        assert svc.result(ok, timeout=30).shape == (10, 58)
        assert svc.stats["timeouts"] == 1


def test_client_api_guards():
    _, plan = _plans(True)
    svc = FeatureService(plan, buckets=(64,))
    with pytest.raises(IndexError):
        svc.submit(np.array([N]))
    with pytest.raises(ValueError):
        svc.submit(np.array([], np.int64))
    with pytest.raises(KeyError):
        svc.result(12345)
    svc.pause()
    t = svc.submit(np.arange(3))
    assert svc.poll(t) is False
    with pytest.raises(RuntimeError):
        svc.result(t)
    with pytest.raises(RuntimeError):
        svc.drain()
    svc.resume()
    assert np.array_equal(svc.result(t, timeout=30), plan.host_features(
        np.arange(3)))
    svc.pause()
    svc.submit(np.arange(3))
    svc.shutdown(drain=False)               # queued work dropped, no hang
    with pytest.raises(RuntimeError):
        svc.submit(np.arange(3))
    for bad in ({"prefetch": 1}, {"buckets": ()}, {"linger_us": -1},
                {"coalesce": 0}):
        with pytest.raises(ValueError):
            FeatureService(plan, **bad)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_pump_death_unblocks_waiters():
    """An error in the pump's own control logic (outside a guarded launch)
    with no restart budget poisons the service: blocked and later callers
    raise, none hangs."""
    _, plan = _plans(True)
    svc = FeatureService(plan, buckets=(64,),
                         fault_policy=FaultPolicy(pump_restarts=0))
    svc.pause()
    t = svc.submit(np.arange(4))

    def boom(queue, now):
        raise RuntimeError("control logic bug")

    svc._take_group = boom
    svc.resume()
    with pytest.raises(RuntimeError, match="pump thread died"):
        svc.result(t, timeout=30)
    with pytest.raises(RuntimeError, match="pump thread died"):
        svc.submit(np.arange(4))
    svc.shutdown()
    assert not svc._pump.is_alive()


@pytest.mark.parametrize("packed", [True, False])
def test_service_serve_stream_order(packed):
    """Counterpart of the reference's ``test_service_serve_stream_order``:
    (rows, features) come back in submission order, equal to the
    reference service's stream."""
    jplan, plan = _plans(packed)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, N, 64) for _ in range(6)]
    with JService(jplan, buckets=(64,)) as jsvc, \
            FeatureService(plan, buckets=(64,)) as svc:
        want = list(jsvc.serve_stream(iter(batches)))
        got = list(svc.serve_stream(iter(batches)))
    assert len(got) == 6
    for (rows, feats), (jrows, jfeats), b in zip(got, want, batches):
        assert np.array_equal(rows, b) and np.array_equal(jrows, b)
        assert np.array_equal(feats, np.asarray(jfeats))
        assert np.array_equal(feats, plan.host_features(b))
