"""Port parity, filtered serving: ``submit(where=...)`` and the service's
pushdown queries in ``repro_torch`` against ``repro`` (Pallas kernels in
interpret mode). The same table, predicates and request sequence go to
both services; every result must be equal (``np.array_equal``).
"""
import numpy as np
import pytest

from repro.columnar import Table as JTable
from repro.columnar import query as JQ
from repro.core import FeaturePlan as JPlan, FeatureSet as JFeatureSet
from repro.serve import FeatureService as JService
from repro_torch.columnar import Table
from repro_torch.columnar import query as Q
from repro_torch.core import FeaturePlan, FeatureSet
from repro_torch.serve import FeatureService

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


def _plans(packed=True):
    data = _data()
    return (JPlan(JTable.from_data(data, imcu_rows=700),
                  _features(JFeatureSet), packed=packed),
            FeaturePlan(Table.from_data(data, imcu_rows=700),
                        _features(FeatureSet), packed=packed, device="cpu"))


def _p1(q):
    return q.eq("state", 7) & q.between("age", 30, 45)


def _p2(q):
    return q.isin("device", [1, 3]) | q.ge("income", 240000)


def _serve(svc, reqs):
    svc.pause()
    tickets = [svc.submit(r) if isinstance(r, np.ndarray)
               else svc.submit(where=r) for r in reqs]
    svc.resume()
    out = svc.collect(timeout=120)
    return [out[t] for t in tickets]


@pytest.mark.parametrize("pred", [_p1, _p2])
def test_filtered_submit_interleaved_matches_reference(pred):
    """``submit(where=)`` between plain requests: the same features, the
    same launches and the same counters as the reference service."""
    jplan, plan = _plans()
    rng = np.random.default_rng(5)
    plain = [rng.integers(0, N, s) for s in (200, 17, 512, 300)]
    reqs, jreqs = [], []
    for rows in plain:
        reqs += [rows, pred(Q)]
        jreqs += [rows, pred(JQ)]
    jsvc = JService(jplan, use_kernel=True, buckets=(256, 512), coalesce=4)
    svc = FeatureService(plan, buckets=(256, 512), coalesce=4)
    with jsvc, svc:
        want = _serve(jsvc, jreqs)
        got = _serve(svc, reqs)
        match = np.flatnonzero(Q.predicate_mask_host(plan.table, pred(Q)))
        for r, g, w in zip(reqs, got, want):
            rows = r if isinstance(r, np.ndarray) else match
            assert g.dtype == np.float32 and g.shape == (rows.size, 58)
            assert np.array_equal(g, np.asarray(w))
            assert np.array_equal(g, plan.host_features(rows))
        for key in ("requests", "filtered_requests", "rows", "padded_rows",
                    "launches", "batches", "bytes_h2d", "completed"):
            assert svc.stats[key] == jsvc.stats[key], key
        assert svc.stats["filtered_requests"] == 4


def test_service_pushdown_queries_match_reference():
    jplan, plan = _plans()
    with JService(jplan, use_kernel=True) as jsvc, \
            FeatureService(plan) as svc:
        for pred in (_p1, _p2):
            p, jp = pred(Q), pred(JQ)
            assert svc.count_where(p) == jsvc.count_where(jp)
            assert np.array_equal(svc.filtered_rows(p),
                                  jsvc.filtered_rows(jp))
            for col in ("device", "state"):
                vals, counts = svc.groupby_where(col, p)
                jvals, jcounts = jsvc.groupby_where(col, jp)
                assert np.array_equal(vals, jvals)
                assert np.array_equal(counts, jcounts)
            for agg in ("count", "sum", "mean"):
                assert svc.agg_where(p, "income", agg) == \
                    jsvc.agg_where(jp, "income", agg)


def test_empty_selection_short_circuits():
    jplan, plan = _plans()
    with JService(jplan, use_kernel=True) as jsvc, \
            FeatureService(plan) as svc:
        for s, q in ((svc, Q), (jsvc, JQ)):
            t = s.submit(where=q.eq("state", 99999))
            assert s.poll(t)                  # already on the host
            out = s.result(t)
            assert out.shape == (0, plan.out_dim) and out.dtype == np.float32
            assert s.stats["filtered_requests"] == 1
            assert s.stats["requests"] == s.stats["completed"] == 1
            assert s.stats["launches"] == 0   # nothing reached the pump
        # the service goes on serving after the short circuit
        rows = np.arange(40, 90)
        assert np.array_equal(svc.result(svc.submit(rows)),
                              plan.host_features(rows))


def test_filtered_submit_guards():
    jplan32, plan32 = _plans(packed=False)
    jplan, plan = _plans()
    with FeatureService(plan32) as svc, JService(jplan32) as jsvc:
        for s, q in ((svc, Q), (jsvc, JQ)):
            with pytest.raises(RuntimeError):
                s.submit(where=_p1(q))
            with pytest.raises(RuntimeError):
                s.count_where(_p1(q))
            with pytest.raises(ValueError):
                s.submit()
        assert svc.stats["requests"] == 0
    with FeatureService(plan) as svc, JService(jplan) as jsvc:
        for s, q in ((svc, Q), (jsvc, JQ)):
            with pytest.raises(ValueError):
                s.submit(np.arange(4), where=_p1(q))
            with pytest.raises(ValueError):
                s.submit(where=_p1(q), deadline_ms=0)
        # the existing call forms still work
        rows = np.arange(10)
        for t in (svc.submit(rows), svc.submit(rows, deadline_ms=60_000.0)):
            assert np.array_equal(svc.result(t, timeout=60),
                                  plan.host_features(rows))
