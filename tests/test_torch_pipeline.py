"""Port parity, plan and executor: ``repro_torch`` against ``repro``.

Both packages serve the same seeded table; the reference executor runs its
Pallas kernels in interpret mode (``use_kernel=True``), the port runs the
plain versions of its CUDA kernels on the CPU. Every path must agree bit
for bit: ``batch_range``, ``_multi_range_future``, ``_rows_future``,
``batch``, ``gather_device`` and ``batches()`` — over a plan the port
builds from the same data AND over the reference plan's own state
(``plan_from_reference``), including rows appended past the stream's
pad32 capacity.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.columnar import Table as JTable
from repro.core import (FeatureExecutor as JExecutor,
                        FeaturePipeline as JPipeline, FeaturePlan as JPlan,
                        FeatureSet as JFeatureSet)
from repro_torch.columnar import Table
from repro_torch.core import (FeatureExecutor, FeaturePipeline, FeaturePlan,
                              FeatureSet, plan_from_reference)

N = 2003                    # not a multiple of 32: a ragged last word


def _data(n=N, seed=0):
    """Four columns whose dictionaries need 1, 3, 6 and 11 bits (device
    widths 1, 4, 8, 16)."""
    rng = np.random.default_rng(seed)

    def col(k):
        return np.concatenate([np.arange(k), rng.integers(0, k, n - k)])

    return {"flag": col(2), "device": col(5), "state": col(40),
            "zip": col(1025)}


def _features(fs_cls):
    return (fs_cls().add("flag", "float").add("device", "onehot")
            .add("state", "zscore")
            .add("state", "bucketize", boundaries=(5.0, 20.0, 30.0))
            .add("zip", "minmax").add("zip", "embedding", dim=3, seed=1))


def _reference_state(jplan):
    return {"columns": jplan.columns, "n_rows": jplan.n_rows,
            "packed_words": [np.asarray(w) for w in jplan.packed_words],
            "device_bits": list(jplan.device_bits),
            "fused_host": [p.fused_host for p in jplan.plans],
            "cards": [p.cardinality for p in jplan.plans]}


def _build(packed, data=None):
    data = _data() if data is None else data
    jplan = JPlan(JTable.from_data(data, imcu_rows=700),
                  _features(JFeatureSet), packed=packed)
    plan = FeaturePlan(Table.from_data(data, imcu_rows=700),
                       _features(FeatureSet), packed=packed, device="cpu")
    return jplan, plan


@pytest.fixture(scope="module")
def packed_pair():
    jplan, plan = _build(packed=True)
    return JExecutor(jplan, use_kernel=True), jplan, plan


def _executors(packed_pair, source):
    jex, jplan, plan = packed_pair
    if source == "reference":
        plan = plan_from_reference(_reference_state(jplan), device="cpu")
    return jex, FeatureExecutor(plan)


def _eq(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plans_hold_identical_state(packed_pair):
    jex, jplan, plan = packed_pair
    assert plan.columns == jplan.columns and plan.n_rows == jplan.n_rows
    assert plan.device_bits == list(jplan.device_bits) == [1, 4, 8, 16]
    for w, jw in zip(plan.packed_words, jplan.packed_words):
        assert np.array_equal(w, np.asarray(jw))
    for p, jp in zip(plan.plans, jplan.plans):
        assert np.array_equal(p.fused_host, jp.fused_host)
    rows = np.random.default_rng(1).integers(0, N, 300)
    assert np.array_equal(plan.host_codes(rows), jplan.host_codes(rows))
    assert np.array_equal(plan.host_features(rows),
                          jplan.host_features(rows))
    assert plan.out_dim == jplan.out_dim
    assert plan.bytes_moved_adv(4096) == jplan.bytes_moved_adv(4096)
    assert plan.bytes_resident_codes() == jplan.bytes_resident_codes()
    assert plan.bytes_resident_tables() == jplan.bytes_resident_tables()
    assert plan.fused_tables().out_dim == jex.plan.fused_tables().out_dim


@pytest.mark.parametrize("source", ["data", "reference"])
def test_batch_range_matches_reference(packed_pair, source):
    jex, ex = _executors(packed_pair, source)
    for start, n in ((0, 256), (64, 100), (1920, 83), (1984, 19)):
        _eq(ex.batch_range(start, n), jex.batch_range(start, n))


@pytest.mark.parametrize("source", ["data", "reference"])
def test_multi_range_matches_reference(packed_pair, source):
    jex, ex = _executors(packed_pair, source)
    starts = [1024, 0, 1984, 512]
    got = ex._multi_range_future(starts, 64)
    assert got.shape == (4, 64, ex.plan.out_dim)
    _eq(got, jex._multi_range_future(starts, 64))


@pytest.mark.parametrize("source", ["data", "reference"])
def test_rows_and_batch_match_reference(packed_pair, source):
    jex, ex = _executors(packed_pair, source)
    rng = np.random.default_rng(2)
    rows = np.concatenate([[0, 31, 32, N - 1],
                           rng.integers(0, N, 252)]).astype(np.int32)
    _eq(ex._rows_future(rows), jex._rows_future(rows))
    for n in (1, 45, 300):
        idx = rng.integers(0, N, n)
        _eq(ex.batch(idx), jex.batch(idx))
    assert ex.batch(np.zeros(0, np.int64)).shape == (0, ex.plan.out_dim)
    with pytest.raises(IndexError):
        ex.batch(np.array([N]))


@pytest.mark.parametrize("source", ["data", "reference"])
def test_packed_batches_match_reference(packed_pair, source):
    jex, ex = _executors(packed_pair, source)
    got = list(ex.batches(256, seed=3, epochs=2))
    want = list(jex.batches(256, seed=3, epochs=2))
    assert len(got) == len(want) == 2 * (N // 256)
    for (gi, gf), (wi, wf) in zip(got, want):
        assert np.array_equal(gi, wi)
        _eq(gf, wf)


def test_int32_plan_gather_and_batches_match_reference():
    jplan, plan = _build(packed=False)
    jex, ex = JExecutor(jplan, use_kernel=True), FeatureExecutor(plan)
    assert np.array_equal(plan.codes_matrix, jplan.codes_matrix)
    rng = np.random.default_rng(4)
    codes = np.stack([rng.integers(-2, p.cardinality + 3, 200)
                      for p in plan.plans]).astype(np.int32)
    _eq(ex.gather_device(torch.from_numpy(codes)),
        jex.gather_device(jnp.asarray(codes)))
    idx = rng.integers(0, N, 333)
    _eq(ex.batch(idx), jex.batch(idx))
    for (gi, gf), (wi, wf) in zip(ex.batches(512, seed=5),
                                  jex.batches(512, seed=5)):
        assert np.array_equal(gi, wi)
        _eq(gf, wf)


@pytest.mark.parametrize("packed", [True, False])
def test_appends_past_capacity_match_reference(packed):
    """Inserts that grow dictionaries (one across a device-width boundary)
    and push n_rows past the stream's pad32 capacity: both packages refresh
    to the same state and serve the new rows identically — and a port plan
    rebuilt from the refreshed reference state serves them too."""
    data = _data()
    jplan, plan = _build(packed, data)
    jex = JExecutor(jplan, use_kernel=True)
    ex = FeatureExecutor(plan)
    cap0 = ex._capacity if packed else None
    rng = np.random.default_rng(6)
    new = {"flag": rng.integers(0, 3, 70), "device": rng.integers(0, 9, 70),
           "state": rng.integers(0, 40, 70), "zip": rng.integers(0, 1025, 70)}
    for col in plan.columns:
        codes = plan.augmented[col].dictionary.add_rows(new[col])
        assert np.array_equal(
            codes, jplan.augmented[col].dictionary.add_rows(new[col]))
        new[col] = codes
    assert plan.refresh(new) == jplan.refresh(new)
    assert plan.n_rows == jplan.n_rows == N + 70
    if packed:
        assert plan.device_bits == list(jplan.device_bits)
        assert plan.device_bits[0] == 2          # flag grew past one bit
        assert plan.stats["words_repacked"] == jplan.stats["words_repacked"]
    tail = np.arange(N - 10, N + 70)
    _eq(ex.batch(tail), jex.batch(tail))
    if packed:
        assert ex._capacity > cap0
        _eq(ex.batch_range(1984, N + 70 - 1984),
            jex.batch_range(1984, N + 70 - 1984))
        ref = FeatureExecutor(plan_from_reference(_reference_state(jplan),
                                                  device="cpu"))
        _eq(ref.batch(tail), jex.batch(tail))


def test_pipeline_facade_matches_reference_recompute():
    data = _data()
    jpipe = JPipeline(JTable.from_data(data), _features(JFeatureSet))
    pipe = FeaturePipeline(Table.from_data(data), _features(FeatureSet),
                           device="cpu")
    idx = np.random.default_rng(8).integers(0, N, 100)
    assert np.array_equal(pipe.batch_recompute(idx),
                          jpipe.batch_recompute(idx))
    _eq(pipe.batch(idx), jpipe.batch(idx))
    assert pipe.bytes_moved_adv(512) == jpipe.bytes_moved_adv(512)
    assert pipe.bytes_moved_recompute(512) == jpipe.bytes_moved_recompute(512)


def test_reference_state_is_checked():
    jplan, _ = _build(packed=True)
    state = _reference_state(jplan)
    bad = dict(state, cards=[k + 1 for k in state["cards"]])
    with pytest.raises(ValueError):
        plan_from_reference(bad, device="cpu")
    bad = dict(state, n_rows=state["n_rows"] * 40)
    with pytest.raises(ValueError):
        plan_from_reference(bad, device="cpu")
    with pytest.raises(RuntimeError):
        plan_from_reference(state, device="cpu").refresh()
