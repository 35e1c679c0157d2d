"""Port parity, columnar host layer: ``repro_torch`` against ``repro``.

The same seeded data goes through both packages; dictionaries, packed IMCU
words, RLE choices, device-width views and ADV tables must be identical
(``np.array_equal``), as must the tensor unpack/decode oracles.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.columnar import Column as JColumn, Table as JTable
from repro.columnar import bitpack as jbitpack, rle as jrle
from repro.core import FeatureSet as JFeatureSet
from repro.kernels.bitunpack.kernel import DIVISOR_WIDTHS as J_WIDTHS
from repro.kernels.bitunpack.kernel import tpu_width as j_tpu_width
from repro.serve import classes as jclasses
from repro_torch.columnar import Column, Table
from repro_torch.columnar import bitpack, rle
from repro_torch.core import FeatureSet
from repro_torch.kernels.bitunpack.kernel import DIVISOR_WIDTHS, tpu_width
from repro_torch.serve import classes


def _column_data(rng, bits, n):
    """Integer column whose dictionary needs exactly ``bits`` bits."""
    k = 2 if bits == 1 else (1 << (bits - 1)) + 1
    return np.concatenate([np.arange(k), rng.integers(0, k, n - k)])


def _assert_columns_equal(jc, tc):
    jd, td = jc.dictionary, tc.dictionary
    assert np.array_equal(jd.values, td.values)
    assert np.array_equal(jd.counts, td.counts)
    assert jd.bits == td.bits and jc.n_imcus == tc.n_imcus
    for jm, tm in zip(jc._imcus, tc._imcus):
        assert (jm.n, jm.code_min, jm.code_max) == (tm.n, tm.code_min,
                                                    tm.code_max)
        assert (jm.rle is None) == (tm.rle is None)
        if jm.rle is None:
            assert np.array_equal(jm.packed, tm.packed)
        else:
            assert all(np.array_equal(a, b) for a, b in zip(jm.rle, tm.rle))
    for i in range(jc.n_imcus):
        assert np.array_equal(jc.imcu_device_words(i),
                              tc.imcu_device_words(i))
    jw, jdb = jc.device_words()
    tw, tdb = tc.device_words()
    assert jdb == tdb and np.array_equal(jw, tw)
    assert np.array_equal(jc.codes(), tc.codes())
    assert jc.total_nbytes == tc.total_nbytes


@pytest.mark.parametrize("bits", range(1, 17))
def test_column_layout_matches_reference(bits):
    """Every width 1-16, several IMCUs with an unaligned tail (1000-row
    IMCUs), sorted and load-order codes, runs that RLE can win."""
    rng = np.random.default_rng(bits)
    n = max(3000, (1 << (bits - 1)) + 1501)
    data = _column_data(rng, bits, n)
    data[100:700] = data[99]                  # a long run for RLE
    for sort_values in (False, True):
        jc = JColumn.from_data(data, sort_values=sort_values, imcu_rows=1000)
        tc = Column.from_data(data, sort_values=sort_values, imcu_rows=1000)
        _assert_columns_equal(jc, tc)


def test_device_view_repack_when_imcu_not_word_aligned():
    """IMCU sizes that are not multiples of 32/db force the whole-column
    repack branch of ``device_words``."""
    rng = np.random.default_rng(0)
    data = _column_data(rng, 3, 2000)
    jc = JColumn.from_data(data, use_rle=False, imcu_rows=333)
    tc = Column.from_data(data, use_rle=False, imcu_rows=333)
    _assert_columns_equal(jc, tc)


@pytest.mark.parametrize("bits", [1, 3, 5, 7, 8, 11, 13, 16, 17, 31, 32])
def test_bitpack_and_tensor_unpack_match_reference(bits):
    """Straddling fields at every non-divisor width; the torch unpack
    equals both the host unpack and the reference's jnp oracle."""
    rng = np.random.default_rng(bits)
    n = 1001
    codes = rng.integers(0, 1 << bits, n, dtype=np.uint64)
    words = bitpack.pack_bits(codes, bits)
    assert np.array_equal(words, jbitpack.pack_bits(codes, bits))
    host = bitpack.unpack_bits(words, bits, n)
    assert np.array_equal(host, jbitpack.unpack_bits(words, bits, n))
    got = bitpack.unpack_bits_torch(torch.from_numpy(words.view(np.int32)),
                                    bits, n).numpy()
    want = np.asarray(jbitpack.unpack_bits_jnp(jnp.asarray(words), bits, n))
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)
    assert bitpack.packed_nbytes(n, bits) == jbitpack.packed_nbytes(n, bits)
    assert bitpack.bits_needed(1 << bits) == jbitpack.bits_needed(1 << bits)


@pytest.mark.parametrize("db", DIVISOR_WIDTHS)
def test_packed_gather_matches_reference(db):
    rng = np.random.default_rng(db)
    words = rng.integers(0, 1 << 32, 97, dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(0, 97 * (32 // db), 500)
    assert np.array_equal(bitpack.packed_gather(words, db, rows),
                          jbitpack.packed_gather(words, db, rows))


def test_device_widths_match_reference():
    assert DIVISOR_WIDTHS == J_WIDTHS
    assert [tpu_width(b) for b in range(1, 33)] == \
        [j_tpu_width(b) for b in range(1, 33)]
    with pytest.raises(ValueError):
        tpu_width(33)


@pytest.mark.parametrize("seed", range(4))
def test_rle_matches_host_decode(seed):
    """RLE encode is byte-identical; the torch decode is held against the
    host ``rle_decode`` (the reference's jnp decode is not an oracle)."""
    rng = np.random.default_rng(seed)
    codes = np.repeat(rng.integers(0, 50, 80), rng.integers(1, 40, 80))
    values, lengths = rle.rle_encode(codes)
    jv, jl = jrle.rle_encode(codes)
    assert np.array_equal(values, jv) and np.array_equal(lengths, jl)
    host = jrle.rle_decode(jv, jl)
    assert np.array_equal(rle.rle_decode(values, lengths), host)
    got = rle.rle_decode_torch(torch.from_numpy(values),
                               torch.from_numpy(lengths), codes.size)
    assert np.array_equal(got.numpy(), host)
    assert rle.rle_nbytes(values, lengths, 6) == jrle.rle_nbytes(jv, jl, 6)


def _mixed_data(rng, n):
    return {"age": rng.integers(18, 90, n),
            "state": np.array(["CA", "OR", "WA", "NY", "TX"])[
                rng.integers(0, 5, n)],
            "income": rng.integers(20, 250, n) * 1000,
            "device": rng.integers(0, 4, n)}


def _all_kinds(fs_cls):
    return (fs_cls().add("age", "float").add("age", "minmax")
            .add("age", "mean_norm").add("age", "zscore").add("age", "log")
            .add("age", "binarize", threshold=40.0)
            .add("age", "quantile", q=4)
            .add("age", "bucketize", boundaries=(30.0, 45.0, 65.0))
            .add("state", "onehot").add("state", "hash_bucket", n_buckets=7)
            .add("state", "bucketize_cat", mapping={"CA": 1.0, "OR": 1.0,
                                                    "NY": 2.0})
            .add("income", "embedding", dim=3, seed=5)
            .add("income", "hash_bucket", n_buckets=11)
            .add("device", "onehot"))


def test_adv_tables_and_table_match_reference():
    """Every featurization kind yields the identical ADV table, and the
    table-level accounting agrees."""
    rng = np.random.default_rng(7)
    data = _mixed_data(rng, 2500)
    jt = JTable.from_data(data, imcu_rows=700)
    tt = Table.from_data(data, imcu_rows=700)
    assert jt.names == tt.names and jt.n_rows == tt.n_rows
    assert jt.total_nbytes == tt.total_nbytes
    assert jt.summary() == tt.summary()
    for name in jt.names:
        _assert_columns_equal(jt[name], tt[name])
    jaug = _all_kinds(JFeatureSet).build(jt)
    taug = _all_kinds(FeatureSet).build(tt)
    assert list(jaug) == list(taug)
    for col in jaug:
        assert list(jaug[col].advs) == list(taug[col].advs)
        for name, jadv in jaug[col].advs.items():
            tadv = taug[col].advs[name]
            assert jadv.table.dtype == tadv.table.dtype == np.float32
            assert np.array_equal(jadv.table, tadv.table), name


def test_adv_maintenance_after_inserts_matches_reference():
    """Inserts that grow a dictionary (and ones that only shift counts)
    refresh the same ADV tables in both packages."""
    rng = np.random.default_rng(3)
    data = _mixed_data(rng, 1200)
    jt, tt = JTable.from_data(data), Table.from_data(data)
    fs_j = JFeatureSet().add("age", "zscore").add("age", "quantile", q=3)
    fs_t = FeatureSet().add("age", "zscore").add("age", "quantile", q=3)
    jaug, taug = fs_j.build(jt)["age"], fs_t.build(tt)["age"]
    for new in (np.array([18, 19, 20]), np.array([91, 95, 99, 91])):
        assert np.array_equal(jaug.dictionary.add_rows(new),
                              taug.dictionary.add_rows(new))
        jaug.extend_for_new_codes()
        taug.extend_for_new_codes()
        assert jaug.version == taug.version
        for name in jaug.advs:
            assert np.array_equal(jaug[name].table, taug[name].table)


def test_request_classes_and_histogram_match_reference():
    assert classes.default_classes() == tuple(
        classes.RequestClass(**vars(rc)) for rc in jclasses.default_classes())
    rng = np.random.default_rng(0)
    samples = rng.lognormal(-6, 1.5, 3000)
    jh, th = jclasses.LatencyHistogram(), classes.LatencyHistogram()
    for s in samples:
        jh.record(float(s))
        th.record(float(s))
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert th.summary() == jh.summary()
