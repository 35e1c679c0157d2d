"""Port parity, the paper's Table 6 featurization path: the bit-unpack, the
count metadata (``hist``) and the single-table ADV gather, each through the
port's plain PyTorch version against the reference's Pallas kernel
(interpret mode), then the whole chain ``Column`` -> ``device_words`` ->
``bitunpack`` -> ``hist`` -> ``adv_gather`` over the ten catalog ADVs of
``benchmarks/bench_featurize.py``, and ``columnar/stats.py``.

Inputs are seeded numpy arrays handed to both packages; results must be
identical (``np.array_equal``): codes and counts are integers, and a
one-hot product with one nonzero term over a finite table is the table's
row. Where the reference's jnp oracle and its kernel differ (``hist_ref``
counts a negative code as code 0), the port follows the kernel.
``test_torch_kernels_cuda.py`` holds each CUDA kernel against its plain
version on a card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.columnar import Column as JColumn, Dictionary as JDictionary
from repro.columnar import stats as jstats
from repro.columnar.bitpack import pack_bits
from repro.core import AugmentedDictionary as JAugmentedDictionary
from repro.kernels.adv_gather import adv_gather as j_adv_gather
from repro.kernels.bitunpack import bitunpack as j_bitunpack
from repro.kernels.bitunpack import repack_for_device as j_repack
from repro.kernels.bitunpack.ops import device_overhead as j_overhead
from repro.kernels.hist import hist as j_hist
from repro.kernels.hist.ref import hist_ref as j_hist_ref
from repro_torch.columnar import Column, Dictionary
from repro_torch.columnar import stats
from repro_torch.core import AugmentedDictionary
from repro_torch.kernels import edge_cases
from repro_torch.kernels.adv_gather import adv_gather, ops as adv_ops
from repro_torch.kernels.bitunpack import bitunpack, repack_for_device
from repro_torch.kernels.bitunpack import ops as unpack_ops
from repro_torch.kernels.hist import hist, ops as hist_ops

K = 999                                   # bench_featurize.py:29
CATALOG = [                               # bench_featurize.py:850-862
    ("float", {}), ("onehot", {"max_cardinality": 4096}),
    ("minmax", {}), ("mean_norm", {}), ("zscore", {}),
    ("binarize", {"threshold": 500.0}),
    ("quantile", {"q": 4}), ("hash_bucket", {"n_buckets": 32}),
    ("bucketize", {"boundaries": np.linspace(0, K, 7)[1:-1]}),
    ("embedding", {"dim": 16}),
]


def _words(a: np.ndarray) -> torch.Tensor:
    """uint32 words as the port stores them: int32 storage."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32))


def _both_unpack(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    want = np.asarray(j_bitunpack(jnp.asarray(words), bits, n))
    got = bitunpack(_words(words), bits, n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    return want


# -- bitunpack -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 31, 512, 4097])
def test_bitunpack_sweep_matches_pallas(bits, n):
    """``test_kernels.py``'s sweep: codes packed at every divisor width."""
    rng = np.random.default_rng(bits * 100 + n)
    codes = rng.integers(0, min(1 << bits, 1 << 31), size=n)
    assert np.array_equal(_both_unpack(pack_bits(codes, bits), bits, n),
                          codes)


@pytest.mark.parametrize("case", ["extra_words", "extra_block",
                                  "fields_past_2**31", "short_words",
                                  "no_codes"])
def test_bitunpack_edges_match_pallas(case):
    """Words past the n codes (a whole stream queried for a prefix, and one
    block past the padded width), random 32-bit fields >= 2**31 (negative
    int32 codes), codes past the last word (zero words) and n = 0."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=4096)
    words = pack_bits(codes, 8)                                 # 1024 words
    if case == "extra_words":
        assert np.array_equal(_both_unpack(words, 8, 100), codes[:100])
    elif case == "extra_block":
        padded = np.concatenate([words, np.zeros(512, np.uint32)])
        assert np.array_equal(_both_unpack(padded, 8, 4096), codes)
    elif case == "fields_past_2**31":
        raw = rng.integers(0, 1 << 32, 700, dtype=np.uint64).astype(np.uint32)
        raw[:2] = (0xFFFFFFFF, 1 << 31)
        got = _both_unpack(raw, 32, 700)
        assert np.array_equal(got, raw.view(np.int32))
        assert got[0] == -1 and got[1] == -(1 << 31)
    elif case == "short_words":
        got = _both_unpack(np.array([0xFFFFFFFF, 5], np.uint32), 32, 3)
        assert got.tolist() == [-1, 5, 0]
        got = _both_unpack(words[:3], 8, 20)
        assert np.array_equal(got[:12], codes[:12]) and not got[12:].any()
    else:
        assert _both_unpack(words, 16, 0).shape == (0,)


@pytest.mark.parametrize("bits", [0, 3, 5, 6, 7, 9, 17, 31])
def test_bitunpack_refuses_non_divisor_widths(bits):
    """A width that does not divide 32 raises ``ValueError`` in the port;
    the reference raises too (``ValueError``, or a division by zero at 0)."""
    words = np.arange(8, dtype=np.uint32)
    with pytest.raises((ValueError, ZeroDivisionError)):
        j_bitunpack(jnp.asarray(words), bits, 4)
    with pytest.raises(ValueError):
        bitunpack(_words(words), bits, 4)


@pytest.mark.parametrize("bits", [1, 3, 6, 10, 17, 32])
def test_repack_for_device_matches_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, min(1 << bits, 1 << 31), size=1000)
    words, db = repack_for_device(codes, bits)
    jwords, jdb = j_repack(codes, bits)
    assert db == jdb and words.dtype == np.uint32
    assert np.array_equal(words, np.asarray(jwords))
    assert unpack_ops.device_overhead(bits, 1000) == j_overhead(bits, 1000)
    assert np.array_equal(_both_unpack(words, db, 1000), codes)


# -- hist ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(1, 2), (100, 7), (4096, 512),
                                 (10000, 1000)])
def test_hist_sweep_matches_pallas(n, k):
    rng = np.random.default_rng(n + k)
    codes = rng.integers(0, k, size=n).astype(np.int32)
    want = np.asarray(j_hist(jnp.asarray(codes), k))
    got = hist(torch.from_numpy(codes), k)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(j_hist_ref(codes, k)))


@pytest.mark.parametrize("shape", [(9,), (3000,), (40, 75), (0,)])
def test_hist_out_of_range_and_2d_codes_match_pallas(shape):
    """Codes below 0 and >= k are dropped, as the Pallas kernel drops them;
    codes of any shape count as their flattening."""
    rng = np.random.default_rng(sum(shape))
    if shape == (9,):
        codes = np.array([-1, 0, 1, 2, 5, 7, 1023, 1024, 3], np.int32)
    else:
        codes = rng.integers(-20, 70, size=shape).astype(np.int32)
    k = 6 if shape == (9,) else 50
    want = np.asarray(j_hist(jnp.asarray(codes), k))
    got = hist(torch.from_numpy(codes), k).numpy()
    assert np.array_equal(got, want)
    if shape == (9,):
        assert got.tolist() == [1, 1, 1, 1, 0, 1]
        # the reference's jnp oracle counts -1 as code 0; the kernel does not
        assert np.asarray(j_hist_ref(jnp.asarray(codes), k))[0] == 2


# -- adv_gather ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 256, 1000])
@pytest.mark.parametrize("k,f", [(4, 1), (50, 3), (513, 17), (2048, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adv_gather_sweep_matches_pallas(n, k, f, dtype):
    """``test_kernels.py``'s sweep in float32 and bfloat16."""
    rng = np.random.default_rng(n * 1000 + k + f)
    table = rng.standard_normal((k, f)).astype(np.float32)
    codes = rng.integers(0, k, size=n).astype(np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    if dtype == "bfloat16":
        jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    want = np.asarray(j_adv_gather(jt, jnp.asarray(codes)), np.float32)
    got = adv_gather(tt, torch.from_numpy(codes))
    assert got.dtype == tt.dtype and got.shape == (n, f)
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("k", edge_cases.ADV_SHAPE_KS)
@pytest.mark.parametrize("f", edge_cases.ADV_SHAPE_FS)
def test_adv_gather_row_shapes_match_pallas(k, f):
    """``edge_cases.adv_gather_shape_cases`` (the card's edge sets for the
    vector and row paths): n in {1, 3, 5, 4097} and ``codes[1:]`` views,
    float32 and bfloat16, codes past both edges and the int32 ends."""
    for table, codes in edge_cases.adv_gather_shape_cases(
            np.random.default_rng(k + f), "cpu", ks=(k,), fs=(f,)):
        jt = jnp.asarray(table.float().numpy())
        if table.dtype == torch.bfloat16:
            jt = jt.astype(jnp.bfloat16)
        want = np.asarray(j_adv_gather(jt, jnp.asarray(codes.numpy())),
                          np.float32)
        got = adv_gather(table, codes)
        assert got.dtype == table.dtype and got.shape == want.shape
        assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("case", ["2d", "k_2**17", "out_of_range",
                                  "no_codes"])
def test_adv_gather_shapes_and_clamps_match_pallas(case):
    """2-D codes, K = 2**17 (the reference's ``jnp.take`` route past
    K = 2**16; one kernel here), codes below 0 and >= K clamped to the
    table's edge rows (with the int32 ends), and no codes."""
    rng = np.random.default_rng(5)
    k = 1 << 17 if case == "k_2**17" else 300
    table = rng.standard_normal((k, 4)).astype(np.float32)
    if case == "out_of_range":
        codes = rng.integers(-400, k + 400, size=(500,)).astype(np.int32)
        codes[:2] = (-(1 << 31), (1 << 31) - 1)
    elif case == "no_codes":
        codes = np.zeros((0, 3), np.int32)
    else:
        codes = rng.integers(0, k, size=(8, 16)).astype(np.int32)
    want = np.asarray(j_adv_gather(jnp.asarray(table), jnp.asarray(codes)))
    got = adv_gather(torch.from_numpy(table), torch.from_numpy(codes))
    assert got.shape == codes.shape + (4,) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), table[np.clip(codes, 0, k - 1)])


def test_table6_wrappers_reject_what_the_kernels_do_not_take():
    table = torch.zeros((5, 2))
    codes = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        adv_gather(table.double(), codes)
    with pytest.raises(TypeError):
        adv_gather(table, codes.long())
    with pytest.raises(ValueError):
        adv_gather(table, torch.arange(8, dtype=torch.int32)[::2])
    with pytest.raises(ValueError):
        adv_gather(torch.zeros((0, 2)), codes)
    with pytest.raises(ValueError):
        adv_gather(table, codes.to("meta"))
    with pytest.raises(TypeError):
        hist(codes.long(), 4)
    with pytest.raises(ValueError):
        hist(codes, 0)
    with pytest.raises(TypeError):
        bitunpack(codes.long(), 8, 4)
    with pytest.raises(ValueError):
        bitunpack(codes.reshape(2, 2), 8, 4)
    with pytest.raises(ValueError):
        bitunpack(codes, 8, -1)


def test_cpu_wrappers_run_plain_versions_without_launches():
    for ops in (adv_ops, hist_ops, unpack_ops):
        ops.reset_launches()
    codes = torch.arange(4, dtype=torch.int32)
    adv_gather(torch.ones((5, 2)), codes)
    hist(codes, 4)
    bitunpack(codes, 8, 16)
    assert adv_ops.LAUNCHES["adv_gather"] == 0
    assert hist_ops.LAUNCHES["hist"] == 0
    assert unpack_ops.LAUNCHES == {"bitunpack": 0}


# -- the whole path -----------------------------------------------------------------


@pytest.fixture(scope="module")
def table6():
    """``bench_featurize.run``'s column at a small N in both packages (IMCUs
    of 1,024 rows, so the device words join several IMCUs), with the ten
    catalog ADVs and ``zscore`` on each package's dictionary."""
    data = np.random.default_rng(3).integers(0, K, 3000)
    jd, jcodes = JDictionary.from_data(data)
    d, codes = Dictionary.from_data(data)
    jcol, col = JColumn(jd, jcodes, imcu_rows=1024), Column(d, codes,
                                                            imcu_rows=1024)
    jaug, aug = JAugmentedDictionary(jd), AugmentedDictionary(d)
    for kind, params in CATALOG:
        jaug.add(f"b_{kind}", kind, **params)
        aug.add(f"b_{kind}", kind, **params)
    jaug.add("zscore", "zscore")
    aug.add("zscore", "zscore")
    return jcol, col, jaug, aug, codes


def test_table6_chain_matches_reference_and_featurize(table6):
    """``Column.device_words`` -> ``bitunpack`` -> ``hist`` ->
    ``adv_gather`` of each catalog ADV, in both packages: equal words,
    codes, counts (= ``Dictionary.counts``) and features, and the features
    equal ``AugmentedDictionary.featurize`` of the host codes."""
    jcol, col, jaug, aug, host_codes = table6
    n = col.n_rows
    (jwords, jdb), (words, db) = jcol.device_words(), col.device_words()
    assert (db, col.dictionary.bits) == (jdb, 10) == (16, 10)
    assert np.array_equal(words, np.asarray(jwords))
    jcodes = j_bitunpack(jnp.asarray(jwords), jdb, n)
    codes = bitunpack(_words(words), db, n)
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(codes.numpy(), host_codes)
    k = col.dictionary.cardinality
    counts = hist(codes, k)
    assert np.array_equal(counts.numpy(), np.asarray(j_hist(jcodes, k)))
    assert np.array_equal(counts.numpy(), col.dictionary.counts)
    assert len(aug.advs) == len(CATALOG) + 1
    for name, adv in aug.advs.items():
        assert np.array_equal(adv.table, jaug[name].table), name
        got = adv_gather(torch.from_numpy(adv.table), codes).numpy()
        want = np.asarray(j_adv_gather(jnp.asarray(jaug[name].table),
                                       jcodes))
        assert got.shape == (n, adv.dim) and np.array_equal(got, want), name
        assert np.array_equal(got, aug.featurize(name, host_codes)), name


def test_packed_codes_to_features_end_to_end_matches_reference():
    """``test_kernels.py``'s end-to-end case: repack at 6 -> 8 bits,
    unpack, gather."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 50, size=777)
    table = rng.standard_normal((50, 9)).astype(np.float32)
    words, db = repack_for_device(codes, 6)
    dev_codes = bitunpack(_words(words), db, 777)
    feats = adv_gather(torch.from_numpy(table), dev_codes).numpy()
    jwords, jdb = j_repack(codes, 6)
    want = np.asarray(j_adv_gather(jnp.asarray(table),
                                   j_bitunpack(jnp.asarray(jwords), jdb,
                                               777)))
    assert np.array_equal(feats, want) and np.array_equal(feats,
                                                          table[codes])


def test_stats_match_reference_and_scans(table6):
    """``columnar/stats.py``: each dictionary statistic equals the
    reference's on the same column, and its scan baseline (``std`` within
    float64 rounding: two summation orders)."""
    jcol, col, *_ = table6
    for op in ("sum", "mean", "std", "minmax"):
        fast = getattr(stats, f"{op}_from_dictionary")(col)
        assert fast == getattr(jstats, f"{op}_from_dictionary")(jcol), op
        assert getattr(stats, f"{op}_scan")(col) == \
            getattr(jstats, f"{op}_scan")(jcol), op
        slow = getattr(stats, f"{op}_scan")(col)
        if op == "std":
            assert fast == pytest.approx(slow, rel=1e-12)
        else:
            assert fast == slow, op
    for fn in ("histogram_from_dictionary", "histogram_scan"):
        (v, c), (jv, jc) = getattr(stats, fn)(col), getattr(jstats, fn)(jcol)
        assert np.array_equal(v, jv) and np.array_equal(c, jc), fn
    v, c = stats.histogram_from_dictionary(col)
    assert dict(zip(v.tolist(), c.tolist())) == \
        dict(zip(*(a.tolist() for a in stats.histogram_scan(col))))
