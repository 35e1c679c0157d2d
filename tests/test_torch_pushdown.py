"""Port parity, predicate pushdown: ``repro_torch`` against ``repro``.

The same numpy-seeded inputs go through the JAX function and its port
counterpart; every result must be equal (``np.array_equal``):

- (a) the predicate compiler and the rest of ``columnar/query.py``;
- (b) the scan's plain version against the reference's Pallas kernel
  (interpret mode) and its split route, with the match count;
- (c) bitmap compaction;
- (d) masked per-code counts against both reference routes;
- (e) the executor's pushdown methods against the reference executor
  (``use_kernel`` True and False) and the host reference, over a plan the
  port builds and over one carried across from reference state, including
  appends past the stream's pad32 capacity.

The port runs the plain versions of its CUDA kernels on CPU tensors; the
kernels themselves are held against those plain versions on a card
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.columnar import Table as JTable
from repro.columnar import query as JQ
from repro.columnar.dictionary import Dictionary as JDictionary
from repro.core import (FeatureExecutor as JExecutor, FeaturePlan as JPlan,
                        FeatureSet as JFeatureSet)
from repro.kernels.predicate_scan import ops as jscan
from repro_torch.columnar import Table
from repro_torch.columnar import query as Q
from repro_torch.columnar.dictionary import Dictionary
from repro_torch.core import (FeatureExecutor, FeaturePlan, FeatureSet,
                              plan_from_reference)
from repro_torch.core.pipeline import _pad32
from repro_torch.kernels import edge_cases
from repro_torch.kernels.predicate_scan import ops as scan_ops
from repro_torch.kernels.predicate_scan import ref as scan_ref
from repro_torch.kernels.hist import ref as hist_ref

DBS = (1, 2, 4, 8, 16, 32)


# -- fixtures -------------------------------------------------------------------


def _data(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return {"age": rng.integers(18, 91, n), "state": rng.integers(0, 51, n),
            "income": np.round(rng.lognormal(10, 1, n), -2),
            "device": rng.integers(0, 5, n)}


def _features(fs_cls):
    return (fs_cls().add("age", "zscore").add("state", "onehot")
            .add("income", "minmax").add("income", "log")
            .add("device", "onehot"))


def _tables(data, imcu_rows=700):
    return (JTable.from_data(data, imcu_rows=imcu_rows),
            Table.from_data(data, imcu_rows=imcu_rows))


def _plans(data, packed=True):
    jt, t = _tables(data)
    return (JPlan(jt, _features(JFeatureSet), packed=packed),
            FeaturePlan(t, _features(FeatureSet), packed=packed,
                        device="cpu"))


def _preds(q):
    """Predicates over the fixture's columns, built with the package ``q``:
    both kinds, both combinators, two terms on one column, empty and full
    selections."""
    return [
        q.isin("state", [3, 7, 11]) & q.gt("age", 60),
        q.between("age", 30, 45) | q.eq("device", 2),
        q.eq("state", 7) & q.between("age", 30, 45),
        q.isin("device", [1, 3]) | q.ge("income", 60000.0),
        q.ge("age", 20) & q.le("age", 70) & q.isin("state", [1, 2, 40]),
        q.eq("state", 12345),
        q.ge("age", 0),
        q.lt("income", 5000.0) | q.eq("state", 12345),
    ]


# -- (a) the predicate compiler and query.py ---------------------------------------


def _same_compiled(cp, jcp):
    assert cp.combine == jcp.combine and len(cp.terms) == len(jcp.terms)
    for t, jt in zip(cp.terms, jcp.terms):
        assert (t.column, t.kind, t.lo, t.hi) == \
            (jt.column, jt.kind, jt.lo, jt.hi)
        assert np.array_equal(t.match, jt.match)
        assert (t.lut is None) == (jt.lut is None)
        if t.lut is not None:
            assert t.lut.dtype == jt.lut.dtype == np.int32
            assert np.array_equal(t.lut, jt.lut)


@pytest.mark.parametrize("i", range(8))
def test_compile_predicate_matches_reference(i):
    jt, t = _tables(_data())
    cp = Q.compile_predicate(_preds(Q)[i],
                             {c: t[c].dictionary for c in t.columns})
    jcp = JQ.compile_predicate(_preds(JQ)[i],
                               {c: jt[c].dictionary for c in jt.columns})
    _same_compiled(cp, jcp)


def test_compile_predicate_kinds_and_errors():
    jt, t = _tables(_data())
    dicts = {c: t[c].dictionary for c in t.columns}
    jdicts = {c: jt[c].dictionary for c in jt.columns}
    (term,) = Q.compile_predicate(Q.eq("device", 2), dicts).terms
    assert term.kind == 0 and term.lo == term.hi
    (term,) = Q.compile_predicate(Q.isin("state", [1, 17, 40]), dicts).terms
    assert term.kind == 1 and term.match.shape == (3,)
    (term,) = Q.compile_predicate(Q.eq("device", 99), dicts).terms
    assert term.kind == 0 and term.hi < term.lo
    # a range over a sorted dictionary is a contiguous code range
    data = np.arange(100) % 37
    d, _ = Dictionary.from_data(data, sort_values=True)
    jd, _ = JDictionary.from_data(data, sort_values=True)
    cp = Q.compile_predicate(Q.between("x", 5, 11), {"x": d})
    assert cp.terms[0].kind == 0
    _same_compiled(cp, JQ.compile_predicate(JQ.between("x", 5, 11),
                                            {"x": jd}))
    for q, ds in ((Q, dicts), (JQ, jdicts)):
        with pytest.raises(KeyError):
            q.compile_predicate(q.eq("nope", 1), ds)
        with pytest.raises(ValueError):
            (q.eq("a", 1) & q.eq("b", 2)) | q.eq("c", 3)
        with pytest.raises(ValueError):
            (q.eq("a", 1) | q.eq("b", 2)) & q.eq("c", 3)
        with pytest.raises(TypeError):
            q.compile_predicate("age > 3", ds)
    p = Q.eq("a", 1) & Q.eq("b", 2) & Q.eq("c", 3)
    assert p.op == "and" and len(p.parts) == 3


@pytest.mark.parametrize("i", range(8))
def test_host_mask_matches_reference(i):
    jt, t = _tables(_data())
    got = Q.predicate_mask_host(t, _preds(Q)[i])
    want = JQ.predicate_mask_host(jt, _preds(JQ)[i])
    assert got.dtype == bool and np.array_equal(got, want)
    fm = Q.filter_mask(t["age"], lambda v: v > 50)
    assert np.array_equal(fm, JQ.filter_mask(jt["age"], lambda v: v > 50))


def test_query_aggregates_and_join_match_reference():
    data = _data()
    jt, t = _tables(data)
    mask = np.random.default_rng(3).integers(0, 2, 4000).astype(bool)
    for got, want in zip(Q.groupby_count(t["state"]),
                         JQ.groupby_count(jt["state"])):
        assert np.array_equal(got, want)
    for agg in ("sum", "mean", "count"):
        for m in (None, mask):
            for got, want in zip(
                    Q.groupby_agg(t["device"], t["age"], agg, mask=m),
                    JQ.groupby_agg(jt["device"], jt["age"], agg, mask=m)):
                assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        Q.groupby_agg(t["device"], t["age"], "median")
    rng = np.random.default_rng(4)
    left, right = rng.integers(0, 12, 150), rng.integers(4, 18, 90)
    (jl, lt), (jr, rt) = _tables({"k": left}), _tables({"k": right})
    for got, want in zip(Q.join_codes(lt["k"], rt["k"]),
                         JQ.join_codes(jl["k"], jr["k"])):
        assert np.array_equal(got, want)


# -- (b) the scan -------------------------------------------------------------------


def _stream(rng, n, cap_extra=0, code_hi=None):
    """Six columns at widths 1-32, each at a capacity of pad32(n) +
    cap_extra rows, back to back. Column c's codes are random below
    2**db (below ``code_hi[c]`` where given)."""
    cap = _pad32(n) + cap_extra
    words, offs, codes_of, off = [], [], [], 0
    for c, db in enumerate(DBS):
        hi = (1 << db) if code_hi is None or code_hi[c] is None \
            else code_hi[c]
        codes = rng.integers(0, hi, cap, dtype=np.int64)
        w = np.zeros(cap * db // 32, np.uint64)
        s = 32 // db
        for j in range(s):
            w |= codes[j::s].astype(np.uint64) << np.uint64(j * db)
        words.append(w.astype(np.uint32))
        offs.append(off)
        off += w.size
        codes_of.append(codes)
    flat = np.concatenate(words)
    return flat, tuple(offs), codes_of


def _port_stream(flat, offs):
    return (torch.from_numpy(flat.view(np.int32).copy()),
            torch.tensor(list(zip(offs, DBS)), dtype=torch.int32))


def _random_terms(rng, n_terms, code_hi):
    """(port terms, reference terms): both kinds, columns at every width;
    LUTs sometimes shorter than the column's code range (the clamp)."""
    terms, jterms = [], []
    for _ in range(n_terms):
        c = int(rng.integers(0, len(DBS)))
        k = code_hi[c]
        if rng.integers(0, 2):
            lo = int(rng.integers(0, k))
            hi = int(rng.integers(lo - 2, k + 2))       # may be empty
            terms.append(scan_ops.ScanTerm(col=c, kind=0, lo=lo, hi=hi))
            jterms.append(jscan.ScanTerm(col=c, kind=0, lo=lo, hi=hi))
        else:
            size = int(rng.integers(1, k + 1)) if rng.integers(0, 2) else k
            lut = (rng.random(size) < 0.5).astype(np.int32)
            terms.append(scan_ops.ScanTerm(col=c, kind=1, lut=lut))
            jterms.append(jscan.ScanTerm(col=c, kind=1, lut=lut))
    if n_terms >= 2:                   # two terms on one column
        terms[-1] = scan_ops.ScanTerm(col=terms[0].col, kind=0, lo=0,
                                      hi=code_hi[terms[0].col] // 2)
        jterms[-1] = jscan.ScanTerm(col=terms[0].col, kind=0, lo=0,
                                    hi=code_hi[terms[0].col] // 2)
    return terms, jterms


# 32-bit fields stay below 2**31 here: above it the code is negative, where
# the reference's two routes disagree with each other for LUT terms (see
# test_negative_codes_follow_the_documented_semantics for the port's rule)
CODE_HI = (2, 4, 16, 200, 3000, 70000)


def _scan_both(flat, offs, terms, jterms, n, combine):
    words, wmeta = _port_stream(flat, offs)
    packed = scan_ops.pack_terms(terms, DBS, "cpu")
    mask, count = scan_ops.predicate_scan(words, wmeta, packed, n, combine)
    jflat = jnp.asarray(flat)
    kern = np.asarray(jscan.predicate_scan(jflat, offs, DBS, jterms, n,
                                           combine, bn=128, interpret=True))
    split, jcount = jscan.predicate_scan_split_count(jflat, offs, DBS,
                                                     jterms, n, combine)
    return mask, count, kern, np.asarray(split), int(jcount)


@pytest.mark.parametrize("seed", range(10))
def test_scan_matches_reference(seed):
    """1-4 random terms of both kinds over widths 1-32, AND and OR, n off
    every multiple of 32, a stream whose capacity reaches past n."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 900)) | 1
    flat, offs, _ = _stream(rng, n, cap_extra=64, code_hi=CODE_HI)
    terms, jterms = _random_terms(rng, int(rng.integers(1, 5)), CODE_HI)
    combine = ("and", "or")[seed % 2]
    mask, count, kern, split, jcount = _scan_both(flat, offs, terms, jterms,
                                                  n, combine)
    assert mask.dtype == torch.bool and mask.shape == (n,)
    assert np.array_equal(mask.numpy(), kern)
    assert np.array_equal(mask.numpy(), split)
    assert int(count) == jcount == int(mask.sum())


@pytest.mark.parametrize("combine", ["and", "or"])
def test_scan_empty_full_and_clamp(combine):
    """Empty and full selections, a LUT shorter than the code range, and a
    count over [0, n) only: the stream's capacity tail matches too, and
    must not be counted."""
    rng = np.random.default_rng(11)
    n = 333
    flat, offs, codes = _stream(rng, n, cap_extra=96, code_hi=CODE_HI)
    k = CODE_HI[3]
    cases = [
        [(0, 1, 0), (3, 0, k - 1)],                       # empty AND full
        [(3, 0, k - 1)],                                  # full
        [(5, 0, CODE_HI[5])],
        [(2, 1, -1)],                                     # lo > hi: empty
    ]
    for spec in cases:
        terms = [scan_ops.ScanTerm(col=c, kind=0, lo=lo, hi=hi)
                 for c, lo, hi in spec]
        jterms = [jscan.ScanTerm(col=c, kind=0, lo=lo, hi=hi)
                  for c, lo, hi in spec]
        mask, count, kern, split, jcount = _scan_both(flat, offs, terms,
                                                      jterms, n, combine)
        assert np.array_equal(mask.numpy(), kern)
        assert np.array_equal(mask.numpy(), split)
        assert int(count) == jcount == int(mask.sum())
    # a 3-entry LUT over 8-bit codes: every code >= 2 probes entry 2
    lut = np.array([0, 1, 1], np.int32)
    mask, count, kern, split, jcount = _scan_both(
        flat, offs, [scan_ops.ScanTerm(col=3, kind=1, lut=lut)],
        [jscan.ScanTerm(col=3, kind=1, lut=lut)], n, combine)
    assert np.array_equal(mask.numpy(), kern)
    assert np.array_equal(mask.numpy(), codes[3][:n] >= 1)
    assert int(count) == jcount
    # full selection: n matches, none from the capacity tail
    full = [scan_ops.ScanTerm(col=c, kind=0, lo=0, hi=CODE_HI[c])
            for c in range(len(DBS))]
    words, wmeta = _port_stream(flat, offs)
    mask, count = scan_ops.predicate_scan(
        words, wmeta, scan_ops.pack_terms(full, DBS, "cpu"), n, combine)
    assert bool(mask.all()) and int(count) == n


# the card's layout cases, one test per (layout, term set)
_LAYOUT_CASES = len(edge_cases.SCAN_LAYOUT_GAPS) * len(
    edge_cases.scan_layout_term_sets(np.random.default_rng(0)))


@pytest.mark.parametrize("i", range(_LAYOUT_CASES))
def test_scan_layout_cases_match_reference(i):
    """``edge_cases.scan_layout_cases`` (the card's edge sets for the
    word-major kernel): column word offsets off every multiple of 4, every
    width under both kinds, bounds below 0, past 2**db and empty after the
    clamp, AND and OR, n in ``SCAN_LAYOUT_NS`` (around a 16-row group and
    one row past a block's step). The plain version equals the reference's
    Pallas kernel (interpret mode), mask and count, at every n."""
    flat, wmeta, terms = list(edge_cases.scan_layout_cases(
        np.random.default_rng(17), "cpu"))[i]
    offs, dbs = wmeta[:, 0].tolist(), wmeta[:, 1].tolist()
    assert dbs == list(DBS)
    assert all(off % 4 if i >= _LAYOUT_CASES // 2 else off % 4 == 0
               for off in offs)
    jterms = [jscan.ScanTerm(col=t.col, kind=t.kind, lo=t.lo, hi=t.hi,
                             lut=t.lut) for t in terms]
    jflat = jnp.asarray(flat.numpy().view(np.uint32))
    packed = scan_ops.pack_terms(terms, DBS, "cpu")
    for combine in ("and", "or"):
        # one compile: every n pads to the same tile
        want = {n: np.asarray(jscan.predicate_scan(
            jflat, offs, DBS, jterms, n, combine, bn=16384, interpret=True))
            for n in edge_cases.SCAN_LAYOUT_NS}
        for n in edge_cases.SCAN_LAYOUT_NS:
            mask, count = scan_ops.predicate_scan(flat, wmeta, packed, n,
                                                  combine)
            assert mask.shape == (n,) and np.array_equal(mask.numpy(),
                                                         want[n])
            assert int(count) == int(want[n].sum())


def test_negative_codes_follow_the_documented_semantics():
    """A 32-bit field >= 2**31 is a negative code: a range term compares
    it as int32, a LUT term probes entry 0 of its own table."""
    words = np.array([5, 0x80000000, 0xFFFFFFFF, 7], np.uint32)
    flat = torch.from_numpy(words.view(np.int32).copy())
    wmeta = torch.tensor([[0, 32]], dtype=torch.int32)
    codes = words.view(np.int32)
    lut = np.array([1, 0, 0, 0, 0, 0, 0, 1], np.int32)
    for term, want in (
            (scan_ops.ScanTerm(col=0, kind=0, lo=-2, hi=6), (codes >= -2)
             & (codes <= 6)),
            (scan_ops.ScanTerm(col=0, kind=1, lut=lut),
             lut[np.clip(codes, 0, 7)] != 0)):
        mask, count = scan_ops.predicate_scan(
            flat, wmeta, scan_ops.pack_terms([term], (32,), "cpu"), 4)
        assert np.array_equal(mask.numpy(), want)
        assert int(count) == int(want.sum())


def test_pack_terms_checks_like_the_reference():
    dbs = (4, 8)
    bad = [[], [scan_ops.ScanTerm(col=2, kind=0, lo=0, hi=1)],
           [scan_ops.ScanTerm(col=0, kind=1, lut=np.zeros(0, np.int32))]]
    jbad = [[], [jscan.ScanTerm(col=2, kind=0, lo=0, hi=1)],
            [jscan.ScanTerm(col=0, kind=1, lut=np.zeros(0, np.int32))]]
    for terms, jterms in zip(bad, jbad):
        with pytest.raises(ValueError):
            scan_ops.pack_terms(terms, dbs, "cpu")
        with pytest.raises(ValueError):
            jscan.pack_terms(jterms, dbs)
    with pytest.raises(ValueError):
        scan_ops.pack_terms([scan_ops.ScanTerm(col=0, kind=2)], dbs, "cpu")
    packed = scan_ops.pack_terms(
        [scan_ops.ScanTerm(col=1, kind=0, lo=3, hi=9),
         scan_ops.ScanTerm(col=0, kind=1, lut=np.array([0, 1, 1])),
         scan_ops.ScanTerm(col=1, kind=1, lut=np.array([1, 0]))], dbs, "cpu")
    assert packed.table.tolist() == [[1, 0, 3, 9, 0, 1], [0, 1, 0, -1, 0, 3],
                                     [1, 1, 0, -1, 3, 2]]
    assert packed.lut.tolist() == [0, 1, 1, 1, 0]
    words = torch.zeros(8, dtype=torch.int32)
    wmeta = torch.tensor([[0, 4], [4, 8]], dtype=torch.int32)
    with pytest.raises(ValueError):
        scan_ops.predicate_scan(words, wmeta, packed, 16, "xor")
    with pytest.raises(ValueError):
        scan_ops.predicate_scan(words, wmeta[:1], packed, 16)
    with pytest.raises(TypeError):
        scan_ops.predicate_scan(words.to(torch.int64), wmeta, packed, 16)


# -- (c) compaction ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_compact_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    mask = rng.random(n) < (0.05, 0.5, 0.95, 0.0)[seed]
    cnt = int(mask.sum())
    for cap in (_pad32(cnt), max(cnt // 2, 1), cnt + 100):
        for fill in (0, 7):
            want = np.asarray(jscan.compact_rows(jnp.asarray(mask), cap,
                                                 fill=fill))
            got = scan_ops.compact_rows(torch.from_numpy(mask), cap, fill)
            plain = scan_ref.compact_rows_ref(torch.from_numpy(mask), cap,
                                              fill)
            assert got.dtype == plain.dtype == torch.int32
            assert np.array_equal(got.numpy(), want)
            assert np.array_equal(plain.numpy(), want)


# -- (d) masked counts ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_masked_counts_match_reference(seed):
    """Every width, k below and above the column's codes (codes >= k are
    dropped), k = 1, an all-false mask and a mask longer than n."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 800))
    # the reference's Pallas histogram takes one interpret-mode grid step
    # per 512 codes, so the 32-bit column's codes stay below 5,000 here
    code_hi = CODE_HI[:5] + (5000,)
    flat, offs, codes_of = _stream(rng, n, cap_extra=32, code_hi=code_hi)
    words, _ = _port_stream(flat, offs)
    mask = rng.random(n + 40) < (0.5, 0.0, 1.0, 0.3, 0.7, 0.5)[seed]
    tmask, jmask = torch.from_numpy(mask), jnp.asarray(mask)
    for c, db in enumerate(DBS):
        for k in (1, max(code_hi[c] // 2, 1), code_hi[c], code_hi[c] + 9):
            got = scan_ops.masked_counts(words, offs[c], db, tmask, k, n)
            assert got.dtype == torch.int32 and got.shape == (k,)
            want = np.bincount(codes_of[c][:n][mask[:n]], minlength=k)[:k]
            assert np.array_equal(got.numpy(), want)
            for use_kernel in (True, False):
                j = jscan.masked_counts(jnp.asarray(flat), offs[c], db,
                                        jmask, k, n, use_kernel=use_kernel)
                assert np.array_equal(got.numpy(), np.asarray(j))


def _unpack(words, db, n):
    """The first n db-bit fields of uint32 ``words`` as int64 (a 32-bit
    field >= 2**31 stays positive: it is past every k)."""
    s = 32 // db
    w = words[:-(-n // s)].astype(np.uint64)
    fields = (w[:, None] >> (np.arange(s, dtype=np.uint64) * np.uint64(db))
              ) & np.uint64((1 << db) - 1)
    return fields.reshape(-1)[:n].astype(np.int64)


@pytest.mark.parametrize("db", DBS)
def test_masked_counts_word_cases_match_reference(db):
    """``edge_cases.masked_counts_word_cases`` at one width (the word-major
    kernel's grid: k around 2**db and the per-warp bins' limit, one code in
    every row, word offsets off a multiple of 4, a mask view one byte into
    a larger tensor, n around a word): the port equals numpy's bincount of
    the selected in-range codes and the reference's kernel route on every
    case, and its split route at n = cap - 1 (each distinct (off, n, k)
    compiles the split route once)."""
    cap = edge_cases.MASKED_WORD_CAP
    for words, off, db_, mask, k, n in edge_cases.masked_counts_word_cases(
            np.random.default_rng(200 + db), "cpu", dbs=(db,)):
        got = scan_ops.masked_counts(words, off, db_, mask, k, n)
        codes = _unpack(words.numpy().view(np.uint32)[off:], db_, n)
        sel = mask.numpy()[:n] & (codes < k)
        want = np.bincount(codes[sel], minlength=k)[:k]
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        jflat, jmask = jnp.asarray(words.numpy()), jnp.asarray(mask.numpy())
        for use_kernel in (True, False) if n == cap - 1 else (True,):
            j = jscan.masked_counts(jflat, off, db_, jmask, k, n,
                                    use_kernel=use_kernel)
            assert np.array_equal(got.numpy(), np.asarray(j)), (
                db_, k, off, n, use_kernel)


def test_masked_counts_checks_and_negative_codes():
    words = np.array([3, 0x80000001, 1, 2], np.uint32)
    flat = torch.from_numpy(words.view(np.int32).copy())
    mask = torch.ones(4, dtype=torch.bool)
    got = hist_ref.masked_counts_ref(flat, 0, 32, mask, 4, 4)
    assert got.tolist() == [0, 1, 1, 1]      # the negative code is dropped
    for bad in (dict(db=3), dict(k=0), dict(n=5), dict(off=4)):
        args = dict(flat_words=flat, off=0, db=32, mask=mask, k=4, n=4)
        args.update(bad)
        with pytest.raises(ValueError):
            scan_ops.masked_counts(**args)
    with pytest.raises(TypeError):
        scan_ops.masked_counts(flat, 0, 32, mask.to(torch.int32), 4, 4)


# -- (e) the executor ---------------------------------------------------------------


def _reference_state(jplan, dictionaries=True):
    state = {"columns": jplan.columns, "n_rows": jplan.n_rows,
             "packed_words": [np.asarray(w) for w in jplan.packed_words],
             "device_bits": list(jplan.device_bits),
             "fused_host": [p.fused_host for p in jplan.plans],
             "cards": [p.cardinality for p in jplan.plans]}
    if dictionaries:
        state["dictionaries"] = [
            {"values": d.values, "sorted": d.sorted_codes}
            for d in (jplan.augmented[c].dictionary for c in jplan.columns)]
    return state


@pytest.fixture(scope="module")
def executors():
    data = _data()
    jplan, plan = _plans(data)
    return (data, JExecutor(jplan, use_kernel=True),
            JExecutor(jplan, use_kernel=False), FeatureExecutor(plan))


def _agree(ex, jexs, host_table, i):
    pred, jpred = _preds(Q)[i], _preds(JQ)[i]
    want = Q.predicate_mask_host(host_table, pred)
    mask = ex.predicate_mask(pred)
    assert mask.dtype == torch.bool and np.array_equal(mask.numpy(), want)
    assert ex.count_where(pred) == int(want.sum())
    rows = ex.filtered_rows(pred)
    assert rows.dtype == np.int64
    assert np.array_equal(rows, np.flatnonzero(want))
    got_rows, feats = ex.batch_where(pred)
    assert np.array_equal(got_rows, rows)
    assert feats.shape == (rows.size, ex.plan.out_dim)
    for jex in jexs:
        assert np.array_equal(mask.numpy(),
                              np.asarray(jex.predicate_mask(jpred)))
        assert ex.count_where(pred) == jex.count_where(jpred)
        assert np.array_equal(rows, jex.filtered_rows(jpred))
        jrows, jfeats = jex.batch_where(jpred)
        assert np.array_equal(got_rows, jrows)
        assert np.array_equal(feats.numpy(), np.asarray(jfeats))
        for col in ("device", "state"):
            vals, counts = ex.groupby_where(col, pred)
            jvals, jcounts = jex.groupby_where(col, jpred)
            assert np.array_equal(vals, jvals)
            assert counts.dtype == np.int64
            assert np.array_equal(counts, jcounts)
        for agg in ("count", "sum", "mean"):
            got = ex.agg_where(pred, "age", agg)
            wnt = jex.agg_where(jpred, "age", agg)
            assert got == wnt or (np.isnan(got) and np.isnan(wnt))


@pytest.mark.parametrize("i", range(8))
def test_executor_pushdown_matches_reference(executors, i):
    data, jk, js, ex = executors
    _agree(ex, (jk, js), Table.from_data(data, imcu_rows=700), i)


@pytest.mark.parametrize("i", [0, 1, 5])
def test_reference_plan_pushdown_matches_reference(executors, i):
    """A plan carried across from the reference plan's state, dictionaries
    included, serves every pushdown method as the reference executor."""
    data, jk, js, _ = executors
    ex = FeatureExecutor(plan_from_reference(_reference_state(jk.plan),
                                             device="cpu"))
    for c in jk.plan.columns:
        jd = jk.plan.augmented[c].dictionary
        assert np.array_equal(ex._dictionary(c).counts, jd.counts)
    _agree(ex, (jk, js), Table.from_data(data, imcu_rows=700), i)
    pred, jpred = _preds(Q)[i], _preds(JQ)[i]
    rows, feats = ex.batch_where(pred)
    jrows, jfeats = jk.batch_where(jpred)
    assert np.array_equal(rows, jrows)
    assert np.array_equal(feats.numpy(), np.asarray(jfeats))
    assert ex.count_where(pred) == jk.count_where(jpred)


def test_reference_plan_without_dictionaries_refuses_pushdown(executors):
    _, jk, _, _ = executors
    ex = FeatureExecutor(plan_from_reference(
        _reference_state(jk.plan, dictionaries=False), device="cpu"))
    for call in (lambda: ex.count_where(_preds(Q)[0]),
                 lambda: ex.batch_where(_preds(Q)[0]),
                 lambda: ex.agg_where(_preds(Q)[0], "age", "mean")):
        with pytest.raises(RuntimeError, match="dictionar"):
            call()
    assert ex.batch(np.arange(5)).shape == (5, ex.plan.out_dim)
    state = _reference_state(jk.plan)
    state["dictionaries"] = state["dictionaries"][:2]
    with pytest.raises(ValueError):
        plan_from_reference(state, device="cpu")
    state = _reference_state(jk.plan)
    state["dictionaries"][0] = {"values": np.arange(3), "sorted": True}
    with pytest.raises(ValueError):
        plan_from_reference(state, device="cpu")
    # all or nothing: every column carries {values, sorted}
    for bad in (None, {"values": state["dictionaries"][1]["values"]}):
        state = _reference_state(jk.plan)
        state["dictionaries"][1] = bad
        with pytest.raises(ValueError, match="per column"):
            plan_from_reference(state, device="cpu")


def test_executor_pushdown_guards(executors):
    data, jk, _, ex = executors
    jplan32, plan32 = _plans(data, packed=False)
    for e in (FeatureExecutor(plan32), JExecutor(jplan32)):
        with pytest.raises(RuntimeError):
            e.predicate_mask(_preds(Q)[0] if isinstance(e, FeatureExecutor)
                             else _preds(JQ)[0])
    with pytest.raises(RuntimeError):
        FeatureExecutor(plan32).count_where(_preds(Q)[0])
    with pytest.raises(KeyError):
        ex.groupby_where("not_a_column", _preds(Q)[0])
    with pytest.raises(KeyError):
        jk.groupby_where("not_a_column", _preds(JQ)[0])
    with pytest.raises(ValueError):
        ex.agg_where(_preds(Q)[0], "age", "median")
    # the compiled predicate is cached: one term table per predicate
    pred = _preds(Q)[1]
    ex.count_where(pred)
    n_cached = len(ex._pred_cache)
    ex.count_where(pred)
    assert len(ex._pred_cache) == n_cached


def test_post_refresh_append_scan_matches_reference():
    """Appends that land mid-word, grow dictionaries and push n_rows past
    the stream's pad32 capacity: both packages refresh to the same state
    and scan, compact, gather and count the new rows identically."""
    data = _data(n=777)
    jplan, plan = _plans(data)
    jex, ex = JExecutor(jplan, use_kernel=True), FeatureExecutor(plan)
    pred, jpred = (Q.between("age", 30, 40) | Q.eq("device", 2),
                   JQ.between("age", 30, 40) | JQ.eq("device", 2))
    cap0 = ex._capacity
    rng = np.random.default_rng(7)
    age_all, dev_all = data["age"].copy(), data["device"].copy()
    for step in range(3):
        extra = 50 + 13 * step
        new = {"age": rng.integers(18, 95, extra),
               "state": rng.integers(0, 51, extra),
               "income": np.round(rng.lognormal(10, 1, extra), -2),
               "device": rng.integers(0, 7, extra)}
        codes = {}
        for col in plan.columns:
            codes[col] = plan.augmented[col].dictionary.add_rows(new[col])
            assert np.array_equal(
                codes[col], jplan.augmented[col].dictionary.add_rows(new[col]))
        assert plan.refresh(codes) == jplan.refresh(codes)
        age_all = np.concatenate([age_all, new["age"]])
        dev_all = np.concatenate([dev_all, new["device"]])
        want = ((age_all >= 30) & (age_all <= 40)) | (dev_all == 2)
        mask = ex.predicate_mask(pred)
        assert mask.shape == (age_all.shape[0],)
        assert np.array_equal(mask.numpy(), want)
        assert np.array_equal(mask.numpy(),
                              np.asarray(jex.predicate_mask(jpred)))
        rows, feats = ex.batch_where(pred)
        jrows, jfeats = jex.batch_where(jpred)
        assert np.array_equal(rows, np.flatnonzero(want))
        assert np.array_equal(rows, jrows)
        assert np.array_equal(feats.numpy(), np.asarray(jfeats))
        assert np.array_equal(feats.numpy(), plan.host_features(rows))
        _, counts = ex.groupby_where("device", pred)
        assert np.array_equal(counts, jex.groupby_where("device", jpred)[1])
        assert ex.agg_where(pred, "age", "mean") == \
            jex.agg_where(jpred, "age", "mean")
    assert ex._capacity > cap0
