"""The CUDA kernels against their plain PyTorch versions, on a card: the
three ADV gathers (each on its edge set too), the predicate
scan (on its term sets and its layout cases), the masked counts (on the
word-major grid too), the one-hot wide layer (on its forward's grid too)
with its gradient (bit for bit against the CPU, and the same in
every launch), the Table 6 path's bit-unpack, counts and single-table
gather, and a front door serving through the gathers with a retried
fault.

Needs a CUDA device and ``nvcc`` (the kernels build at first use); every
test skips without a card. Imports neither JAX nor the reference package,
so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import edge_cases
from repro_torch.kernels.adv_gather import ops, ref
from repro_torch.kernels.bitunpack import ops as unpack_ops
from repro_torch.kernels.bitunpack import ref as unpack_ref
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.kernels.hist import ref as hist_ref
from repro_torch.kernels.onehot_wide import ops as wide_ops
from repro_torch.kernels.onehot_wide import ref as wide_ref
from repro_torch.kernels.predicate_scan import ops as scan_ops
from repro_torch.kernels.predicate_scan import ref as scan_ref

DBS = edge_cases.DBS
CARDS = (2, 3, 11, 200, 3000, 1000)    # most below 2**db: codes clamp
DIMS = (1, 3, 2, 5, 2, 1)
CAP = 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_kernels_match_plain_versions_on_card(cuda, seed):
    """Widths 1-32, random words (codes past every table and past 2**31),
    rows at word boundaries and past the stream, out-of-range int32 codes:
    each kernel equals its plain version bit for bit, and each launch is
    counted once."""
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((k, f)).astype(np.float32)
              for k, f in zip(CARDS, DIMS)]
    words = [rng.integers(0, 1 << 32, CAP * db // 32,
                          dtype=np.uint64).astype(np.uint32) for db in DBS]
    offs = [int(o) for o in np.cumsum([0] + [w.size for w in words])[:-1]]
    flat = torch.from_numpy(np.concatenate(words).view(np.int32)).to(cuda)
    wmeta = ops.word_meta(offs, DBS, cuda)
    fused = ops.fuse_tables(tables, cuda)
    rows = np.concatenate([[0, 1, 31, 32, CAP - 1, CAP, 10 ** 9],
                           rng.integers(0, CAP, 5000)])
    rows = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    starts = torch.tensor([0, 256, 768], dtype=torch.int32, device=cuda)
    codes = torch.from_numpy(np.stack([rng.integers(-3, k + 5, 5000)
                                       for k in CARDS]).astype(np.int32))
    codes = codes.to(cuda)
    before = dict(ops.LAUNCHES)
    pairs = [
        (ops.adv_gather_packed_rows(flat, wmeta, fused, rows),
         ref.adv_gather_packed_rows_ref(flat, wmeta, fused, rows)),
        (ops.adv_gather_packed(flat, wmeta, fused, starts, 256),
         ref.adv_gather_packed_ref(flat, wmeta, fused, starts, 256)),
        (ops.gather_fused_parts(fused, codes),
         ref.gather_fused_parts_ref(fused, codes)),
        (ops.adv_gather(torch.from_numpy(tables[3]).to(cuda), codes),
         ref.adv_gather_ref(codes, torch.from_numpy(tables[3]).to(cuda))),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and torch.equal(got, want)
    assert all(ops.LAUNCHES[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
def test_packed_rows_kernel_matches_plain_version_on_card(cuda):
    """``edge_cases.packed_rows_cases``: out_dims 1, 31, 33, 58 and 200 at
    1, 7, 33 and 5,000 rows over random words at every width: the
    tiled kernel equals its plain version bit for bit, one launch each."""
    for flat, wmeta, fused, rows in edge_cases.packed_rows_cases(
            np.random.default_rng(11), cuda):
        before = ops.LAUNCHES["adv_gather_packed_rows"]
        got = ops.adv_gather_packed_rows(flat, wmeta, fused, rows)
        want = ref.adv_gather_packed_rows_ref(flat, wmeta, fused, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (fused.out_dim, rows.numel())
        assert ops.LAUNCHES["adv_gather_packed_rows"] == before + 1


@pytest.mark.cuda
def test_packed_range_kernel_matches_plain_version_on_card(cuda):
    """``edge_cases.packed_range_cases``: out_dims 1, 31, 33, 58, 200 and
    60 (over 40 tables), 1, 3 and 17 ranges of 32, 96 and 4,096 rows,
    starts at 0, at the last aligned range, past the stream's end,
    duplicated, overlapping, unaligned and negative: the kernel equals its
    plain version bit for bit, one launch each."""
    for flat, wmeta, fused, starts, batch in edge_cases.packed_range_cases(
            np.random.default_rng(17), cuda):
        before = ops.LAUNCHES["adv_gather_packed"]
        got = ops.adv_gather_packed(flat, wmeta, fused, starts, batch)
        want = ref.adv_gather_packed_ref(flat, wmeta, fused, starts, batch)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (fused.out_dim, batch,
                                        starts.tolist())
        assert ops.LAUNCHES["adv_gather_packed"] == before + 1


@pytest.mark.cuda
def test_multi_kernel_matches_plain_version_on_card(cuda):
    """``edge_cases.multi_cases``: out_dims 1, 4, 17, 31, 33, 58 and 200,
    C = 1 to 9, a K = 1 table, 1 to 5,000 rows, codes below 0, past K and
    the int32 ends: the kernel equals its plain version bit for bit, one
    launch each."""
    for fused, codes in edge_cases.multi_cases(np.random.default_rng(13),
                                               cuda):
        before = ops.LAUNCHES["gather_fused_parts"]
        got = ops.gather_fused_parts(fused, codes)
        want = ref.gather_fused_parts_ref(fused, codes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (fused.out_dim, codes.shape)
        assert ops.LAUNCHES["gather_fused_parts"] == before + 1


@pytest.mark.cuda
def test_wrappers_reject_mixed_devices(cuda):
    fused = ops.fuse_tables([np.ones((3, 2), np.float32)], cuda)
    with pytest.raises(ValueError):
        ops.gather_fused_parts(fused, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["and", "or"])
def test_scan_kernel_matches_plain_version_on_card(cuda, combine):
    """Terms of both kinds at every width, two on one column, a LUT
    shorter than the codes (the clamp), empty and full selections, n off
    every multiple of 4 and 32 against a longer stream: mask and count equal
    the plain version's, and each launch is counted once."""
    rng = np.random.default_rng(3)
    flat, wmeta, _ = edge_cases.random_stream(rng, CAP, cuda)
    for terms in edge_cases.scan_term_sets(rng):
        packed = scan_ops.pack_terms(terms, DBS, cuda)
        for n in (1, 3, 31, 997, CAP - 5, CAP):
            before = scan_ops.LAUNCHES["predicate_scan"]
            mask, count = scan_ops.predicate_scan(flat, wmeta, packed, n,
                                                  combine)
            want, want_count = scan_ref.predicate_scan_ref(flat, wmeta,
                                                           packed, n, combine)
            torch.cuda.synchronize()
            assert mask.is_cuda and mask.dtype == torch.bool
            assert torch.equal(mask, want)
            assert int(count) == int(want_count) == int(want.sum())
            assert scan_ops.LAUNCHES["predicate_scan"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("combine", ["and", "or"])
def test_scan_layout_cases_on_card(cuda, combine):
    """``edge_cases.scan_layout_cases``: word offsets that are all
    multiples of 4 and none, every width under both kinds, bounds below 0,
    past 2**db and empty after the clamp, n around a 16-row group and one
    row past a block's step: mask and count equal the plain version's,
    one launch each."""
    for flat, wmeta, terms in edge_cases.scan_layout_cases(
            np.random.default_rng(17), cuda):
        packed = scan_ops.pack_terms(terms, DBS, cuda)
        for n in edge_cases.SCAN_LAYOUT_NS:
            before = scan_ops.LAUNCHES["predicate_scan"]
            mask, count = scan_ops.predicate_scan(flat, wmeta, packed, n,
                                                  combine)
            want, want_count = scan_ref.predicate_scan_ref(flat, wmeta,
                                                           packed, n, combine)
            torch.cuda.synchronize()
            assert torch.equal(mask, want), (terms, n)
            assert int(count) == int(want_count), (terms, n)
            assert scan_ops.LAUNCHES["predicate_scan"] == before + 1


@pytest.mark.cuda
def test_masked_counts_kernel_matches_plain_version_on_card(cuda):
    """Every width; k = 1, k below the codes (dropped), k in shared memory
    up to its limit and k past it (global counters); all-false, all-true
    and random masks; n off every multiple of 4."""
    cases, masks = edge_cases.masked_counts_cases(
        np.random.default_rng(4), CAP, cuda)
    for words, off, db, k in cases:
        for mask in masks:
            for n in (CAP - 3, CAP):
                before = hist_ops.LAUNCHES["masked_counts"]
                got = hist_ops.masked_counts(words, off, db, mask, k, n)
                want = hist_ref.masked_counts_ref(words, off, db, mask, k, n)
                torch.cuda.synchronize()
                assert got.is_cuda and torch.equal(got, want)
                assert hist_ops.LAUNCHES["masked_counts"] == before + 1


@pytest.mark.cuda
def test_masked_counts_word_cases_on_card(cuda):
    """``edge_cases.masked_counts_word_cases``: every width, k around
    2**db (the register counters) and the per-warp bins' limit, a column
    with one code in every row, word offsets off a multiple of 4, masks
    not 16-byte aligned, n around a word: the word-major kernel equals its
    plain version, one launch for each n > 0."""
    for words, off, db, mask, k, n in edge_cases.masked_counts_word_cases(
            np.random.default_rng(14), cuda):
        before = hist_ops.LAUNCHES["masked_counts"]
        got = hist_ops.masked_counts(words, off, db, mask, k, n)
        want = hist_ref.masked_counts_ref(words, off, db, mask, k, n)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (db, k, off, n, mask.data_ptr() % 16)
        assert hist_ops.LAUNCHES["masked_counts"] == before + int(n > 0)


@pytest.mark.cuda
def test_onehot_wide_forward_cases_on_card(cuda):
    """``edge_cases.onehot_wide_forward_cases``: F in {1, 2, 3, 4, 8, 128,
    129}, C in {0, 1, 2, 8, 33}, N in {0, 1, 33, 1024, 1025}, K in {1, 50,
    600}, codes -1, K and the int32 ends among them, w float32 and
    bfloat16, aligned and as a view 4 bytes into a larger tensor: the
    forward equals its plain version bit for bit, one launch for each
    nonempty call; and ``edge_cases.WIDE_FWD_PASSES`` (F 1,024 and 1,030,
    taken in passes)."""
    rng = np.random.default_rng(15)
    for codes, w in itertools.chain(
            edge_cases.onehot_wide_forward_cases(rng, cuda),
            edge_cases.onehot_wide_forward_cases(
                rng, cuda, **edge_cases.WIDE_FWD_PASSES)):
        before = wide_ops.LAUNCHES["onehot_wide"]
        got = wide_ops.onehot_wide(codes, w)
        want = wide_ref.onehot_wide_ref(codes, w)
        torch.cuda.synchronize()
        assert got.dtype == w.dtype and torch.equal(got, want), (
            tuple(codes.shape), tuple(w.shape), w.dtype, w.data_ptr() % 16)
        assert wide_ops.LAUNCHES["onehot_wide"] == \
            before + int(codes.numel() > 0)


@pytest.mark.cuda
def test_onehot_wide_kernels_match_plain_versions_on_card(cuda):
    """``edge_cases.onehot_wide_cases``: C in {0, 1, 8}, N in {0, 1, 33,
    1024}, K in {1, 4, 600, 65537}, F in {1, 129}, codes -1, K, 2**31 - 1
    and -2**31 among them, and ``edge_cases.ONEHOT_GROUPED_SHAPES`` (the
    gradient's grouped route). The forward equals its plain version bit for
    bit in float32 and bfloat16; the gradient equals the plain version run
    on the CPU bit for bit, and a second launch equals the first. Each call
    is counted once; an empty C or N launches nothing."""
    rng = np.random.default_rng(6)
    for codes, w, g in itertools.chain(
            edge_cases.onehot_wide_cases(rng, cuda),
            edge_cases.onehot_wide_grouped_cases(rng, cuda)):
        k = w.shape[1]
        before = dict(wide_ops.LAUNCHES)
        w16 = w.to(torch.bfloat16)
        got = wide_ops.onehot_wide(codes, w)
        got16 = wide_ops.onehot_wide(codes, w16)
        dw = wide_ops.onehot_wide_backward(codes, g, k)
        want = wide_ref.onehot_wide_ref(codes, w)
        want16 = wide_ref.onehot_wide_ref(codes, w16)
        dw_want = wide_ref.onehot_wide_backward_ref(codes.cpu(), g.cpu(), k)
        torch.cuda.synchronize()
        assert got.is_cuda and torch.equal(got, want)
        assert got16.dtype == torch.bfloat16 and torch.equal(got16, want16)
        assert dw.shape == w.shape and torch.equal(dw.cpu(), dw_want)
        launched = int(codes.numel() > 0)
        assert wide_ops.LAUNCHES == {
            "onehot_wide": before["onehot_wide"] + 2 * launched,
            "onehot_wide_backward": before["onehot_wide_backward"]
            + launched}
        assert torch.equal(wide_ops.onehot_wide_backward(codes, g, k), dw)


@pytest.mark.cuda
def test_onehot_wide_autograd_launches_both_kernels_on_card(cuda):
    """On CUDA tensors the autograd Function launches the forward kernel
    and, on backward, the gradient kernel, whose dW equals the CPU's bit
    for bit; a bfloat16 gradient raises."""
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(rng.integers(-1, 51, (2, 1024))
                             .astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((2, 50, 1), dtype=np.float32)) \
        .to(cuda).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((1024, 1), dtype=np.float32)) \
        .to(cuda)
    before = dict(wide_ops.LAUNCHES)
    (wide_ops.onehot_wide(codes, w) * g).sum().backward()
    torch.cuda.synchronize()
    assert wide_ops.LAUNCHES == {k: v + 1 for k, v in before.items()}
    want = wide_ref.onehot_wide_backward_ref(codes.cpu(), g.cpu(), 50)
    assert torch.equal(w.grad.cpu(), want)
    with pytest.raises(TypeError):
        wide_ops.onehot_wide_backward(codes, g.to(torch.bfloat16), 50)


@pytest.mark.cuda
def test_bitunpack_kernel_matches_plain_version_on_card(cuda):
    """``edge_cases.bitunpack_cases``: every width, random words (32-bit
    fields past 2**31), n = 0, n off every multiple of 32 / db and of 4,
    words past the n codes and codes past the last word. Codes equal the
    plain version's; each nonempty call launches once."""
    for words, db, n in edge_cases.bitunpack_cases(np.random.default_rng(8),
                                                   cuda):
        before = unpack_ops.LAUNCHES["bitunpack"]
        got = unpack_ops.bitunpack(words, db, n)
        want = unpack_ref.bitunpack_ref(words, db, n)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got, want), (db, n)
        assert unpack_ops.LAUNCHES["bitunpack"] == before + int(n > 0)


@pytest.mark.cuda
def test_hist_kernel_matches_plain_version_on_card(cuda):
    """``edge_cases.hist_cases``: k in {1, 999, 58,112, 58,113, 100,000}
    (shared and global counters), codes below 0 and >= k (dropped), an
    unaligned view, 2-D codes and no codes."""
    for codes, k in edge_cases.hist_cases(np.random.default_rng(9), cuda):
        before = hist_ops.LAUNCHES["hist"]
        got = hist_ops.hist(codes, k)
        want = hist_ref.hist_ref(codes, k)
        torch.cuda.synchronize()
        assert got.is_cuda and torch.equal(got, want), (k, codes.shape)
        assert hist_ops.LAUNCHES["hist"] == before + int(codes.numel() > 0)


@pytest.mark.cuda
def test_single_table_gather_matches_plain_version_on_card(cuda):
    """``edge_cases.adv_gather_cases``: K in {1, 999, 65,536, 65,537,
    131,072} x F in {1, 16, 128, 999}, float32 and bfloat16, codes below 0,
    >= K and the int32 ends among them, 2-D codes and no codes: the
    gathered rows equal the plain version's bit for bit."""
    for table, codes in edge_cases.adv_gather_cases(
            np.random.default_rng(10), cuda):
        before = ops.LAUNCHES["adv_gather"]
        got = ops.adv_gather(table, codes)
        want = ref.adv_gather_ref(codes, table)
        torch.cuda.synchronize()
        assert got.dtype == table.dtype and got.shape == want.shape
        assert torch.equal(got, want), (tuple(table.shape), table.dtype)
        assert ops.LAUNCHES["adv_gather"] == before + int(codes.numel() > 0)


@pytest.mark.cuda
def test_single_table_gather_row_shapes_on_card(cuda):
    """``edge_cases.adv_gather_shape_cases``: K in {1, 999}, F in {1, 3, 16,
    999}, n in {1, 3, 5, 4097} and ``codes[1:]`` views (not 16-byte
    aligned), float32 and bfloat16: the rows equal the plain version's bit
    for bit, one launch each."""
    for table, codes in edge_cases.adv_gather_shape_cases(
            np.random.default_rng(12), cuda):
        before = ops.LAUNCHES["adv_gather"]
        got = ops.adv_gather(table, codes)
        want = ref.adv_gather_ref(codes, table)
        torch.cuda.synchronize()
        assert got.dtype == table.dtype and got.shape == want.shape
        assert torch.equal(got, want), (tuple(table.shape), table.dtype,
                                        codes.numel(), codes.data_ptr() % 16)
        assert ops.LAUNCHES["adv_gather"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "int32"])
def test_front_door_retries_a_class_fault_on_card(cuda, packed):
    """A front door on the card over a small plan, one injected fault on
    the batch class: the group is re-launched once through the same kernel
    and every ticket equals the same front door on the CPU (the plain
    versions) bit for bit, with availability 1.0 over admitted work."""
    from repro_torch.columnar import Table
    from repro_torch.core import FeaturePlan, FeatureSet
    from repro_torch.serve import (FaultInjector, FaultPolicy,
                                   FeatureFrontend)
    rng = np.random.default_rng(0)
    n = 5000
    table = Table.from_data({"age": rng.integers(18, 90, n),
                             "state": rng.integers(0, 50, n),
                             "device": rng.integers(0, 4, n)})
    fs = (FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("device", "onehot"))
    reqs = [(rng.integers(0, n, int(rng.integers(1, 300))),
             ("interactive", "batch", "background")[i % 3])
            for i in range(24)]
    key = "adv_gather_packed_rows" if packed else "gather_fused_parts"
    served = {}
    for dev in (cuda, torch.device("cpu")):
        plan = FeaturePlan(table, fs, packed=packed, device=dev)
        inj = FaultInjector().fail_launches(1, klass="batch")
        launched = ops.LAUNCHES[key]
        with FeatureFrontend.for_plan(
                plan, buckets=(64, 256), faults=inj,
                fault_policy=FaultPolicy(backoff_s=0.001)) as fe:
            fe.service.pause()
            tks = [fe.submit(r, klass=k) for r, k in reqs]
            fe.service.resume()
            served[dev.type] = [fe.result(t, timeout=60) for t in tks]
            st = fe.stats()
            assert fe.service.stats["retries"] == 1
            assert inj.faults_injected == 1
            assert st["availability_admitted"] == 1.0
        if dev.type == "cuda":
            assert ops.LAUNCHES[key] > launched
    for (r, _), g, c in zip(reqs, served["cuda"], served["cpu"]):
        assert np.array_equal(g, c)
        assert np.array_equal(g, plan.host_features(r))
