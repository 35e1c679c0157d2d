"""The CUDA kernels against their plain PyTorch versions, on a card: the
three ADV gathers (each on its edge set too), the predicate
scan (on its term sets and its layout cases), the masked counts (on the
word-major grid too), the one-hot wide layer (on its forward's grid too)
with its gradient (bit for bit against the CPU, and the same in
every launch), the Table 6 path's bit-unpack, counts and single-table
gather, a front door serving through the gathers with a retried
fault, and sharded serving with its shards on streams of cuda:0 (bit-exact
against the CPU, a refresh and a replica drop while launches wait on other
streams, a pool naming another card refused). Flash attention's kernels
(forward, dQ, dK/dV) against the plain version and float32 direct
attention at the two benchmark cells' layer shapes, over windows, pinned
positions and fully masked rows, their launch counts and refusals. The LM
training path (cuBLAS products, PyTorch ops and the flash kernels): one
train step and each optimizer's update on the card against the CPU for a
dense, a MoE, an ssm and an audio arch (``train.parity``), the flash
backward against direct attention, a checkpointed ``Trainer`` run resumed
on the card, and the training entry points on ``cuda`` when no device is
named.

Needs a CUDA device and ``nvcc`` (the kernels build at first use); every
test skips without a card. Imports neither JAX nor the reference package,
so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""
import itertools
import sys
import time
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (phase 9F's flash check)

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


# -- sharded serving: shards on streams of cuda:0 ------------------------------------
SPIN = 200_000_000          # ~0.1 s at 2 GHz: launches queue behind it


def _sharded_table(n=1 << 16, imcu_rows=1 << 14, seed=0):
    """Four IMCU shards of a serving-shaped table (widths 8/8/2)."""
    from repro_torch.columnar import Table
    from repro_torch.core import FeatureSet
    rng = np.random.default_rng(seed)
    table = Table.from_data({"age": rng.integers(18, 90, n),
                             "state": rng.integers(0, 50, n),
                             "device": rng.integers(0, 4, n)},
                            imcu_rows=imcu_rows)
    fs = (FeatureSet().add("age", "zscore").add("state", "onehot")
          .add("device", "onehot"))
    return table, fs


def _shard_requests(rng, n, count, shard=None, imcu_rows=1 << 14):
    """Random row sets, word-aligned 64-row blocks and boundary straddles;
    all inside one shard when ``shard`` is given."""
    lo, hi = (0, n) if shard is None else (shard * imcu_rows,
                                           (shard + 1) * imcu_rows)
    reqs = []
    for i in range(count):
        if i % 3 == 0:
            s = int(rng.integers(lo // 32, (hi - 64) // 32)) * 32
            reqs.append(np.arange(s, s + 64))
        else:
            reqs.append(rng.integers(lo, hi, int(rng.integers(1, 300))))
    if shard is None:
        reqs.append(np.arange(imcu_rows - 40, imcu_rows + 40))
    return reqs


def _spin_streams(executors):
    """Park every executor's stream on a spin kernel, so launches queued
    next are still waiting on the card while the host goes on."""
    for ex in executors:
        with torch.cuda.stream(ex.stream):
            torch.cuda._sleep(SPIN)


def _wait_window_full(svc, launches, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while svc.stats["launches"] < launches:
        assert time.perf_counter() < deadline, "the pump never launched"
        time.sleep(0.0005)


@pytest.mark.cuda
def test_sharded_service_four_streams_bit_exact_on_card(cuda):
    """Four shards on four streams of cuda:0, one copy of the tables:
    every ticket, and the sharded pushdown, equal the same service on the
    CPU bit for bit, and the rows kernel launched on the shard streams."""
    from repro_torch.columnar import query as Q
    from repro_torch.core import FeaturePlan
    from repro_torch.serve import FeatureService
    table, fs = _sharded_table()
    n = table.n_rows
    reqs = _shard_requests(np.random.default_rng(1), n, 90)
    pred = Q.isin("state", [3, 7, 11]) & Q.gt("age", 60)
    served = {}
    for dev in (cuda, torch.device("cpu")):
        plan = FeaturePlan(table, fs, packed=True, device=dev)
        launched = ops.LAUNCHES["adv_gather_packed_rows"]
        scans = scan_ops.LAUNCHES["predicate_scan"]
        with FeatureService(plan, sharded=True, buckets=(64, 256),
                            coalesce=4, devices=[dev]) as svc:
            sx = svc._sharded_ex
            assert svc.n_shards == 4 and len(sx._caches) == 1
            if dev.type == "cuda":
                streams = {ex.stream.cuda_stream for ex in sx.executors}
                assert len(streams) == 4
                assert torch.cuda.default_stream().cuda_stream not in streams
            svc.pause()
            tks = [svc.submit(r) for r in reqs]
            svc.resume()
            got = [svc.result(t, timeout=60) for t in tks]
            push = (svc.count_where(pred), svc.filtered_rows(pred),
                    svc.groupby_where("device", pred)[1],
                    svc.agg_where(pred, "age", "mean"),
                    svc.result(svc.submit(where=pred), timeout=60))
            st = dict(svc.stats)
        for r, g in zip(reqs, got):
            assert np.array_equal(g, plan.host_features(r))
        served[dev.type] = (got, push, st)
        if dev.type == "cuda":
            assert ops.LAUNCHES["adv_gather_packed_rows"] >= \
                launched + st["launches"]
            assert scan_ops.LAUNCHES["predicate_scan"] >= scans + 4
            assert st["retries"] == st["failed_tickets"] == 0
    (g_cuda, p_cuda, s_cuda), (g_cpu, p_cpu, s_cpu) = \
        served["cuda"], served["cpu"]
    for a, b in zip(g_cuda, g_cpu):
        assert np.array_equal(a, b)
    for a, b in zip(p_cuda, p_cpu):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for key in ("launches", "shard_launches", "split_requests",
                "packed_ranges", "bytes_h2d"):
        assert s_cuda[key] == s_cpu[key], key


@pytest.mark.cuda
def test_sharded_refresh_while_launches_in_flight_on_card(cuda):
    """A refresh (appended rows, the ADV tables rebuilt) lands while eight
    launches wait on their shard streams behind a spin kernel, and the
    freed memory is handed out again at once on the default stream. The
    in-flight launches must still read the tables they were given: every
    served row equals its features before or after the refresh, bit for
    bit, and none reads the overwritten memory."""
    from repro_torch.core import FeaturePlan
    from repro_torch.serve import FeatureService
    table, fs = _sharded_table()
    n = table.n_rows
    plan = FeaturePlan(table, fs, packed=True, device=cuda)
    rng = np.random.default_rng(2)
    reqs = _shard_requests(rng, n, 64)
    before = [plan.host_features(r) for r in reqs]
    with FeatureService(plan, sharded=True, buckets=(64, 256), coalesce=2,
                        devices=[cuda]) as svc:
        sx = svc._sharded_ex
        old = plan.fused_tables()
        old_bytes = old.tables.numel()
        svc.pause()
        tks = [svc.submit(r) for r in reqs]
        _spin_streams(sx.executors)
        svc.resume()
        _wait_window_full(svc, 2 * svc.n_shards)
        d = {c: table[c].dictionary for c in ("age", "state", "device")}
        plan.refresh({c: d[c].add_rows(d[c].values[rng.integers(
            0, d[c].cardinality, 4096)]) for c in d})
        # drop every host reference to the old tables now (the executors
        # would drop theirs at their next launches), so they are freed
        # while the launches given them still wait behind the spin
        for ex in sx.executors:
            ex._fused_seen = None
        for tc in sx._caches.values():
            tc.fused_src = tc.fused = None
        del old
        new = plan.fused_tables()
        # hand the freed memory out again on the default stream, at once
        junk = [torch.full((old_bytes,), float("nan"), device=cuda)
                for _ in range(8)]
        got = [svc.result(t, timeout=60) for t in tks]
        del junk
        after = [plan.host_features(r) for r in reqs]
        assert new.tables.numel() == old_bytes
    n_old = 0
    for g, b, a in zip(got, before, after):
        # a launch reads one version of the tables; a ticket whose rows
        # span shards is several launches, so it may hold both
        assert not np.isnan(g).any()
        old_rows = (g == b).all(axis=1)
        assert (old_rows | (g == a).all(axis=1)).all()
        n_old += int((old_rows & ~(b == a).all(axis=1)).sum())
    assert n_old >= 1                      # launches did precede the refresh
    assert svc.stats["failed_tickets"] == 0


@pytest.mark.cuda
def test_sharded_drop_replica_under_load_on_card(cuda):
    """Shard 0 with two replicas takes a burst; a replica is dropped while
    its launches wait behind a spin kernel, and memory is handed out
    again on the default stream at once. Every ticket stays bit-exact."""
    from repro_torch.core import FeaturePlan
    from repro_torch.serve import FeatureService
    table, fs = _sharded_table()
    plan = FeaturePlan(table, fs, packed=True, device=cuda)
    reqs = _shard_requests(np.random.default_rng(3), table.n_rows, 96,
                           shard=0)
    with FeatureService(plan, sharded=True, buckets=(64, 256), coalesce=2,
                        devices=[cuda]) as svc:
        svc.add_replica(0)
        svc.add_replica(0)
        sx = svc._sharded_ex
        assert svc.replicas[0] == 2
        words = sx.replicas[0][-1].resident_bytes()
        svc.pause()
        tks = [svc.submit(r) for r in reqs]
        _spin_streams(sx.stream_executors(0))
        svc.resume()
        _wait_window_full(svc, 6)          # 2 per stream, 3 streams
        svc.drop_replica(0)
        junk = [torch.full((words // 4,), -1, dtype=torch.int32,
                           device=cuda) for _ in range(8)]
        got = [svc.result(t, timeout=60) for t in tks]
        del junk
        assert svc.replicas[0] == 1
        assert svc.stats["replicas_dropped"] == 1
        assert svc.stats["failed_tickets"] == 0
    for r, g in zip(reqs, got):
        assert np.array_equal(g, plan.host_features(r))


@pytest.mark.cuda
def test_sharded_pool_naming_another_card_raises_on_card(cuda):
    """The launchers use cuda:0 only: a serve pool naming cuda:1 raises
    before anything is put there, on any machine."""
    from repro_torch.core import FeaturePlan, ShardedFeatureExecutor
    from repro_torch.serve import FeatureService
    table, fs = _sharded_table(n=4096, imcu_rows=1024)
    plan = FeaturePlan(table, fs, packed=True, device=cuda)
    with pytest.raises(ValueError, match="cuda:0 only"):
        ShardedFeatureExecutor(plan, devices=[torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="cuda:0 only"):
        FeatureService(plan, sharded=True,
                       devices=[cuda, torch.device("cuda", 1)])


@pytest.mark.cuda
def test_sharded_executor_places_tables_on_its_device_on_card(cuda):
    """A plan on the CPU served by shards on cuda:0: each shard's words
    and the one copy of the tables on the card are placed there, and the
    gathers equal the plan's host reference."""
    from repro_torch.core import FeaturePlan, ShardedFeatureExecutor
    table, fs = _sharded_table(n=8192, imcu_rows=2048)
    plan = FeaturePlan(table, fs, packed=True, device="cpu")
    sx = ShardedFeatureExecutor(plan, devices=[cuda])
    rows = np.random.default_rng(4).integers(0, table.n_rows, 700)
    got = sx.batch(rows).cpu().numpy()
    assert np.array_equal(got, plan.host_features(rows))
    (cache,) = sx._caches.values()
    assert cache.fused.tables.device.type == "cuda"
    assert plan.fused_tables().tables.device.type == "cpu"
    assert {ex._flat_words.device.type for ex in sx.executors} == {"cuda"}


# -- device loss, hedging and tiers on the card ----------------------------------------
@pytest.mark.cuda
def test_evict_device_under_queued_launches_on_card(cuda):
    """Every shard's gather waits on its stream behind a spin kernel when
    the device is evicted (its words dropped, its table cache gone); memory
    is then allocated on another stream and overwritten at once. The
    caching allocator keeps the evicted words for their own stream, so
    every queued gather still reads them: bit for bit the host's."""
    from repro_torch.core import FeaturePlan, ShardedFeatureExecutor
    table, fs = _sharded_table()
    plan = FeaturePlan(table, fs, packed=True, device=cuda)
    sx = ShardedFeatureExecutor(plan, devices=[cuda])
    rng = np.random.default_rng(5)
    words = max(ex.resident_bytes() for ex in sx.executors)
    _spin_streams(sx.executors)
    outs = []
    for ex in sx.executors:
        rows = rng.integers(0, ex.plan.n_rows, 512).astype(np.int32)
        with torch.cuda.stream(ex.stream):
            outs.append((ex.plan, rows, ex._rows_future(rows)))
    removed, orphans = sx.evict_device(torch.device("cuda"))
    assert len(removed) == len(orphans) == 4 and not sx._caches
    assert sx.device_bytes() == {}
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        junk = [torch.full((words // 4,), -1, dtype=torch.int32,
                           device=cuda) for _ in range(16)]
    torch.cuda.synchronize()
    del junk
    for shard_plan, rows, out in outs:
        assert np.array_equal(out.cpu().numpy(),
                              shard_plan.host_features(rows))
    # and a rebuild on the revived card serves again
    for s in orphans:
        sx.rebuild_on(s)
    rows = rng.integers(0, table.n_rows, 700)
    assert np.array_equal(sx.batch(rows).cpu().numpy(),
                          plan.host_features(rows))


@pytest.mark.cuda
def test_hedged_loser_pinned_buffer_not_reused_on_card(cuda):
    """The stream the pump picks next is parked on a long spin kernel, so
    the hedged duplicate on the shard's other stream wins and the primary
    is dropped unread while its copy into pinned memory still waits. Pinned
    buffers of the same size handed out right after must not be the
    loser's: a sentinel written into them survives the loser's late
    copy."""
    from repro_torch.core import FeaturePlan
    from repro_torch.serve import FaultPolicy, FeatureService
    table, fs = _sharded_table()
    plan = FeaturePlan(table, fs, packed=True, device=cuda)
    rows = np.arange(0, 64)
    want = plan.host_features(rows)
    pol = FaultPolicy(hedge=True, hedge_min_s=0.02, hedge_factor=2.0,
                      straggler_min_s=10.0, breaker_fails=100)
    with FeatureService(plan, sharded=True, buckets=(64,), coalesce=1,
                        devices=[cuda], fault_policy=pol) as svc:
        svc.add_replica(0)
        for _ in range(10):
            assert np.array_equal(svc.result(svc.submit(rows), timeout=60),
                                  want)
        streams = svc._sharded_ex.stream_executors(0)
        with svc._lock:
            busy = streams[(svc._stream_rr[0] + 1) % len(streams)]
        torch.cuda.synchronize()
        with torch.cuda.stream(busy.stream):
            torch.cuda._sleep(5 * SPIN)
        got = svc.result(svc.submit(rows), timeout=60)
        # a launch on shard 1 rebinds the pump's flight: the loser is freed
        other = np.arange(20000, 20064)
        assert np.array_equal(svc.result(svc.submit(other), timeout=60),
                              plan.host_features(other))
        pinned = [torch.full((64, plan.out_dim), 7.0).pin_memory()
                  for _ in range(32)]
        assert not busy.stream.query()           # the loser still waits
        torch.cuda.synchronize()
        assert svc.stats["hedges"] == svc.stats["hedge_wins"] == 1
        assert svc.stats["failed_tickets"] == 0
    assert np.array_equal(got, want)
    for p in pinned:
        assert bool((p == 7.0).all())


@pytest.mark.cuda
def test_demote_promote_roundtrip_on_card(cuda):
    """A tiered service on cuda:0 (a budget of two streams): the shards
    past it start warm and are served from the host; a demotion frees the
    card's memory by the stream's bytes, cold shards serve from their
    runs, a promotion puts the words back, and every answer equals the
    same service's on the CPU bit for bit."""
    from repro_torch.core import FeaturePlan
    from repro_torch.serve import FeatureService
    table, fs = _sharded_table()
    reqs = _shard_requests(np.random.default_rng(6), table.n_rows, 60)
    served = {}
    for dev in (cuda, torch.device("cpu")):
        plan = FeaturePlan(table, fs, packed=True, device=dev)
        with FeatureService(plan, sharded=True, devices=[dev],
                            buckets=(64, 256), max_replicas=0,
                            hbm_budget_bytes=1) as probe:
            stream_b = probe._sharded_ex.executors[0].stream_nbytes()
        with FeatureService(plan, sharded=True, devices=[dev],
                            buckets=(64, 256), max_replicas=0,
                            hbm_budget_bytes=2 * stream_b) as svc:
            got = [svc.tiers]
            got += [svc.result(svc.submit(r), timeout=60) for r in reqs]
            if dev.type == "cuda":
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_allocated()
            freed = svc.demote(0, "warm")
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert m0 - torch.cuda.memory_allocated() >= stream_b
            svc.demote(0, "cold")
            svc.demote(1, "cold")
            got += [svc.tiers, freed]
            got += [svc.result(svc.submit(r), timeout=60) for r in reqs]
            got += [svc.promote(0), svc.promote(2)]
            got += [svc.result(svc.submit(r), timeout=60) for r in reqs]
            got += [svc.tiers, {k: svc.stats[k] for k in (
                "promotions", "demotions", "rehydrations", "tier_hot",
                "tier_warm", "tier_cold", "failed_tickets")}]
        for r, g in zip(reqs * 3, [g for g in got
                                   if isinstance(g, np.ndarray)]):
            assert np.array_equal(g, plan.host_features(r))
        served[dev.type] = got
    for a, b in zip(served["cuda"], served["cpu"]):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b
    assert served["cuda"][0] == ["hot", "hot", "warm", "warm"]


# -- the LM serving path (no hand-written kernel: cuBLAS products) ------------------
LM_ARCHS = ("glm4-9b", "qwen2-7b", "minicpm-2b", "starcoder2-15b",
            "llava-next-mistral-7b", "moonshot-v1-16b-a3b",
            "llama4-maverick-400b-a17b", "xlstm-1.3b", "hymba-1.5b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("max_len", [24, 2048])
def test_lm_engine_on_card_matches_cpu(cuda, arch, max_len):
    """The LM at reduced width in float32, the parameters drawn on the CPU
    and copied: the engine built with no device serves on ``cuda``, and
    ``lm_parity.check_card_matches_cpu`` (the check phase 8 of
    ``chip_smoke.py`` runs) holds it to the CPU: greedy tokens equal, and
    prefill and decode logits within rtol 1e-4 / atol 1e-5 in units of
    the CPU logits' standard deviation (a MoE arch's expert ids equal but
    for near-ties, ``lm_parity.route_flips``; xlstm's atol 1e-4,
    ``lm_parity.ATOL_BY_ARCH``). At max_len 2,048 the prefill takes the
    flash path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve import lm_parity
    assert not torch.backends.cuda.matmul.allow_tf32
    lm_parity.check_card_matches_cpu(reduced(get_config(arch)), seed=1,
                                     max_len=max_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ff_on_card_makes_no_host_sync(cuda, dtype):
    """``moe_ff`` on the card under ``set_sync_debug_mode("error")`` (any
    host synchronisation raises): a prefill-sized call whose capacity drops
    pairs, and a decode-sized one. Its float32 output against the same call
    on the CPU, expert ids equal."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    d, f, e, k = 64, 96, 16, 3
    w = [torch.randn(shape, generator=gen) / shape[-2] ** 0.5
         for shape in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    for g, s, factor in ((4, 64, 1.0), (8, 1, 1.25)):
        x = torch.randn((g, s, d), generator=gen)
        args = [x] + w
        outs = []
        for dev in ("cpu", cuda):
            on = [a.to(dev) if i == 1 else a.to(dev, dtype)
                  for i, a in enumerate(args)]
            torch.cuda.synchronize()
            with moe.routing_trace() as tr:
                if dev == cuda:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    out, aux, z = moe.moe_ff(*on, top_k=k, cap_factor=factor)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            outs.append((out.float().cpu(), tr.calls[0].idx.cpu(),
                         tr.calls[0].keep.cpu()))
        (want, ids, keep), (got, card_ids, card_keep) = outs
        assert torch.equal(ids, card_ids) and torch.equal(keep, card_keep)
        if s > 1:
            assert not keep.all()             # the capacity dropped pairs
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_lm_int8_cache_on_card_matches_cpu(cuda):
    """The int8 KV cache on the card: the quantizer bit for bit on the same
    input, cache codes at most one apart, logits as above."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.serve import lm_parity
    cfg = dataclasses.replace(reduced(get_config("glm4-9b")),
                              kv_cache_dtype="int8")
    lm_parity.check_card_matches_cpu(cfg, seed=1, max_len=24)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [6, 2048, None])
def test_lm_audio_on_card_matches_cpu(cuda, frames):
    """Reduced seamless in float32 through ``check_card_matches_cpu``:
    over the loader's frames (6, both routes of ``_bidir_attention``
    direct; 2,048, both flash), served by prefill with them and decode on
    the memory; and (None) through the engine on an empty memory. Tokens
    equal, logits within rtol 1e-4 / atol 1e-5 std."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.serve import lm_parity
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    fr = None
    if frames is not None:
        store = TokenStore(synthetic_corpus(10_000, cfg.vocab), cfg.vocab)
        fr = next(token_batches(store, cfg, batch=lm_parity.BATCH,
                                seq=frames, device="cpu"))["frames"].numpy()
    lm_parity.check_card_matches_cpu(cfg, seed=1, max_len=24, frames=fr)


@pytest.mark.cuda
def test_token_batches_on_the_card(cuda):
    """With no device named the loader's batches are on ``cuda``, each
    tensor equal to the same batch made for the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    for arch in ("glm4-9b", "llava-next-mistral-7b", "seamless-m4t-large-v2"):
        cfg = reduced(get_config(arch))
        store = TokenStore(synthetic_corpus(10_000, cfg.vocab), cfg.vocab,
                           device_unpack=True)
        card = next(token_batches(store, cfg, batch=3, seq=32, seed=2,
                                  start_step=4))
        host = next(token_batches(store, cfg, batch=3, seq=32, seed=2,
                                  start_step=4, device="cpu"))
        assert card.keys() == host.keys()
        for k, t in card.items():
            assert t.is_cuda and torch.equal(t.cpu(), host[k]), k


@pytest.mark.cuda
def test_lm_entry_points_default_to_the_card(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    cfg = reduced(get_config("glm4-9b"))
    params = lm.init_params(cfg, 0)
    assert all(t.is_cuda for t in params["blocks"][0]["attn"].values())
    assert lm.params_from_reference(lm.params_to_numpy(params))[
        "embed"].is_cuda
    assert lm.init_serve_state(cfg, 1, 8)["blocks"][0]["k"].is_cuda
    assert ServeEngine(cfg, params, batch_size=1, max_len=8).device.type \
        == "cuda"


# -- LM training ---------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["glm4-9b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b", "seamless-m4t-large-v2"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.train import parity
    for seed in range(2):
        parity.check_train_card_matches_cpu(reduced(get_config(arch)), cuda,
                                            seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0.0, 1024.0])
def test_flash_backward_on_card_matches_direct(cuda, window, dtype):
    """dq, dk, dv of the flash Function against autograd of direct softmax
    attention over the same values in float32 (chip_smoke's phase 9B
    bounds: 1e-4 of max |reference| in float32, 1e-2 in bf16)."""
    from repro_torch.models.flash import flash_attention
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    b, s, kvh, g, dh = 2, 2048, 4, 2, 64
    ins = [torch.randn(shape, generator=gen, device=cuda).to(dtype)
           for shape in ((b, s, kvh, g, dh), (b, s, kvh, dh),
                         (b, s, kvh, dh))]
    ins[0] = ins[0] * dh ** -0.5
    dout = torch.randn((b, s, kvh, g, dh), generator=gen,
                       device=cuda).to(dtype)
    q_pos = torch.arange(s, dtype=torch.float32, device=cuda)
    kbias = torch.zeros(s, device=cuda)
    leaves = [x.clone().requires_grad_() for x in ins]
    out = flash_attention(*leaves, q_pos, kbias, window, 1024)
    got = torch.autograd.grad(out, leaves, dout)
    want = _flash_grads(_direct_attention, *[x.float() for x in ins],
                        dout.float(), q_pos, kbias, window, 1024)[1:]
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, r in zip(got, want):
        assert a.is_cuda and a.dtype == dtype
        assert float((a.float() - r).abs().max()) <= \
            tol * float(r.abs().max())


# -- flash attention's kernels ------------------------------------------------------
# the benchmark cells' attention layers: (B, S, KV, G, dh, T, kv_len)
FLASH_CELLS = {"minicpm-2b": (2, 2048, 36, 1, 64, 2048, None),
               "glm4-9b": (8, 1500, 2, 16, 128, 2048, 1500)}
# bf16 against float32 direct attention over the same bf16 values, by
# chip_smoke's flash_row_error (each row's error on its own scale): phase
# 9F's limit, so both hold one rule
FLASH_BF16_TOL = cs.FLASH_ROW_TOL
# against the plain version, which reads up to 6.6e-2 from direct attention
# itself (its chunks' bf16 p.v feed delta, and so dq): three times the
# largest of 24 kernel readings against it (6.7e-2), below every planted
# fault's reading against direct attention (0.97)
FLASH_PLAIN_TOL = 0.2


def _flash_inputs(cuda, b, s, kvh, g, dh, t, dtype, seed=0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    qg = torch.randn((b, s, kvh, g, dh), generator=gen, device=cuda) * \
        dh ** -0.5
    k, v = (torch.randn((b, t, kvh, dh), generator=gen, device=cuda)
            for _ in range(2))
    dout = torch.randn((b, s, kvh, g, dh), generator=gen, device=cuda)
    return [x.to(dtype) for x in (qg, k, v, dout)]


def _flash_grads(fn, qg, k, v, dout, *rest):
    leaves = [x.clone().requires_grad_() for x in (qg, k, v)]
    out = fn(*leaves, *rest)
    return [out.detach()] + list(torch.autograd.grad(out, leaves, dout))


def _direct_attention(qg, k, v, q_pos, kbias, window, kv_chunk):
    """Softmax over every score in float32, the flash function's value: a
    masked score (at or below -5e29) weighs 0, a row with none kept is 0."""
    from repro_torch.models.flash import NEG_INF, _mask
    t = k.shape[1] - k.shape[1] % kv_chunk
    k_pos = torch.arange(t, dtype=torch.float32, device=k.device)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k[:, :t].float())
    scores = scores + _mask(q_pos, k_pos, window, kbias[:t])
    p = torch.where(scores > NEG_INF / 2,
                    torch.exp(scores - scores.amax(-1, keepdim=True)), 0.0)
    probs = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bkgst,btkd->bskgd", probs, v[:, :t].float())


def _max_rel(a, r) -> float:
    return float((a.float() - r.float()).abs().max()) / \
        float(r.float().abs().max())


def _within(a, r, dtype, bf16_tol=FLASH_BF16_TOL) -> tuple[bool, float]:
    """float32: max |a - r| within 1e-4 of max |r|; bf16: each row's error
    on its own scale (``cs.flash_row_error``) within ``bf16_tol``."""
    if dtype == torch.float32:
        return _max_rel(a, r) <= 1e-4, _max_rel(a, r)
    err = cs.flash_row_error(a, r)
    return err <= bf16_tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0.0, 1024.0])
@pytest.mark.parametrize("cell", sorted(FLASH_CELLS))
def test_flash_kernels_match_plain_and_direct_on_card(cuda, cell, window):
    """The forward and all three gradients of the kernels (bf16, the
    cells' dtype) at each benchmark cell's layer shape: each row within
    ``FLASH_BF16_TOL`` on its own scale against float32 direct attention
    over the same bf16 values, and within ``FLASH_PLAIN_TOL`` against the
    plain version (its chunks' bf16 p.v, the kernel's float32 one, both
    bf16 outputs). One forward and one dQ and dK/dV launch each."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models.flash import (_bwd_scan, _fwd_scan,
                                          flash_attention)
    b, s, kvh, g, dh, t, kv_len = FLASH_CELLS[cell]
    qg, k, v, dout = _flash_inputs(cuda, b, s, kvh, g, dh, t,
                                   torch.bfloat16)
    q_pos = torch.arange(s, dtype=torch.float32, device=cuda)
    kbias = torch.zeros(t, device=cuda)
    if kv_len is not None:
        kbias[kv_len:] = -1e30
    flash_ops.reset_launches()
    got = _flash_grads(flash_attention, qg, k, v, dout, q_pos, kbias,
                       window, 1024)
    assert flash_ops.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkdv": 1}
    out32, m, l = _fwd_scan(qg, k, v, q_pos, kbias, window, 1024)
    plain = [out32.to(qg.dtype)] + list(_bwd_scan(
        dout, qg, k, v, q_pos, kbias, out32, m, l, window, 1024))
    direct = _flash_grads(_direct_attention, qg.float(), k.float(),
                          v.float(), dout.float(), q_pos, kbias, window, 1024)
    for name, a, p, r in zip(("out", "dq", "dk", "dv"), got, plain, direct):
        assert a.dtype == torch.bfloat16 and a.shape == p.shape
        for ref_, tol in ((r, FLASH_BF16_TOL), (p, FLASH_PLAIN_TOL)):
            ok, err = _within(a, ref_, torch.bfloat16, tol)
            assert ok, (name, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(cs.FLASH_FAULTS))
def test_flash_check_catches_planted_faults_on_card(cuda, fault):
    """The bf16 check has teeth: a fault planted in the live-tile bounds
    (the first live key tile skipped past 1,024 keys, or the diagonal tile
    left unmasked) reads above ``FLASH_BF16_TOL`` at the train cell's
    layer shape, where the sound kernels read within it."""
    b, s, kvh, g, dh, t, kv_len = FLASH_CELLS["minicpm-2b"]
    ins = cs.flash_cell_inputs(cuda, 0, b, s, kvh, g, dh, t, kv_len)
    want = cs.flash_direct_grads(*ins, 0.0)
    sound = cs.flash_kernel_grads(*ins, 0.0)
    bad = cs.flash_kernel_grads(*ins, 0.0, cs.FLASH_FAULTS[fault])
    assert max(cs.flash_row_error(a, r) for a, r in zip(sound, want)) <= \
        FLASH_BF16_TOL
    assert max(cs.flash_row_error(a, r) for a, r in zip(bad, want)) > \
        FLASH_BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_pinned_positions_and_masked_rows_on_card(cuda, dtype):
    """Queries pinned to T (``blocks._bidir_attention``: every key live),
    a cache tail masked by ``kbias``, keys past the last whole chunk, and
    query rows no key is kept for (positions below 0): the kernels against
    float32 direct attention (float32 inputs within 1e-4 of max |ref|,
    bf16 each row within ``FLASH_BF16_TOL``); a fully masked row's output
    and dq are exactly 0, as are dk and dv of the masked and unread keys."""
    from repro_torch.models.flash import flash_attention
    b, kvh, g, t = 2, 2, 4, 2100
    for dh in (16, 32, 64, 128):
        s = 37
        qg, k, v, dout = _flash_inputs(cuda, b, s, kvh, g, dh, t, dtype,
                                       seed=dh)
        pinned = torch.full((s,), 2048.0, device=cuda)
        staggered = torch.arange(s, dtype=torch.float32, device=cuda) * 60 \
            - 120.0                   # positions 0 and 1 below every key
        kbias = torch.where(torch.arange(t, device=cuda) < 1900, 0.0, -1e30)
        for q_pos, window in ((pinned, 0.0), (staggered, 0.0),
                              (staggered, 300.0)):
            got = _flash_grads(flash_attention, qg, k, v, dout, q_pos, kbias,
                               window, 1024)
            want = _flash_grads(_direct_attention, qg.float(), k.float(),
                                v.float(), dout.float(), q_pos, kbias, window,
                                1024)
            for name, a, r in zip(("out", "dq", "dk", "dv"), got, want):
                ok, err = _within(a, r, dtype)
                assert ok, (dh, window, name, err)
            assert not got[3][:, 1900:].any() and not got[2][:, 1900:].any()
            if q_pos is staggered:
                assert not got[0][:, :2].any() and not got[1][:, :2].any()


@pytest.mark.cuda
def test_flash_kernels_count_launches_and_refuse_on_card(cuda):
    """``LAUNCHES`` moves once per kernel and call; the library gives the
    wrapper its tiles for every head size and dtype it takes and refuses
    another; a head size, dtype or device the kernels do not take raises
    (no fallback); a fake tensor (the dry-run's trace) gets its outputs
    and no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models.flash import flash_attention
    for dh in flash_ops.HEAD_DIMS:
        for np_ in (1, 3):
            bm, bn, bq, bkv = flash_ops.tiles(dh, np_)
            assert min(bm, bn, bq, bkv) >= 16 and bq <= 128
    with pytest.raises(RuntimeError):
        flash_ops.tiles(48, 1)
    qg, k, v, dout = _flash_inputs(cuda, 1, 64, 2, 2, 64, 2048,
                                   torch.bfloat16)
    q_pos = torch.arange(1984, 2048, dtype=torch.float32, device=cuda)
    kbias = torch.zeros(2048, device=cuda)
    flash_ops.reset_launches()
    for _ in range(3):
        _flash_grads(flash_attention, qg, k, v, dout, q_pos, kbias, 0.0,
                     1024)
    assert flash_ops.LAUNCHES == {"flash_fwd": 3, "flash_bwd_dq": 3,
                                  "flash_bwd_dkdv": 3}
    for bad, err in ((dict(dh=48), ValueError), (dict(dh=256), ValueError),
                     (dict(dtype=torch.float16), TypeError)):
        dh, dtype = bad.get("dh", 64), bad.get("dtype", torch.bfloat16)
        x = _flash_inputs(cuda, 1, 8, 1, 1, dh, 2048, dtype)
        with pytest.raises(err):
            flash_attention(*x[:3], q_pos[:8], kbias, 0.0, 1024)
    with pytest.raises(ValueError):
        flash_ops.forward(*[x.cpu() for x in (qg, k, v, q_pos, kbias)], 0.0,
                          1024)
    flash_ops.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(x) for x in (qg, k, v, q_pos, kbias, dout)]
        out, out32, m, l, bounds = flash_ops.forward(*fake[:5], 0.0, 1024)
        grads = flash_ops.backward(fake[5], *fake[:5], out32, m, l, bounds,
                                   0.0, 1024)
    assert out.shape == qg.shape and m.shape == (1, 2, 2, 64)
    assert [x.shape for x in grads] == [qg.shape, k.shape, v.shape]
    assert flash_ops.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkdv": 0}


def _train_setup(device=None):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStore, synthetic_corpus
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced(get_config("qwen2-7b")), vocab=512,
                              vocab_pad_multiple=64)
    store = TokenStore(synthetic_corpus(60_000, cfg.vocab), cfg.vocab)
    return cfg, lm.init_params(cfg, 0, device=device), store


@pytest.mark.cuda
def test_trainer_checkpoint_resume_on_card(cuda, tmp_path):
    """16 uninterrupted steps against 8, a checkpoint, and a new Trainer
    resumed from it for the other 8 (a constant lr, so the two runs' steps
    are the same): the resumed losses within 1e-5 relative of the
    uninterrupted run's."""
    import copy
    from repro_torch.data import token_batches
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    def trainer(steps, ckpt_dir=""):
        return Trainer(cfg=cfg, opt=OptConfig(lr=1e-2),
                       train=TrainConfig(steps=steps, warmup=2,
                                         schedule="constant", log_every=1,
                                         ckpt_every=8, ckpt_dir=ckpt_dir))

    cfg, params, store = _train_setup(cuda)
    _, whole = trainer(16).fit(copy.deepcopy(params),
                               token_batches(store, cfg, batch=8, seq=16))
    _, first = trainer(8, str(tmp_path)).fit(
        params, token_batches(store, cfg, batch=8, seq=16))
    assert ck.latest_steps(str(tmp_path)) == [8]
    resumed_t = trainer(16, str(tmp_path))
    fresh = _train_setup(cuda)[1]
    params2, resumed = resumed_t.fit(
        fresh, token_batches(store, cfg, batch=8, seq=16, start_step=8))
    assert resumed_t.fault_log.summary() == {"restart": 1}
    assert params2["embed"].is_cuda
    assert [h["step"] for h in resumed] == list(range(8, 16))
    for a, b in zip(resumed, whole[8:]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
    assert [h["loss"] for h in first] == pytest.approx(
        [h["loss"] for h in whole[:8]], rel=1e-5)


@pytest.mark.cuda
def test_training_entry_points_default_to_the_card(cuda, capsys):
    from repro_torch.data import token_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg, params, store = _train_setup()
    assert params["embed"].is_cuda
    t = Trainer(cfg=cfg, opt=OptConfig(name="adamw8", lr=1e-2),
                train=TrainConfig(steps=3, warmup=1, log_every=1,
                                  ckpt_every=0))
    params, hist = t.fit(params, token_batches(store, cfg, batch=2, seq=16))
    assert len(hist) == 3 and all(v.is_cuda for v in params["blocks"][0][
        "attn"].values())
    assert t.opt_state["v"]["embed"].is_cuda
    history = launch_train.main(["--arch", "qwen2-7b", "--preset", "smoke",
                                 "--steps", "8", "--batch", "4", "--seq",
                                 "16"])
    assert "on cuda" in capsys.readouterr().out
    assert history[-1]["loss"] < history[0]["loss"]
