"""The CUDA kernels against their plain PyTorch versions, on a card: the
three ADV gathers, the predicate scan and the masked counts.

Needs a CUDA device and ``nvcc`` (the kernels build at first use); every
test skips without a card. Imports neither JAX nor the reference package,
so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import edge_cases
from repro_torch.kernels.adv_gather import ops, ref
from repro_torch.kernels.hist import ops as hist_ops
from repro_torch.kernels.hist import ref as hist_ref
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
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and torch.equal(got, want)
    assert all(ops.LAUNCHES[k] == before[k] + 1 for k in before)


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
