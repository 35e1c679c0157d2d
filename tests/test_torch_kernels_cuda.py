"""The CUDA kernels against their plain PyTorch versions, on a card.

Needs a CUDA device and ``nvcc`` (the kernels build at first use); every
test skips without a card. Imports neither JAX nor the reference package,
so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.adv_gather import ops, ref

DBS = (1, 2, 4, 8, 16, 32)
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
