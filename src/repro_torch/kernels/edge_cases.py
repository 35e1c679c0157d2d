"""Edge-case inputs that hold the CUDA kernels against their plain versions
on a card: a random packed stream at every device width, the scan's term
sets, the masked counts' cases and the one-hot wide layer's grid.

``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` both draw their
edge sets from here, so the two stay one set. Nothing here launches a
kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.adv_gather import ops
from repro_torch.kernels.predicate_scan.ops import ScanTerm

DBS = (1, 2, 4, 8, 16, 32)
# k past the shared-memory counters of the masked counts (58,112 int32 in
# 227 KB): the last shared k, the first global one, and one far past it
SHARED_LIMIT_KS = (58_112, 58_113, 100_000)


def random_stream(rng: np.random.Generator, cap: int, device,
                  dbs=DBS) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """Random words for ``cap`` rows at each width, back to back (codes
    past every table, 32-bit fields past 2**31): (flat, wmeta, word
    offsets)."""
    words = [rng.integers(0, 1 << 32, cap * db // 32,
                          dtype=np.uint64).astype(np.uint32) for db in dbs]
    offs = [int(o) for o in np.cumsum([0] + [w.size for w in words])[:-1]]
    flat = torch.from_numpy(np.concatenate(words).view(np.int32)).to(device)
    return flat, ops.word_meta(offs, dbs, device), offs


def scan_term_sets(rng: np.random.Generator) -> list[list[ScanTerm]]:
    """Term sets over a :func:`random_stream` at :data:`DBS`: both kinds at
    every width, two terms on one column, LUTs shorter than the codes (the
    clamp), an empty and a full selection, the whole int32 range."""
    T = ScanTerm
    return [
        [T(col=3, kind=0, lo=10, hi=200),
         T(col=0, kind=1, lut=np.array([0, 1], np.int32))],
        [T(col=5, kind=1, lut=(rng.random(300) < 0.5).astype(np.int32)),
         T(col=4, kind=0, lo=-5, hi=40000),
         T(col=2, kind=1, lut=np.array([1, 0, 1], np.int32)),
         T(col=4, kind=1, lut=(rng.random(1 << 16) < 0.3).astype(np.int32))],
        [T(col=1, kind=0, lo=1, hi=0)],                   # empty
        [T(col=1, kind=0, lo=0, hi=3)],                   # full
        [T(col=5, kind=0, lo=-(1 << 31), hi=(1 << 31) - 1)],
    ]


def masked_counts_cases(rng: np.random.Generator, cap: int, device):
    """(cases, masks) for the masked counts: every width of a
    :func:`random_stream` at k = 1, k below the codes (codes >= k dropped)
    and k = 2**db (up to 4,096), plus width-32 codes below 120,000 at
    :data:`SHARED_LIMIT_KS`; each case ``(words, off, db, k)``. Masks:
    all false, all true, random."""
    flat, _, offs = random_stream(rng, cap, device)
    codes32 = rng.integers(0, 120_000, cap).astype(np.uint32)
    flat32 = torch.from_numpy(codes32.view(np.int32)).to(device)
    cases = [(flat, offs[c], db, k) for c, db in enumerate(DBS)
             for k in (1, 3, 1 << min(db, 12))]
    cases += [(flat32, 0, 32, k) for k in SHARED_LIMIT_KS]
    masks = [torch.zeros(cap, dtype=torch.bool, device=device),
             torch.ones(cap, dtype=torch.bool, device=device),
             torch.from_numpy(rng.random(cap) < 0.4).to(device)]
    return cases, masks


# the one-hot wide layer's grid: every (C, K, F) with every N
ONEHOT_CS = (0, 1, 8)
ONEHOT_NS = (0, 1, 33, 1024)
ONEHOT_KS = (1, 4, 600, 65_537)
ONEHOT_FS = (1, 129)


def onehot_wide_cases(rng: np.random.Generator, device, cs=ONEHOT_CS,
                      ns=ONEHOT_NS, ks=ONEHOT_KS, fs=ONEHOT_FS):
    """Yield ``(codes, w, g)`` for the one-hot wide layer over every
    (C, K, F) and N of the grid: codes mostly in [0, K), with -1, K,
    2**31 - 1 and -2**31 among them (out of range: they add nothing and get
    no gradient); w (C, K, F) float32, finite; g (N, F) float32, the output
    gradient. One w per (C, K, F), shared by its Ns."""
    special = np.array([-1, 0, (1 << 31) - 1, -(1 << 31)], np.int64)
    for c in cs:
        for k in ks:
            for f in fs:
                w = torch.from_numpy(rng.standard_normal(
                    (c, k, f), dtype=np.float32)).to(device)
                for n in ns:
                    codes = rng.integers(0, k, (c, n))
                    special[1] = k
                    for ci in range(c):
                        at = rng.permutation(n)[:special.size]
                        codes[ci, at] = special[:at.size]
                    codes = torch.from_numpy(codes.astype(np.int32)).to(device)
                    g = torch.from_numpy(rng.standard_normal(
                        (n, f), dtype=np.float32)).to(device)
                    yield codes, w, g
