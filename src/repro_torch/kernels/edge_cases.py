"""Edge-case inputs that hold the CUDA kernels against their plain versions
on a card: a random packed stream at every device width, the packed-rows
gather's plans and row counts, the range gather's ranges over the same
plans, the int32 multi-table gather's plans and row counts, the scan's
term sets and its layout cases (word offsets off every multiple of 4,
every width under both kinds, ragged n), the masked counts' cases (and the
word-major kernel's grid), the one-hot wide layer's grid (with a shape for
its gradient's grouped route) and its forward's grid, and the Table 6
path's bit-unpack, counts and single-table gather cases.

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


def random_stream(rng: np.random.Generator, cap: int, device, dbs=DBS,
                  gaps=None, high=1 << 32
                  ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """Random words below ``high`` for ``cap`` rows at each width, back to
    back (codes past every table; by default 32-bit fields past 2**31):
    (flat, wmeta, word offsets). ``gaps`` puts that many random words
    before each column, so its word offset need not be a multiple of 4."""
    gaps = (0,) * len(dbs) if gaps is None else gaps
    words, offs, off = [], [], 0
    for db, gap in zip(dbs, gaps):
        if gap:
            words.append(rng.integers(0, high, gap, dtype=np.uint64)
                         .astype(np.uint32))
        off += gap
        offs.append(off)
        words.append(rng.integers(0, high, cap * db // 32,
                                  dtype=np.uint64).astype(np.uint32))
        off += words[-1].size
    flat = torch.from_numpy(np.concatenate(words).view(np.int32)).to(device)
    return flat, ops.word_meta(offs, dbs, device), offs


# the packed-rows gather's plans: (stream column, K, F) per table, over a
# random_stream at DBS; out_dims 1, 31, 33, 58 (the serving widths 8/8/8/2)
# and 200, most K below 2**db so codes clamp
PACKED_ROWS_PLANS = (
    ((3, 200, 1),),
    ((0, 2, 1), (1, 3, 3), (2, 11, 2), (3, 200, 5), (4, 3000, 10),
     (5, 1000, 10)),
    ((0, 2, 1), (1, 3, 3), (2, 11, 2), (3, 200, 5), (4, 3000, 11),
     (5, 1000, 11)),
    ((3, 72, 2), (3, 50, 50), (3, 230, 2), (1, 4, 4)),
    ((0, 2, 1), (1, 3, 3), (2, 11, 2), (3, 200, 5), (4, 3000, 89),
     (5, 1000, 100)),
)
# 33 rows end one row past any tile of up to 32 rows
PACKED_ROWS_NS = (1, 7, 33, 5000)


def packed_rows_cases(rng: np.random.Generator, device, cap: int = 4096):
    """Yield ``(flat, wmeta, fused, rows)`` for the packed-rows gather: each
    plan of :data:`PACKED_ROWS_PLANS` over one :func:`random_stream` (codes
    past every table, 32-bit fields past 2**31), at each row count of
    :data:`PACKED_ROWS_NS`; rows at word boundaries and the stream's last
    row among them."""
    flat, wmeta, _ = random_stream(rng, cap, device)
    for plan in PACKED_ROWS_PLANS:
        tables = [rng.standard_normal((k, f)).astype(np.float32)
                  for _, k, f in plan]
        fused = ops.fuse_tables(tables, device)
        sub = wmeta[torch.tensor([col for col, _, _ in plan],
                                 device=device)].contiguous()
        for n in PACKED_ROWS_NS:
            rows = rng.integers(0, cap, n)
            ends = np.array([cap - 1, 0, 31, 32, 33, 15, 16])
            rows[:min(n, ends.size)] = ends[:n]
            yield flat, sub, fused, torch.from_numpy(
                rows.astype(np.int32)).to(device)


# the range gather's plans: the packed-rows gather's, and 40 tables over
# the six stream columns (out_dim 60), several tables to a column; its
# range counts and rows a range, over a random_stream of
# PACKED_RANGE_CAP rows: a 4,096-row range has two aligned places in it
PACKED_RANGE_PLANS = PACKED_ROWS_PLANS + (
    tuple((c % 6, (2, 3, 11, 20, 5, 7)[c % 6], 1 + c % 2)
          for c in range(40)),)
PACKED_RANGE_KS = (1, 3, 17)
PACKED_RANGE_BATCHES = (32, 96, 4096)
PACKED_RANGE_CAP = 8192


def packed_range_starts(rng: np.random.Generator, k: int, batch: int,
                        cap: int = PACKED_RANGE_CAP) -> list[int]:
    """``k`` range starts for ``batch``-row ranges over ``cap`` rows: the
    last aligned range inside the stream (k = 1); with it 0 and a range
    reaching 32 rows past the stream's end, where the word index clamps
    (k = 3); and for k = 17 also a duplicated start, ranges overlapping it
    (aligned, and 7 rows on), a negative start (its first rows read row
    0) and random aligned ones."""
    last = cap - batch
    if k == 1:
        return [last]
    if k == 3:
        return [0, last + 32, last]
    s = int(rng.integers(0, last // 32 + 1)) * 32
    rest = rng.integers(0, cap // 32, k - 8) * 32
    return [0, last, last + 32, s, s, s + 32, s + 7, -32, *rest.tolist()]


def packed_range_cases(rng: np.random.Generator, device,
                       cap: int = PACKED_RANGE_CAP):
    """Yield ``(flat, wmeta, fused, starts, batch)`` for the range gather:
    each plan of :data:`PACKED_RANGE_PLANS` (out_dims 1, 31, 33, 58, 200
    and 60 over 40 tables) over one :func:`random_stream` (codes past every
    table, 32-bit fields past 2**31), at each batch of
    :data:`PACKED_RANGE_BATCHES` and each range count of
    :data:`PACKED_RANGE_KS`, the starts of :func:`packed_range_starts`."""
    flat, wmeta, _ = random_stream(rng, cap, device)
    for plan in PACKED_RANGE_PLANS:
        tables = [rng.standard_normal((k, f)).astype(np.float32)
                  for _, k, f in plan]
        fused = ops.fuse_tables(tables, device)
        sub = wmeta[torch.tensor([col for col, _, _ in plan],
                                 device=device)].contiguous()
        for batch in PACKED_RANGE_BATCHES:
            for k in PACKED_RANGE_KS:
                starts = packed_range_starts(rng, k, batch, cap)
                yield flat, sub, fused, torch.tensor(
                    starts, dtype=torch.int32, device=device), batch


# the int32 multi-table gather's plans, (K, F) per table: out_dims 1 (C =
# 1), 4 (the train step's), 31 and 33 (C = 6, a K = 1 table), 58 (the int32
# service's), 200, and 17 over C = 9 (past the 8 codes of a row the kernel
# loads at once); and its row counts
MULTI_PLANS = (
    ((200, 1),),
    ((72, 2), (230, 2)),
    ((1, 1), (3, 3), (11, 2), (200, 5), (700, 10), (300, 10)),
    ((1, 1), (3, 3), (11, 2), (200, 5), (700, 11), (300, 11)),
    ((72, 2), (50, 50), (230, 2), (4, 4)),
    ((1, 1), (3, 3), (11, 2), (200, 5), (700, 89), (300, 100)),
    ((1, 1), (3, 2), (5, 1), (7, 3), (2, 2), (11, 1), (4, 4), (9, 2),
     (6, 1)),
)
MULTI_NS = (1, 7, 33, 1024, 5000)


def multi_cases(rng: np.random.Generator, device):
    """Yield ``(fused, codes)`` for the int32 multi-table gather: each plan
    of :data:`MULTI_PLANS` at each n of :data:`MULTI_NS`, codes (C, n) in
    [-3, K + 3) with the int32 ends and K among them (they clamp into
    their own table)."""
    for plan in MULTI_PLANS:
        fused = ops.fuse_tables([rng.standard_normal((k, f))
                                 .astype(np.float32) for k, f in plan],
                                device)
        for n in MULTI_NS:
            codes = np.stack([_codes_with_ends(rng, k, n) for k, _ in plan])
            yield fused, torch.from_numpy(codes).to(device)


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


# the scan's layout cases: each column's words after 0 words (offsets all
# multiples of 4: SCAN_LAYOUT_CAP is a multiple of 128 rows) or after 1, 1,
# 1, 2, 1, 1 (offsets 1, 2, 3, 1, 2, 3 mod 4: none a multiple of 4); n of
# one row, around a 16-row group, past 128 rows, and one row past a block's
# 8,192-row step (predicate_scan.cu)
SCAN_LAYOUT_GAPS = ((0,) * len(DBS), (1, 1, 1, 2, 1, 1))
SCAN_LAYOUT_NS = (1, 15, 16, 17, 127, 129, 4097, 8193)
SCAN_LAYOUT_CAP = 8320


def scan_layout_term_sets(rng: np.random.Generator) -> list[list[ScanTerm]]:
    """Term sets over a stream at :data:`DBS`: a range and a LUT (some
    shorter than the codes: the clamp) at every width; ranges reaching
    below 0 and past 2**db, empty after the clamp, and lo > hi; the
    pushdown path's two shapes (an 8-bit range and an 8-bit LUT; a 2-bit
    LUT and an 8-bit LUT), four widths in one set, and 40 terms (past
    the 32 the kernel stages at once)."""
    T = ScanTerm
    sets = []
    for c, db in enumerate(DBS):
        k = 1 << min(db, 12)
        lo = int(rng.integers(0, k))
        sets.append([T(col=c, kind=0, lo=lo, hi=int(rng.integers(lo, k)))])
        size = int(rng.integers(1, k + 3))
        sets.append([T(col=c, kind=1,
                       lut=(rng.random(size) < 0.5).astype(np.int32))])
    sets += [
        [T(col=3, kind=0, lo=-7, hi=300)],               # full after clamp
        [T(col=3, kind=0, lo=260, hi=400)],              # empty after clamp
        [T(col=1, kind=0, lo=-3, hi=-1)],                # empty: below 0
        [T(col=4, kind=0, lo=-100, hi=70_000)],
        [T(col=0, kind=0, lo=1, hi=5)],
        [T(col=2, kind=0, lo=9, hi=4)],                  # lo > hi
        [T(col=1, kind=0, lo=19, hi=19),
         T(col=3, kind=1, lut=(rng.random(72) < 0.2).astype(np.int32))],
        [T(col=1, kind=1, lut=np.array([0, 1, 0, 1], np.int32)),
         T(col=3, kind=1, lut=(rng.random(230) < 0.5).astype(np.int32))],
        [T(col=0, kind=1, lut=np.array([1], np.int32)),
         T(col=2, kind=1, lut=(rng.random(11) < 0.5).astype(np.int32)),
         T(col=4, kind=0, lo=100, hi=50_000),
         T(col=5, kind=1, lut=(rng.random(3000) < 0.5).astype(np.int32))],
    ]
    # past the 32 terms the kernel stages at once: most rows pass each term
    # (AND keeps some), every width and kind
    many = []
    for i in range(40):
        c = i % len(DBS)
        k = 1 << min(DBS[c], 12)
        many.append(T(col=c, kind=0, lo=0, hi=(1 << 31) - 1) if i % 2 else
                    T(col=c, kind=1,
                      lut=(rng.random(k) < 0.97).astype(np.int32)))
    sets.append(many)
    return sets


def scan_layout_cases(rng: np.random.Generator, device):
    """Yield ``(flat, wmeta, terms)`` for the scan's word-major layout:
    each of :func:`scan_layout_term_sets` over a :func:`random_stream` of
    :data:`SCAN_LAYOUT_CAP` rows per column at each of
    :data:`SCAN_LAYOUT_GAPS`. The caller scans each under AND and OR at
    every n of :data:`SCAN_LAYOUT_NS`, all inside the stream's capacity.
    32-bit fields stay below 2**31 here, where the reference's two routes
    agree on LUT terms; ``scan_term_sets`` covers the negative codes."""
    for gaps in SCAN_LAYOUT_GAPS:
        flat, wmeta, _ = random_stream(rng, SCAN_LAYOUT_CAP, device,
                                       gaps=gaps, high=1 << 31)
        for terms in scan_layout_term_sets(rng):
            yield flat, wmeta, terms


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


# the word-major masked counts' grid (hist.cu): k per width, around the
# register counters' 2**db codes (widths 1-4), below, at and past the 8-bit
# codes, and at the per-warp sub-histograms' last k (4,096) and past it
MASKED_WORD_KS = {db: (1, (1 << db) - 1, 1 << db, (1 << db) + 3)
                  for db in (1, 2, 4)}
MASKED_WORD_KS.update({8: (4, 230, 256), 16: (3, 4096, 4097),
                       32: (5, 4096)})
# a column's first word at a multiple of 4 and not (the vector loads' path
# and the 4-byte one)
MASKED_WORD_GAPS = (0, 3)
MASKED_WORD_CAP = 4096


def pack_codes(codes: np.ndarray, db: int) -> np.ndarray:
    """uint32 words holding ``codes`` (a multiple of 32 / db of them) at
    ``db`` bits each, row r at bits (r % s) * db of word r / s."""
    s = 32 // db
    fields = codes.astype(np.uint64).reshape(-1, s)
    shifts = np.arange(s, dtype=np.uint64) * np.uint64(db)
    return np.bitwise_or.reduce(fields << shifts, axis=1).astype(np.uint32)


def masked_counts_word_cases(rng: np.random.Generator, device,
                             cap: int = MASKED_WORD_CAP, dbs=DBS):
    """Yield ``(words, off, db, mask, k, n)`` for the word-major masked
    counts: at every width, each k of :data:`MASKED_WORD_KS`, over a column
    of random codes (below 2**13 at widths 16 and 32, where some 32-bit
    fields are >= 2**31: dropped) and over one where every row has the same
    code (every lane on one bin), its first word after each of
    :data:`MASKED_WORD_GAPS` random words; masks random, all true, and
    random as a view one byte into a larger tensor (not 16-byte aligned);
    n in {1, s - 1, s + 1, cap - 1, cap} with s = 32 / db rows a word
    (n = 0 at width 32)."""
    for db in dbs:
        s = 32 // db
        hi = 1 << min(db, 13)
        columns = [rng.integers(0, hi, cap, dtype=np.int64),
                   np.full(cap, min(hi - 1, 2), np.int64)]
        if db == 32:
            columns[0][rng.permutation(cap)[:cap // 16]] = \
                rng.integers(1 << 31, 1 << 32, cap // 16)
        big = rng.random(cap + 1) < 0.5
        masks = [torch.from_numpy(rng.random(cap) < 0.5).to(device),
                 torch.ones(cap, dtype=torch.bool, device=device),
                 torch.from_numpy(big).to(device)[1:]]
        ns = sorted({1, s - 1, s + 1, cap - 1, cap})
        for codes in columns:
            for gap in MASKED_WORD_GAPS:
                words = np.concatenate([
                    rng.integers(0, 1 << 32, gap, dtype=np.uint64)
                    .astype(np.uint32), pack_codes(codes, db)])
                flat = torch.from_numpy(words.view(np.int32)).to(device)
                for k in MASKED_WORD_KS[db]:
                    for mask in masks:
                        for n in ns:
                            yield flat, gap, db, mask, k, n


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


# the wide forward's grid (onehot_wide.cu): F at one thread a row, at
# groups of 1, 2 and 32 lanes (scalar and 16-byte units), and past 32
# units; C past the F = 1 kernel's 8-column chunk and past a 32-lane code
# chunk; N around a block's rows
WIDE_FWD_FS = (1, 2, 3, 4, 8, 128, 129)
WIDE_FWD_CS = (0, 1, 2, 8, 33)
WIDE_FWD_NS = (0, 1, 33, 1024, 1025)
WIDE_FWD_KS = (1, 50, 600)
# rows wider than the 512 features (128 units) a 32-lane group holds at
# once, taken in passes: the grid for onehot_wide_forward_cases' keywords
WIDE_FWD_PASSES = dict(fs=(1024, 1030), cs=(1, 33), ks=(1, 50),
                       ns=(1, 33, 1025))


def onehot_wide_forward_cases(rng: np.random.Generator, device,
                              fs=WIDE_FWD_FS, cs=WIDE_FWD_CS, ns=WIDE_FWD_NS,
                              ks=WIDE_FWD_KS):
    """Yield ``(codes, w)`` for the wide forward over every (F, C, K) and N
    of its grid: codes mostly in [0, K), with -1, K, 2**31 - 1 and -2**31
    among them; w (C, K, F) float32 and bfloat16, each as a tensor of its
    own and as a contiguous view 4 bytes into a larger one (not aligned
    for the 16-byte and 8-byte unit loads)."""
    special = np.array([-1, 0, (1 << 31) - 1, -(1 << 31)], np.int64)
    for f in fs:
        for c in cs:
            for k in ks:
                w32 = rng.standard_normal((c, k, f), dtype=np.float32)
                weights = []
                for dtype in (torch.float32, torch.bfloat16):
                    w = torch.from_numpy(w32).to(device, dtype)
                    big = torch.empty(w.numel() + 4 // w.element_size(),
                                      dtype=dtype, device=device)
                    view = big[4 // w.element_size():].view(c, k, f)
                    view.copy_(w)
                    weights += [w, view]
                special[1] = k
                for n in ns:
                    codes = rng.integers(0, k, (c, n))
                    for ci in range(c):
                        at = rng.permutation(n)[:special.size]
                        codes[ci, at] = special[:at.size]
                    codes = torch.from_numpy(codes.astype(np.int32)).to(device)
                    for w in weights:
                        yield codes, w


# (C, N, K, F) past the scan route's rows or work, so the gradient takes
# its grouped route (onehot_wide.cu): about 200 rows per code over 196
# tiles at F 64; F = 1 at 8,192 rows, 32 tiles; and 20,000 rows over three
# codes at F 2
ONEHOT_GROUPED_SHAPES = ((2, 200_000, 1_000, 64), (2, 8_192, 50, 1),
                         (3, 20_000, 3, 2))


def onehot_wide_grouped_cases(rng: np.random.Generator, device):
    """:func:`onehot_wide_cases` at each of :data:`ONEHOT_GROUPED_SHAPES`."""
    for c, n, k, f in ONEHOT_GROUPED_SHAPES:
        yield from onehot_wide_cases(rng, device, cs=(c,), ns=(n,), ks=(k,),
                                     fs=(f,))


# int32 codes at both ends of the range, out of range of every table
_INT32_ENDS = np.array([-(1 << 31), -1, (1 << 31) - 1], np.int64)


def _codes_with_ends(rng: np.random.Generator, k: int, n: int) -> np.ndarray:
    """n int32 codes in [-3, k + 3), the int32 ends and k among them."""
    codes = rng.integers(-3, k + 3, n)
    at = rng.permutation(n)[:_INT32_ENDS.size + 1]
    codes[at] = np.append(_INT32_ENDS, k)[:at.size]
    return codes.astype(np.int32)


def bitunpack_cases(rng: np.random.Generator, device, n_words: int = 1000):
    """Yield ``(words, db, n)`` for the bit-unpack: random words (32-bit
    fields past 2**31) at every width, n = 0, n off every multiple of
    32 / db and of 4, words past the n codes, and codes past the last word
    (they read zero words)."""
    words = torch.from_numpy(rng.integers(0, 1 << 32, n_words,
                                          dtype=np.uint64).astype(np.uint32)
                             .view(np.int32)).to(device)
    for db in DBS:
        s = 32 // db
        cap = n_words * s
        for n in (0, 1, 33, cap // 2 + 1, cap, cap + 2 * s + 1):
            yield words, db, n


# the counts' k: one bin, the Table 6 column's 999, and the masked counts'
# shared-memory limits
HIST_KS = (1, 999) + SHARED_LIMIT_KS


def hist_cases(rng: np.random.Generator, device, n: int = 20_001):
    """Yield ``(codes, k)`` for the counts at each of :data:`HIST_KS`:
    codes below 0 and >= k among them (dropped), n off every multiple of 4,
    a view that is not 16-byte aligned, 2-D codes and no codes."""
    for k in HIST_KS:
        codes = torch.from_numpy(_codes_with_ends(rng, k, n)).to(device)
        yield codes, k
        yield codes[1:], k
        yield codes[:n - 1].view(100, (n - 1) // 100), k
        yield codes[:0], k


# the single-table gather's grid: every (K, F)
ADV_KS = (1, 999, 65_536, 65_537, 131_072)
ADV_FS = (1, 16, 128, 999)


def adv_gather_cases(rng: np.random.Generator, device, n: int = 2_001,
                     ks=ADV_KS, fs=ADV_FS):
    """Yield ``(table, codes)`` for the single-table gather over every
    (K, F) of the grid, float32 and bfloat16: 1-D codes with codes below 0,
    >= K and the int32 ends among them (they clamp to the table's edge
    rows), 2-D codes and no codes. The tables are made on ``device`` by a
    generator seeded from ``rng`` (the largest is 131,072 x 999)."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 31)))
    for k in ks:
        for f in fs:
            table = torch.randn((k, f), generator=gen, device=device)
            codes = torch.from_numpy(_codes_with_ends(rng, k, n)).to(device)
            for t in (table, table.to(torch.bfloat16)):
                yield t, codes
                yield t, codes[:n - 1].view(40, (n - 1) // 40)
                yield t, codes[:0]


# the single-table gather's row shapes: every F with every n, at K = 1 and
# the Table 6 column's K
ADV_SHAPE_KS = (1, 999)
ADV_SHAPE_FS = (1, 3, 16, 999)
ADV_SHAPE_NS = (1, 3, 5, 4097)


def adv_gather_shape_cases(rng: np.random.Generator, device, ks=ADV_SHAPE_KS,
                           fs=ADV_SHAPE_FS, ns=ADV_SHAPE_NS):
    """Yield ``(table, codes)`` for the single-table gather's vector and
    row paths: every (K, F) of the grid, float32 and bfloat16, with n codes
    for each n (n off every multiple of 4) and on a ``codes[1:]`` view (not
    16-byte aligned) of n + 1 codes; codes past both edges of the table and
    the int32 ends among them."""
    for k in ks:
        for f in fs:
            table = torch.from_numpy(rng.standard_normal(
                (k, f), dtype=np.float32)).to(device)
            for n in ns:
                codes = torch.from_numpy(_codes_with_ends(rng, k, n + 1)
                                         ).to(device)
                for t in (table, table.to(torch.bfloat16)):
                    yield t, codes[:n]
                    yield t, codes[1:]
