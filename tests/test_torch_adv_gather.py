"""Port parity, ADV gather kernels: the plain PyTorch version of each CUDA
kernel against the reference's Pallas kernel (interpret mode), and the
wrappers' contract.

Inputs are seeded numpy arrays handed to both packages: mixed device widths
1-32 across columns, random words (so codes run past every table and, at
db = 32, past 2**31) and rows at word boundaries. Results must be
identical (``np.array_equal``): a one-hot matmul over finite tables equals
a direct gather exactly. ``test_torch_kernels_cuda.py`` holds each kernel
against its plain version on a card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.adv_gather import ops as jops
from repro_torch.kernels import edge_cases
from repro_torch.kernels.adv_gather import ops, ref

DBS = (1, 2, 4, 8, 16, 32)
CARDS = (2, 3, 11, 200, 3000, 1000)    # most below 2**db: codes clamp
DIMS = (1, 3, 2, 5, 2, 1)
CAP = 1024                              # rows every column's stream holds


def _inputs(seed, dbs=DBS, cards=CARDS, dims=DIMS):
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((k, f)).astype(np.float32)
              for k, f in zip(cards, dims)]
    words = [rng.integers(0, 1 << 32, CAP * db // 32,
                          dtype=np.uint64).astype(np.uint32) for db in dbs]
    offs = [int(o) for o in np.cumsum([0] + [w.size for w in words])[:-1]]
    flat = np.concatenate(words)
    return rng, tables, words, offs, flat


def _port(tables, offs, flat, dbs=DBS):
    return (torch.from_numpy(flat.view(np.int32)),
            ops.word_meta(offs, dbs, "cpu"), ops.fuse_tables(tables, "cpu"))


def _boundary_rows(rng, n):
    edges = [0, 1, 15, 16, 31, 32, 33, CAP - 33, CAP - 32, CAP - 1]
    return np.concatenate([edges, rng.integers(0, CAP, n)]).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_packed_rows_plain_matches_pallas(seed):
    rng, tables, _, offs, flat = _inputs(seed)
    rows = _boundary_rows(rng, 300)
    jf = jops.fuse_tables(tables)
    want = np.asarray(jops.adv_gather_packed_rows(
        jnp.asarray(flat), offs, DBS, jf.table, jf.row_offsets,
        jf.card_limits, jnp.asarray(rows), jf.out_dim, interpret=True))
    words, wmeta, fused = _port(tables, offs, flat)
    got = ops.adv_gather_packed_rows(words, wmeta, fused,
                                     torch.from_numpy(rows))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("starts,batch", [((0,), 256), ((512,), 512),
                                          ((64, 0, 768), 128)])
def test_packed_range_plain_matches_pallas(starts, batch):
    _, tables, words_np, offs, flat = _inputs(sum(starts) + batch)
    jf = jops.fuse_tables(tables)
    want = np.concatenate([np.asarray(jops.adv_gather_packed(
        [jnp.asarray(w[st * db // 32:]) for w, db in zip(words_np, DBS)],
        DBS, jf.table, jf.row_offsets, jf.card_limits, batch, jf.out_dim,
        interpret=True)) for st in starts])
    words, wmeta, fused = _port(tables, offs, flat)
    got = ops.adv_gather_packed(words, wmeta, fused,
                                torch.tensor(starts, dtype=torch.int32), batch)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_multi_plain_matches_pallas(seed):
    """Raw (C, n) codes including negatives and codes past K_c: the clamp
    keeps each column inside its own table."""
    rng, tables, *_ = _inputs(seed)
    codes = np.stack([rng.integers(-3, k + 5, 700)
                      for k in CARDS]).astype(np.int32)
    jf = jops.fuse_tables(tables)
    want = np.asarray(jops.adv_gather_fused(jf, jnp.asarray(codes),
                                            interpret=True))
    fused = ops.fuse_tables(tables, "cpu")
    got = ops.gather_fused_parts(fused, torch.from_numpy(codes))
    assert np.array_equal(got.numpy(), want)


def test_fused_tables_accounting():
    _, tables, *_ = _inputs(0)
    fused = ops.fuse_tables(tables, "cpu")
    assert fused.dims == DIMS and fused.cards == CARDS
    assert fused.out_dim == sum(DIMS) == jops.fuse_tables(tables).out_dim
    assert fused.nbytes == 4 * sum(k * f for k, f in zip(CARDS, DIMS))
    assert fused.col_of.tolist() == [c for c, f in enumerate(DIMS)
                                     for _ in range(f)]


def test_fused_tables_jmeta_addresses_every_column():
    """jmeta row j (the tiled and per-element kernels' addressing) names
    output column j's table, the flat index of its entry in table row 0,
    the table's width and its last row: entry (k, j) of the output's
    table sits at jmeta[j, 1] + k * jmeta[j, 2]."""
    _, tables, *_ = _inputs(3)
    fused = ops.fuse_tables(tables, "cpu")
    flat = fused.tables.numpy()
    assert fused.jmeta.shape == (fused.out_dim, 4)
    j = 0
    for c, t in enumerate(tables):
        for f in range(t.shape[1]):
            col, first, dim, limit = fused.jmeta[j].tolist()
            assert (col, dim, limit) == (c, t.shape[1], t.shape[0] - 1)
            assert np.array_equal(
                flat[first + np.arange(t.shape[0]) * dim], t[:, f])
            j += 1
    assert j == fused.out_dim


def test_word_index_clamps_to_stream_end():
    """Rows past every stream read the flat stream's last word instead of
    out of bounds, like the reference's clip-mode split path."""
    _, tables, _, offs, flat = _inputs(0)
    words, wmeta, fused = _port(tables, offs, flat)
    far = np.array([10 ** 9, 64 * flat.size + 7])
    got = ops.adv_gather_packed_rows(words, wmeta, fused,
                                     torch.from_numpy(far.astype(np.int32)))
    last = np.uint64(flat[-1])
    for c, (k, db) in enumerate(zip(CARDS, DBS)):
        _, _, dim, col = fused.meta[c].tolist()
        sub = (far % (32 // db)).astype(np.uint64) * np.uint64(db)
        field = (last >> sub) & np.uint64((1 << db) - 1)
        code = np.clip(field.astype(np.uint32).view(np.int32), 0, k - 1)
        assert np.array_equal(got[:, col:col + dim].numpy(), tables[c][code])


def test_cpu_wrappers_run_plain_versions_without_launches():
    ops.reset_launches()
    _, tables, _, offs, flat = _inputs(1)
    words, wmeta, fused = _port(tables, offs, flat)
    rows = torch.arange(64, dtype=torch.int32)
    ops.adv_gather_packed_rows(words, wmeta, fused, rows)
    ops.adv_gather_packed(words, wmeta, fused, rows[:1], 64)
    ops.gather_fused_parts(fused, torch.zeros((len(DBS), 8), dtype=torch.int32))
    ops.adv_gather(torch.from_numpy(tables[0]), rows)
    assert ops.LAUNCHES == {"adv_gather_packed_rows": 0,
                            "adv_gather_packed": 0, "gather_fused_parts": 0,
                            "adv_gather": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, tables, _, offs, flat = _inputs(2)
    words, wmeta, fused = _port(tables, offs, flat)
    rows = torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.adv_gather_packed_rows(words, wmeta, fused, rows.long())
    with pytest.raises(ValueError):
        ops.adv_gather_packed_rows(words, wmeta, fused, rows.reshape(2, 4))
    with pytest.raises(ValueError):
        ops.adv_gather_packed_rows(words, wmeta, fused, rows[::2])
    with pytest.raises(ValueError):
        ops.adv_gather_packed_rows(words, wmeta[:2], fused, rows)
    with pytest.raises(TypeError):
        ops.adv_gather_packed_rows(words.float(), wmeta, fused, rows)
    with pytest.raises(ValueError):
        ops.adv_gather_packed(words, wmeta, fused, rows[:1], 0)
    with pytest.raises(ValueError):
        ops.gather_fused_parts(fused, torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.word_meta([0, 1], [3, 8], "cpu")
    with pytest.raises(ValueError):
        ops.adv_gather_packed_rows(words, wmeta, fused,
                                   rows.to("meta"))


@pytest.mark.parametrize("plan", range(len(edge_cases.PACKED_ROWS_PLANS)))
def test_packed_rows_edge_sets_match_pallas(plan):
    """``edge_cases.packed_rows_cases`` (the card's edge sets for the tiled
    kernel): out_dims 1, 31, 33, 58 and 200 at 1, 7, 33 and 5,000
    rows, each plan's tables reading the random stream's columns."""
    cases = list(edge_cases.packed_rows_cases(np.random.default_rng(plan),
                                              "cpu"))
    n_ns = len(edge_cases.PACKED_ROWS_NS)
    cols = [col for col, _, _ in edge_cases.PACKED_ROWS_PLANS[plan]]
    for flat, wmeta, fused, rows in cases[plan * n_ns:(plan + 1) * n_ns]:
        offs, dbs = wmeta[:, 0].tolist(), wmeta[:, 1].tolist()
        assert dbs == [edge_cases.DBS[c] for c in cols]
        tables = [fused.tables[b:b + (lim + 1) * d].view(lim + 1, d).numpy()
                  for lim, b, d, _ in fused.meta.tolist()]
        jf = jops.fuse_tables(tables)
        want = np.asarray(jops.adv_gather_packed_rows(
            jnp.asarray(flat.numpy().view(np.uint32)), offs, dbs, jf.table,
            jf.row_offsets, jf.card_limits, jnp.asarray(rows.numpy()),
            jf.out_dim, interpret=True))
        got = ops.adv_gather_packed_rows(flat, wmeta, fused, rows)
        assert got.shape == want.shape == (rows.numel(), fused.out_dim)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("plan", range(len(edge_cases.PACKED_RANGE_PLANS)))
@pytest.mark.parametrize("batch", edge_cases.PACKED_RANGE_BATCHES)
def test_packed_range_edge_sets_match_pallas(plan, batch):
    """``edge_cases.packed_range_cases`` (the card's edge sets for the range
    gather): out_dims 1, 31, 33, 58, 200 and 60 (over 40 tables), 1, 3 and
    17 ranges of ``batch`` rows. Every range that starts on a word boundary
    and ends inside the stream equals the reference's packed range kernel
    (interpret mode, its preconditions) bit for bit; every row of the
    other ranges (unaligned, negative, past the stream's end) equals the
    reference's packed-rows kernel at that row (a negative row read as row
    0), up to the stream's end. Past it the reference leaves the words
    undefined and the port clamps
    (``test_word_index_clamps_to_stream_end``)."""
    n_b, n_k = len(edge_cases.PACKED_RANGE_BATCHES), len(
        edge_cases.PACKED_RANGE_KS)
    first = (plan * n_b + edge_cases.PACKED_RANGE_BATCHES.index(batch)) * n_k
    cases = list(edge_cases.packed_range_cases(np.random.default_rng(19),
                                               "cpu"))[first:first + n_k]
    cap = edge_cases.PACKED_RANGE_CAP
    for (flat, wmeta, fused, starts, b), k in zip(cases,
                                                   edge_cases.PACKED_RANGE_KS):
        assert b == batch and starts.numel() == k
        offs, dbs = wmeta[:, 0].tolist(), wmeta[:, 1].tolist()
        words = flat.numpy().view(np.uint32)
        tables = [fused.tables[o:o + (lim + 1) * d].view(lim + 1, d).numpy()
                  for lim, o, d, _ in fused.meta.tolist()]
        jf = jops.fuse_tables(tables)
        got = ops.adv_gather_packed(flat, wmeta, fused, starts, batch)
        assert got.shape == (k * batch, fused.out_dim)
        got = got.numpy().reshape(k, batch, -1)
        starts = starts.numpy()
        aligned = (starts >= 0) & (starts % 32 == 0) & (starts + batch <= cap)
        assert aligned.any() and (k == 1 or not aligned.all())
        for st in np.unique(starts[aligned]):
            want = np.asarray(jops.adv_gather_packed(
                [jnp.asarray(words[o + st * db // 32:])
                 for o, db in zip(offs, dbs)], dbs, jf.table,
                jf.row_offsets, jf.card_limits, batch, jf.out_dim,
                interpret=True))
            for r in np.flatnonzero(starts == st):
                assert np.array_equal(got[r], want)
        rows = np.maximum(starts[~aligned, None] + np.arange(batch), 0)
        inside = rows < cap
        if not inside.any():
            continue
        want = np.asarray(jops.adv_gather_packed_rows(
            jnp.asarray(words), offs, dbs, jf.table, jf.row_offsets,
            jf.card_limits, jnp.asarray(rows[inside].astype(np.int32)),
            jf.out_dim, interpret=True))
        assert np.array_equal(got[~aligned][inside], want)


@pytest.mark.parametrize("plan", range(len(edge_cases.MULTI_PLANS)))
@pytest.mark.parametrize("n", edge_cases.MULTI_NS)
def test_multi_edge_sets_match_pallas(plan, n):
    """``edge_cases.multi_cases`` (the card's edge sets for the tiled int32
    gather): out_dims 1, 4, 17, 31, 33, 58 and 200, C = 1 to 9, a K = 1
    table, n in ``MULTI_NS``, codes below 0, past K and the int32 ends.
    The plain version equals the reference's fused Pallas kernel
    (interpret mode) bit for bit."""
    cases = list(edge_cases.multi_cases(np.random.default_rng(13), "cpu"))
    fused, codes = cases[plan * len(edge_cases.MULTI_NS)
                         + edge_cases.MULTI_NS.index(n)]
    assert codes.shape == (len(edge_cases.MULTI_PLANS[plan]), n)
    tables = [fused.tables[b:b + (lim + 1) * d].view(lim + 1, d).numpy()
              for lim, b, d, _ in fused.meta.tolist()]
    want = np.asarray(jops.adv_gather_fused(
        jops.fuse_tables(tables), jnp.asarray(codes.numpy()),
        interpret=True))
    got = ops.gather_fused_parts(fused, codes)
    assert got.shape == want.shape == (n, fused.out_dim)
    assert np.array_equal(got.numpy(), want)
