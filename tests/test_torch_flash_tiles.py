"""The flash kernels' live-tile rule and their wrapper, on the CPU.

``kernels/flash/ops.live_tiles`` decides which key tiles each query tile
visits; a skipped tile must hold no (query, key) pair that the plain
version's ``_mask`` keeps. Held here by brute force over contiguous, offset,
pinned and random positions, windows, ``kbias`` tails and the tile sizes
the kernels use. Also: the CPU runs the plain
version (no launch), the wrapper refuses CPU tensors and tensor
subclasses, and float32's three bfloat16 pieces hold its values.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash import ops
from repro_torch.models.flash import (NEG_INF, _bwd_scan, _fwd_scan, _mask,
                                      flash_attention)

# (query rows, keys) a tile: those of flash.cu's launches (64 x 64, 64 x
# 32, 32 x 64) and wider ones, the rule being the same for any
TILES = [(32, 64), (64, 32), (64, 64), (128, 128)]


def _tile_pairs(q_pos, window, kbias, g, bm, bn, t_eff, every=False):
    """(query tiles, key tiles) bool: a pair in the tile that ``_mask``
    keeps (``every``: every pair of valid rows and keys kept)."""
    keep = _mask(q_pos, torch.arange(t_eff, dtype=torch.float32), window,
                 kbias[:t_eff]) > NEG_INF / 2                  # (S, T)
    rows = keep.repeat_interleave(g, dim=0)                    # (S * g, T)
    n_qt, n_kt = -(-rows.shape[0] // bm), -(-t_eff // bn)
    rows = torch.nn.functional.pad(rows, (0, n_kt * bn - t_eff,
                                          0, n_qt * bm - rows.shape[0]),
                                   value=every)
    tiles = rows.view(n_qt, bm, n_kt, bn)
    if every:
        return tiles.all(dim=3).all(dim=1)
    return tiles.any(dim=3).any(dim=1)


def _positions(kind: str, s: int, t: int, rng) -> torch.Tensor:
    if kind == "contiguous":                 # train, a prefill from 0
        pos = np.arange(s)
    elif kind == "offset":                   # a chunk of a longer prefill
        pos = np.arange(s) + int(rng.integers(0, t - s + 1))
    elif kind == "pinned":                   # _bidir_attention: all at T
        pos = np.full(s, t)
    elif kind == "sparse":                   # any order, some below 0
        pos = rng.integers(-40, t + 40, s)
    else:                                    # repeated positions
        pos = np.sort(rng.integers(0, t, s))
    return torch.from_numpy(pos.astype(np.float32))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", ["contiguous", "offset", "pinned", "sparse",
                                  "repeated"])
def test_live_tiles_never_skip_a_kept_pair(kind, tile):
    bm, bn = tile
    rng = np.random.default_rng([bm, bn, len(kind)])
    for _ in range(6):
        s, t = int(rng.integers(1, 300)), int(rng.integers(1, 400))
        s = min(s, t) if kind in ("contiguous", "offset") else s
        g = int(rng.choice([1, 2, 3, 16]))
        chunk = int(rng.choice([1, 8, 64]))
        t_eff = t - t % chunk
        window = float(rng.choice([0.0, 1.0, 9.0, 64.0, 1024.0]))
        q_pos = _positions(kind, s, t, rng)
        kbias = torch.from_numpy(np.where(
            rng.random(t) < 0.8, 0.0, NEG_INF).astype(np.float32))
        bounds = ops.live_tiles(q_pos, window, g, bm, bn, t_eff)
        kept = _tile_pairs(q_pos, window, kbias, g, bm, bn, t_eff)
        assert bounds.dtype == torch.int32 and bounds.shape == \
            (kept.shape[0], 4)
        idx = torch.arange(kept.shape[1])
        inside = (idx >= bounds[:, :1]) & (idx < bounds[:, 1:2])
        assert not (kept & ~inside).any(), (s, t, g, window)
        # where the kernels skip the positional mask, it keeps every pair
        full = (idx >= bounds[:, 2:3]) & (idx < bounds[:, 3:])
        every = _tile_pairs(q_pos, window, torch.zeros(t), g, bm, bn, t_eff,
                            every=True)
        assert not (full & ~every).any(), (s, t, g, window)


@pytest.mark.parametrize("window", [0.0, 1024.0])
def test_live_tiles_skip_the_causal_staircase(window):
    """At the train cell's shape (S = T = 2,048, 64-row tiles, 64 keys) the
    range of each tile is the kept tiles' exactly: the causal staircase,
    and the window's band to within one tile."""
    q_pos = torch.arange(2048, dtype=torch.float32)
    kbias = torch.zeros(2048)
    bounds = ops.live_tiles(q_pos, window, 1, 64, 64, 2048)
    kept = _tile_pairs(q_pos, window, kbias, 1, 64, 64, 2048)
    first = kept.float().argmax(dim=1)
    last = 32 - kept.flip(1).float().argmax(dim=1)
    assert torch.equal(bounds[:, 1], last.int())
    assert ((first - bounds[:, 0]) <= 1).all() and \
        (bounds[:, 0] <= first).all()
    share = float((bounds[:, 1] - bounds[:, 0]).sum()) / 32 ** 2
    assert share == (528 if window == 0 else 408) / 1024
    # all but the diagonal tile (and the window's far edge) skip the mask
    full = (bounds[:, 3] - bounds[:, 2]).clamp(min=0)
    assert int(full.sum()) == (496 if window == 0 else 496 - 120 - 16)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU ``flash_attention`` launches nothing and equals the
    plain scans bit for bit, forward and backward."""
    rng = np.random.default_rng(0)
    qg, dout = (torch.from_numpy(rng.standard_normal((2, 48, 2, 2, 16))
                                 .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    q_pos = torch.arange(16, 64, dtype=torch.float32)
    kbias = torch.zeros(64)
    ops.reset_launches()
    leaves = [x.clone().requires_grad_() for x in (qg, k, v)]
    out = flash_attention(*leaves, q_pos, kbias, 9.0, 16)
    grads = torch.autograd.grad(out, leaves, dout)
    assert ops.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkdv": 0}
    out32, m, l = _fwd_scan(qg, k, v, q_pos, kbias, 9.0, 16)
    assert torch.equal(out.detach(), out32)
    for a, b in zip(grads, _bwd_scan(dout, qg, k, v, q_pos, kbias, out32, m,
                                     l, 9.0, 16)):
        assert torch.equal(a, b)


def test_wrapper_refuses_cpu_tensors_and_subclasses():
    """The kernels' wrapper has no CPU route and takes plain tensors only
    (a DTensor's ``data_ptr`` is not its shard's)."""
    class Sub(torch.Tensor):
        pass

    qg = torch.zeros((1, 4, 1, 1, 16))
    k = torch.zeros((1, 4, 1, 16))
    args = [qg, k, k, torch.arange(4.0), torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.forward(*args, 0.0, 4)
    with pytest.raises(TypeError, match="plain"):
        ops.forward(qg.as_subclass(Sub), *args[1:], 0.0, 4)


def test_float32_pieces_hold_its_values():
    """hi + mid + lo, each bfloat16, add up to the float32 value within
    float32's own rounding (2**-24 relative)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32) * 10.0 ** np.arange(-8, 8)
                         .repeat(256).astype(np.float32))
    pieces, stride = ops._pieces(x)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, 4096)
    assert stride == 4096
    total = pieces.double().sum(dim=0)
    assert float(((total - x.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -24
    same, none = ops._pieces(x.bfloat16())
    assert none == 0 and torch.equal(same, x.bfloat16())
