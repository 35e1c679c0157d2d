"""Wrappers for flash attention's kernels (``flash.cu``): :func:`forward`,
and :func:`backward` as a dQ launch (which also writes delta) followed by a
dK/dV launch.

Both take CUDA tensors only and raise on a head size, dtype or device the
kernels do not take; ``models/flash.py``'s ``_Flash`` calls them for a CUDA
tensor and runs the plain version (``_fwd_scan``, ``_bwd_scan``) for a CPU
one. There is no fallback. bfloat16 inputs enter the products as they are;
float32 inputs are split into three bfloat16 pieces (hi + mid + lo), which
together hold float32's significand (``flash.cu``'s note on precision).

:func:`live_tiles` is the rule that decides which key tiles a query tile
visits: plain PyTorch ops on the device, no host read, held by CPU tests
against the brute-force mask; :func:`forward` returns its bounds, which
the backward's dQ launch reuses. The tile sizes are ``flash.cu``'s alone
(:func:`tiles` asks the library). ``LAUNCHES`` counts kernel launches (only
real launches). Under ``FakeTensorMode`` (the dry-run's trace) a wrapper
makes its outputs and launches nothing: a fake tensor holds no data.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_kind, raise_on, stream_ptr

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0}
HEAD_DIMS = (16, 32, 64, 128)
# bfloat16 pieces each input value enters the products as
PIECES = {torch.bfloat16: 1, torch.float32: 3}

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
_SHAPE = [_I] * 8 + [_F, _P]          # b, s, t, t_eff, kv, g, dh, np, window
_SIGNATURES = {
    "flash_tiles": ([_I, _I, _P], _I),
    "flash_fwd": ([_P] * 3 + [_I64, _I64] + [_P] * 3 + [_I] + [_P] * 4
                  + _SHAPE, _I),
    "flash_bwd_dq": ([_P] * 4 + [_I64, _I64] + [_P] * 3 + [_I] + [_P] * 5
                     + _SHAPE, _I),
    "flash_bwd_dkdv": ([_P] * 4 + [_I64, _I64] + [_P] * 3 + [_I]
                       + [_P] * 5 + [_I] + _SHAPE, _I),
    "flash_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    return build.load("flash", _SIGNATURES)


@functools.cache
def tiles(dh: int, np_: int) -> tuple[int, int, int, int]:
    """``flash.cu``'s ``Tiles`` for a launch of head size ``dh`` and
    ``np_`` pieces: (BM, BN) query rows against keys of the forward's and
    the dQ kernel's tiles, (BQ, BKV) of the dK/dV kernel's."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    raise_on(lib.flash_tiles(dh, np_, out), lib.flash_error_string,
             "flash_tiles")
    return tuple(out)


def live_tiles(q_pos: torch.Tensor, window: float, g: int, bm: int,
               bn: int, t_eff: int) -> torch.Tensor:
    """(query tiles, 4) int32: for each tile of ``bm`` query rows (row r is
    query position ``q_pos[r // g]``, one of its ``g`` heads), the key tiles
    ``[lo, hi)`` of ``bn`` keys (below ``t_eff``) it visits, and the key
    tiles ``[full_lo, full_hi)`` every pair of which the mask keeps by
    position (the kernels add only ``kbias`` there).

    A key tile outside ``[lo, hi)`` holds no pair the mask keeps, from the
    tile's least and greatest position: keys past the greatest fail the
    causal test, keys at or before the least minus ``window`` (where
    ``window`` > 0) fail the window. So contiguous positions give the
    causal staircase, positions pinned to T every tile, a window a band.
    ``kbias`` never narrows the range; the kernels add it per key. A tile
    inside ``[full_lo, full_hi)`` has every key at or before the least
    position and, with a window, at or past the greatest minus
    ``window - 1``."""
    rows = q_pos.shape[0] * g
    n_qt, n_kt = -(-rows // bm), -(-t_eff // bn)
    idx = torch.arange(n_qt * bm, device=q_pos.device).clamp_(max=rows - 1)
    idx = idx.div_(g, rounding_mode="floor")
    qmin, qmax = torch.aminmax(q_pos[idx].view(n_qt, bm), dim=1)
    if window > 0:
        lo = torch.floor((qmin - window) / bn)
        full_lo = torch.ceil((qmax - window + 1) / bn)
    else:
        lo = full_lo = torch.zeros_like(qmin)
    bounds = torch.stack((lo, torch.floor(qmax / bn) + 1, full_lo,
                          torch.floor((qmin + 1) / bn)), dim=1)
    return bounds.clamp_(0, n_kt).to(torch.int32)


def _pieces(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` as the kernels read it, and the elements between its pieces:
    bfloat16 as it is; float32 as (3, *x.shape) bfloat16, hi, mid, lo, each
    the round-to-nearest of what the earlier ones leave."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        return x, 0
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    rest = x
    for i in range(3):
        out[i].copy_(rest)
        if i < 2:
            rest = rest - out[i].float()
    return out, x.numel()


def _fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def _check(qg, k, v, q_pos, kbias) -> torch.device:
    """Raise unless the arguments are what the kernels take; the device."""
    for name, x in (("qg", qg), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kbias", kbias)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(x).__name__}")
        if type(x) is not torch.Tensor and not _fake(x):
            # a DTensor's data_ptr is not its local shard's
            raise TypeError(f"{name} is a {type(x).__name__}: the kernels "
                            "take plain (local) tensors")
        if x.device != qg.device:
            raise ValueError(f"{name} is on {x.device}, qg on {qg.device}")
    if device_kind(qg.device) != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, got "
                         f"{qg.device}")
    if qg.dtype not in PIECES or k.dtype != qg.dtype or v.dtype != qg.dtype:
        raise TypeError(f"qg, k, v must all be bfloat16 or all float32, got "
                        f"{qg.dtype}, {k.dtype}, {v.dtype}")
    if qg.dim() != 5 or k.dim() != 4:
        raise ValueError(f"qg must be (B,S,KV,G,dh) and k, v (B,T,KV,dh), "
                         f"got {tuple(qg.shape)}, {tuple(k.shape)}")
    b, s, kvh, _, dh = qg.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} is not one of {HEAD_DIMS}")
    if v.shape != k.shape or (k.shape[0], k.shape[2], k.shape[3]) != \
            (b, kvh, dh):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match qg {tuple(qg.shape)}")
    if qg.shape[1] * qg.shape[3] >= 1 << 24:
        raise ValueError("at most 2**24 - 1 query rows (S * G) a KV head")
    if q_pos.dtype != torch.float32 or q_pos.shape != (s,) or \
            kbias.dtype != torch.float32 or kbias.shape != (k.shape[1],):
        raise ValueError("q_pos must be (S,) and kbias (T,) float32")
    return qg.device


def _shape_args(qg, k, kv_chunk: int, window: float) -> list:
    b, s, kvh, g, dh = qg.shape
    t = k.shape[1]
    return [b, s, t, t - t % kv_chunk, kvh, g, dh, PIECES[qg.dtype],
            float(window)]


def forward(qg, k, v, q_pos, kbias, window: float, kv_chunk: int):
    """-> (out in qg's dtype, out32 float32 (B,S,KV,G,dh), m, l (B,KV,G,S),
    bounds): the plain version's ``_fwd_scan`` results, ``out`` being
    ``out32`` itself for float32 inputs, and the live tiles the launch
    visited (:func:`live_tiles`; None where nothing was launched), for
    :func:`backward`."""
    dev = _check(qg, k, v, q_pos, kbias)
    b, s, kvh, g, dh = qg.shape
    shape = _shape_args(qg, k, kv_chunk, window)
    t_eff, np_ = shape[3], shape[7]
    out32 = torch.empty(qg.shape, dtype=torch.float32, device=dev)
    out = out32 if np_ == 3 else torch.empty(qg.shape, dtype=qg.dtype,
                                             device=dev)
    m = torch.empty((b, kvh, g, s), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    if out.numel() == 0:
        return out, out32, m, l, None
    (qp, q_piece), (kp, k_piece), (vp, _) = map(_pieces, (qg, k, v))
    if _fake(qg):
        return out, out32, m, l, None
    bm, bn = tiles(dh, np_)[:2]
    bounds = live_tiles(q_pos, window, g, bm, bn, t_eff)
    q_pos, kbias = q_pos.contiguous(), kbias.contiguous()
    lib = _lib()
    raise_on(lib.flash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), q_piece, k_piece,
        q_pos.data_ptr(), kbias.data_ptr(), bounds.data_ptr(),
        bounds.shape[0], out32.data_ptr(),
        None if out is out32 else out.data_ptr(), m.data_ptr(), l.data_ptr(),
        *shape, stream_ptr(dev)), lib.flash_error_string, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, out32, m, l, bounds


def backward(dout, qg, k, v, q_pos, kbias, out32, m, l, bounds,
             window: float, kv_chunk: int):
    """-> (dq, dk, dv) in the inputs' dtype, the plain version's
    ``_bwd_scan`` results, from :func:`forward`'s (out32, m, l, bounds).
    Keys at or past the last whole chunk get zeros, as there."""
    dev = _check(qg, k, v, q_pos, kbias)
    if dout.dtype != qg.dtype or dout.shape != qg.shape:
        raise ValueError(f"dout must match qg, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    b, s, kvh, g, dh = qg.shape
    shape = _shape_args(qg, k, kv_chunk, window)
    t, t_eff, np_ = shape[2], shape[3], shape[7]
    dq = torch.empty(qg.shape, dtype=qg.dtype, device=dev)
    new = torch.empty if t_eff == t else torch.zeros
    dk = new(k.shape, dtype=k.dtype, device=dev)
    dv = new(v.shape, dtype=v.dtype, device=dev)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(m)
    (qp, q_piece), (kp, k_piece), (vp, _), (dp, _) = map(
        _pieces, (qg, k, v, dout))
    if _fake(qg):
        return dq, dk, dv
    _, _, bq, bkv = tiles(dh, np_)
    bounds_kv = live_tiles(q_pos, window, g, bq, bkv, t_eff)
    q_pos, kbias = q_pos.contiguous(), kbias.contiguous()
    out32, m, l = out32.contiguous(), m.contiguous(), l.contiguous()
    lib = _lib()
    common = [qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dp.data_ptr(),
              q_piece, k_piece, q_pos.data_ptr(), kbias.data_ptr()]
    raise_on(lib.flash_bwd_dq(
        *common, bounds.data_ptr(), bounds.shape[0], out32.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *shape, stream_ptr(dev)), lib.flash_error_string, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    raise_on(lib.flash_bwd_dkdv(
        *common, bounds_kv.data_ptr(), bounds_kv.shape[0], m.data_ptr(),
        l.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        -(-t_eff // bkv), *shape, stream_ptr(dev)),
        lib.flash_error_string, "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dq, dk, dv
