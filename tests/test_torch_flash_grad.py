"""Port parity, the flash backward: ``repro_torch.models.flash``'s autograd
Function against the reference's custom VJP (``repro.models.flash``) on the
CPU, mirroring ``tests/test_flash.py``.

dq, dk and dv of ``sum(sin(out))`` are held to ``jax.grad`` through the
reference's ``flash_attention`` and to autograd of the port's naive
attention, for windows 0 and 9 and chunks 8, 16 and 32, in float32 and
bfloat16. Then the kbias case, the saved tensors (nothing larger than one
chunk's work), and ``blocks._bidir_attention``'s gradient past 1,024 keys
against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as jblocks
from repro.models.flash import flash_attention as jflash
from repro_torch.models import blocks
from repro_torch.models.flash import NEG_INF, flash_attention

# float32: two implementations of the same sums, values O(1); bf16: the
# output is rounded to bf16 before sin (2**-8 relative), and each gradient
# is cast to bf16 again
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
NAIVE_TOL = dict(rtol=5e-4, atol=5e-4)      # tests/test_flash.py's


def _setup(seed, b=2, s=32, t=32, kv=2, g=2, dh=8):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((b, s, kv, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    q_pos = (np.arange(s) + (t - s)).astype(np.float32)
    kbias = np.zeros((t,), np.float32)
    return qg, k, v, q_pos, kbias


def _naive(qg, k, v, q_pos, kbias, window):
    """Direct softmax attention over the whole score matrix (float32)."""
    t = k.shape[1]
    k_pos = torch.arange(t, dtype=torch.float32)
    diff = q_pos[:, None] - k_pos[None, :]
    keep = (diff >= 0) & (diff < (window if window > 0 else 1e18))
    mask = torch.where(keep, 0.0, NEG_INF) + kbias[None, :]
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


def _port_grads(fn, qg, k, v, dtype):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_()
              for x in (qg, k, v)]
    torch.sin(fn(*leaves)).float().sum().backward()
    return [x.grad for x in leaves]


def _jax_grads(qg, k, v, q_pos, kbias, window, chunk, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]

    def loss(a, b, c):
        out = jflash(a, b, c, jnp.asarray(q_pos), jnp.asarray(kbias),
                     jnp.float32(window), chunk)
        return jnp.sum(jnp.sin(out).astype(jnp.float32))

    args = [jnp.asarray(x, jdt) for x in (qg, k, v)]
    return jax.grad(loss, argnums=(0, 1, 2))(*args)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("window", [0.0, 9.0])
def test_flash_gradients_match_reference(window, chunk, dtype):
    qg, k, v, q_pos, kbias = _setup(1)
    tdt = getattr(torch, dtype)
    got = _port_grads(lambda a, b, c: flash_attention(
        a, b, c, torch.from_numpy(q_pos), torch.from_numpy(kbias), window,
        chunk), qg, k, v, tdt)
    want = _jax_grads(qg, k, v, q_pos, kbias, window, chunk, dtype)
    for a, b in zip(got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(), _np(b), **TOL[dtype])


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("window", [0.0, 9.0])
def test_flash_gradients_match_naive(window, chunk):
    qg, k, v, q_pos, kbias = _setup(1)
    qp, kb = torch.from_numpy(q_pos), torch.from_numpy(kbias)
    got = _port_grads(lambda a, b, c: flash_attention(a, b, c, qp, kb,
                                                      window, chunk),
                      qg, k, v, torch.float32)
    want = _port_grads(lambda a, b, c: _naive(a, b, c, qp, kb, window),
                       qg, k, v, torch.float32)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **NAIVE_TOL)


def test_flash_kbias_gradients():
    """kbias masks the cache tail: those keys and values get exactly zero
    gradient, the rest the reference's."""
    qg, k, v, _, _ = _setup(2, s=4, t=32)
    q_pos = np.asarray([7.0, 8.0, 9.0, 10.0], np.float32)
    kbias = np.where(np.arange(32) < 11, 0.0, -1e30).astype(np.float32)
    got = _port_grads(lambda a, b, c: flash_attention(
        a, b, c, torch.from_numpy(q_pos), torch.from_numpy(kbias), 0.0, 8),
        qg, k, v, torch.float32)
    want = _jax_grads(qg, k, v, q_pos, kbias, 0.0, 8, "float32")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL["float32"])
    assert not got[1][:, 11:].any() and not got[2][:, 11:].any()


def test_flash_saves_no_full_score_matrix():
    """The forward saves only qg, k, v, q_pos, kbias and (out, m, l): the
    largest saved tensor is O(S dh), within one chunk's S x chunk work,
    never an (S, T) score matrix (tests/test_flash.py's bound)."""
    qg, k, v, q_pos, kbias = _setup(3, b=1, s=64, t=64, kv=1, g=1, dh=4)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    leaves = [torch.from_numpy(x).requires_grad_() for x in (qg, k, v)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash_attention(*leaves, torch.from_numpy(q_pos),
                              torch.from_numpy(kbias), 0.0, 16)
    out.sum().backward()
    assert len(sizes) == 8, sizes
    assert max(sizes) <= 64 * 16, sizes            # one chunk's work
    assert all(x.grad is not None for x in leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidir_attention_gradient_past_1024_keys(dtype):
    """The audio encoder's and cross-attention's route past 1,024 keys
    (flash with every query pinned to T) against the reference's, and
    against the direct route's gradient over the same keys."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 2048, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 2048, 2, 8)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = _port_grads(blocks._bidir_attention, q, k, v, tdt)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(
        jblocks._bidir_attention(a, b, c)).astype(jnp.float32)),
        argnums=(0, 1, 2))(*[jnp.asarray(x, jdt) for x in (q, k, v)])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), _np(b), **TOL[dtype])
    if dtype == "float32":
        direct = _port_grads(lambda a, b, c: blocks._bidir_attention(
            a, b, c, kv_chunk=4096), q, k, v, tdt)
        for a, b in zip(got, direct):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **NAIVE_TOL)
