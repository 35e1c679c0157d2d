"""Port parity, the GLA core: ``repro_torch.models.gla`` against
``repro.models.gla`` on the CPU.

``tests/test_model_core.py``'s three GLA tests run on both packages, then
``chunked_gla`` (with and without the normalizer) and ``gla_step`` take the
same seeded numpy inputs in both: float32 within rtol/atol 1e-5, bfloat16
within ``BF16_TOL`` of the output's standard deviation (float32 products
summed in another order; a bf16 output rounds to one ulp either side).
The GLA chunk the blocks pick for a sequence is the reference's.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import blocks as jblocks
from repro.models import gla as jgla
from repro_torch.models import blocks, gla

TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16: within 2**-6 of the output's std (a bf16 value near its std
# rounds at 2**-8 of it; the port and XLA sum the float32 products in
# another order, so an output can round one ulp the other way)
BF16_TOL = 2.0 ** -6


def _inputs(rng, b, s, h, dk, dv, k_scale=0.3, decay=0.2):
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32) * k_scale
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    log_a = (-np.abs(rng.standard_normal((b, s, h))) * decay).astype(
        np.float32)
    return q, k, v, log_a


def _cast(a: np.ndarray, dtype: str):
    """One numpy array -> (JAX array, tensor) of the same values in
    ``dtype`` (bfloat16 rounded once, by ml_dtypes, for both)."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(
            a.view(np.int16).copy()).view(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(port, ref, dtype):
    port, ref = _np(port), _np(ref)
    assert np.isfinite(port).all()
    if dtype == "bfloat16":
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=BF16_TOL * float(ref.std()))
    else:
        np.testing.assert_allclose(port, ref, **TOL)


# -- tests/test_model_core.py:66-115 on both packages ------------------------------
@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 48), (33, 3)])
def test_chunked_gla_matches_sequential(s, chunk):
    rng = np.random.default_rng(s)
    q, k, v, log_a = map(torch.from_numpy, _inputs(rng, 2, s, 3, 8, 5))
    out_c, st_c = gla.chunked_gla(q, k, v, log_a, chunk=chunk)
    out_r, st_r = gla.gla_ref(q, k, v, log_a)
    np.testing.assert_allclose(out_c.numpy(), out_r.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st_c.numpy(), st_r.numpy(), rtol=1e-4,
                               atol=1e-4)
    j_out, j_st = jgla.chunked_gla(*(jnp.asarray(t.numpy())
                                     for t in (q, k, v, log_a)), chunk=chunk)
    _close(out_c, j_out, "float32")
    _close(st_c, j_st, "float32")
    j_ref_out, _ = jgla.gla_ref(*(jnp.asarray(t.numpy())
                                  for t in (q, k, v, log_a)))
    _close(out_r, j_ref_out, "float32")


@given(st.integers(0, 10_000), st.integers(1, 6))
@settings(max_examples=15, deadline=None)
def test_gla_step_composition_property(seed, steps):
    """N single steps == one chunked pass over N tokens, on the port; each
    step's output against JAX's."""
    rng = np.random.default_rng(seed)
    s = steps * 2
    arrays = _inputs(rng, 1, s, 2, 4, 3, decay=0.3)
    q, k, v, log_a = map(torch.from_numpy, arrays)
    jq, jk, jv, jla = map(jnp.asarray, arrays)
    out_c, st_c = gla.chunked_gla(q, k, v, log_a, chunk=s)
    state = torch.zeros((1, 2, 4, 3))
    jstate = jnp.zeros((1, 2, 4, 3), jnp.float32)
    for t in range(s):
        state, o = gla.gla_step(state, q[:, t], k[:, t], v[:, t],
                                log_a[:, t])
        jstate, jo = jgla.gla_step(jstate, jq[:, t], jk[:, t], jv[:, t],
                                   jla[:, t])
        np.testing.assert_allclose(o.numpy(), out_c[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)
        _close(o, jo, "float32")
    np.testing.assert_allclose(state.numpy(), st_c.numpy(), rtol=2e-4,
                               atol=2e-4)
    _close(state, jstate, "float32")


def test_gla_decay_zero_is_cumulative_sum():
    """a = 1 (log_a = 0): the state is a plain sum of k v^T."""
    rng = np.random.default_rng(0)
    b, s, h, dk, dv = 1, 8, 1, 3, 2
    q = torch.from_numpy(np.eye(3, dtype=np.float32)[None, [0] * s, None, :])
    k = torch.from_numpy(rng.standard_normal((b, s, h, dk)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv)).astype(np.float32))
    log_a = torch.zeros((b, s, h))
    out, st_ = gla.chunked_gla(q, k, v, log_a, chunk=4)
    want = np.einsum("bshk,bshv->bhkv", k.numpy(), v.numpy())
    np.testing.assert_allclose(st_.numpy(), want, rtol=1e-5, atol=1e-5)
    _, j_st = jgla.chunked_gla(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), jnp.zeros((b, s, h)),
                               chunk=4)
    _close(st_, j_st, "float32")


# -- the port against JAX, float32 and bfloat16 ------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalizer", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 40)])
def test_chunked_gla_matches_reference(dtype, normalizer, s, chunk):
    """mLSTM's shapes (a normalizer, dk != dv) and Hymba's (none): every
    output, the bf16 one in q's dtype and the states in float32."""
    rng = np.random.default_rng(s + normalizer)
    arrays = _inputs(rng, 2, s, 3, 8, 16, decay=0.5)
    pairs = [_cast(a, dtype) for a in arrays[:3]] + \
        [_cast(arrays[3], "float32")]
    outs = gla.chunked_gla(*(t for _, t in pairs), chunk=chunk,
                           normalizer=normalizer)
    j_outs = jgla.chunked_gla(*(j for j, _ in pairs), chunk=chunk,
                              normalizer=normalizer)
    assert len(outs) == len(j_outs) == (4 if normalizer else 2)
    assert outs[0].dtype == pairs[0][1].dtype
    assert all(t.dtype == torch.float32 for t in outs[1:])
    for got, want in zip(outs, j_outs):
        assert tuple(got.shape) == want.shape
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalizer", [False, True])
def test_gla_step_matches_reference(dtype, normalizer):
    """One decode step on a live float32 state (and normalizer)."""
    rng = np.random.default_rng(7 + normalizer)
    b, h, dk, dv = 2, 3, 8, 16
    q, k, v, log_a = (a[:, 0] for a in _inputs(rng, b, 1, h, dk, dv))
    state = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    nstate = rng.standard_normal((b, h, dk)).astype(np.float32)
    pairs = [_cast(a, dtype) for a in (q, k, v)] + \
        [_cast(a, "float32") for a in (log_a, state, nstate)]
    (jq, q_), (jk, k_), (jv, v_), (jla, la_), (js, s_), (jn, n_) = pairs
    outs = gla.gla_step(s_, q_, k_, v_, la_,
                        nstate=n_ if normalizer else None)
    j_outs = jgla.gla_step(js, jq, jk, jv, jla,
                           nstate=jn if normalizer else None)
    assert len(outs) == len(j_outs) == (4 if normalizer else 2)
    assert outs[1].dtype == q_.dtype
    for got, want in zip(outs, j_outs):
        _close(got, want, dtype)


@pytest.mark.parametrize("s,want", [(6, 6), (160, 160), (1040, 16),
                                    (2048, 256)])
def test_pick_chunk_is_the_reference_s(s, want):
    """s itself up to 256, 256 where it divides s, else gcd(s, 256)."""
    assert blocks._pick_chunk(s) == jblocks._pick_chunk(s) == want
