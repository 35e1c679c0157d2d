"""Port parity, the LM's primitives: ``repro_torch.models`` against
``repro.models`` on the CPU.

The same seeded numpy inputs go through attention, flash, RoPE, RMS norm
and the int8 KV quantizer of both packages. Each reference test's own
assert runs on both packages, and the port's result is held to the
reference's: float32 within rtol 2e-5 / atol 2e-5 (the reference's own
attention tolerance: matmuls and softmax sums in another order); the int8
codes and scales bit for bit (one division, one max and round half to
even, the same in IEEE float32 everywhere). The flash backward comes with
the training slice, so ``test_flash.py``'s gradient cases are not here.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models import blocks as jblocks
from repro.models import flash as jflash
from repro.models import layers as jL
from repro_torch.models import attention as att
from repro_torch.models import blocks
from repro_torch.models import flash
from repro_torch.models import layers as L

TOL = dict(rtol=2e-5, atol=2e-5)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


# -- attention (tests/test_model_core.py:23-63) ----------------------------------
def _qkv(rng, b, s, h, kv, dh, t=None):
    t = t or s
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    return q, k, v


def _attend(q, k, v, **kw):
    """(port, reference) outputs of ``attention`` on the same inputs."""
    jq, tq = _both(q)
    jk, tk = _both(k)
    jv, tv = _both(v)
    return att.attention(tq, tk, tv, **kw), jatt.attention(jq, jk, jv, **kw)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
def test_blockwise_attention_matches_direct(h, kv):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 64, h, kv, 16)
    direct, jdirect = _attend(q, k, v, q_offset=0, kv_chunk=64)
    blocked, jblocked = _attend(q, k, v, q_offset=0, kv_chunk=16)
    _close(direct, blocked.numpy())
    _close(direct, jdirect)
    _close(blocked, jblocked)


def test_blockwise_sliding_window_matches_direct():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 64, 4, 2, 8)
    direct, jdirect = _attend(q, k, v, q_offset=0, window=7, kv_chunk=64)
    blocked, jblocked = _attend(q, k, v, q_offset=0, window=7, kv_chunk=8)
    _close(direct, blocked.numpy())
    _close(direct, jdirect)
    _close(blocked, jblocked)


def test_attention_causality():
    """Changing future keys must not change past outputs."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 32, 4, 4, 8)
    out1, jout1 = _attend(q, k, v, q_offset=0)
    k2, v2 = k.copy(), v.copy()
    k2[:, 20:] = rng.standard_normal((1, 12, 4, 8))
    v2[:, 20:] = rng.standard_normal((1, 12, 4, 8))
    out2, _ = _attend(q, k2, v2, q_offset=0)
    np.testing.assert_allclose(out1[:, :20].numpy(), out2[:, :20].numpy(),
                               rtol=1e-5, atol=1e-5)
    _close(out1, jout1)


def test_attention_kv_len_mask():
    """Decode: entries beyond kv_len are invisible."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 1, 4, 2, 8, t=32)
    out1, jout1 = _attend(q, k, v, q_offset=10, kv_len=11)
    k2, v2 = k.copy(), v.copy()
    k2[:, 11:] = 999.0
    v2[:, 11:] = 999.0
    out2, _ = _attend(q, k2, v2, q_offset=10, kv_len=11)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)
    _close(out1, jout1)


@pytest.mark.parametrize("case", ["window", "kv_len", "window_kv_len"])
def test_flash_path_equals_direct_path(case):
    """Port only: the flash path (t > kv_chunk) gives the direct path's
    answer, with a window, with keys past kv_len, and with both. kv_len is
    pos + S, as a cache gives it: every query sees its own key."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 16, 4, 2, 8, t=64)
    kw = {"window": dict(window=5), "kv_len": dict(kv_len=46),
          "window_kv_len": dict(window=9, kv_len=46)}[case]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    direct = att.attention(tq, tk, tv, q_offset=30, kv_chunk=64, **kw)
    flashed = att.attention(tq, tk, tv, q_offset=30, kv_chunk=16, **kw)
    _close(flashed, direct.numpy())


# -- flash forward (tests/test_flash.py:34-43, 65-75) --------------------------------
def _naive(qg, k, v, q_pos, kbias, window):
    """``tests/test_flash.py``'s naive reference, in torch."""
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    k_pos = torch.arange(k.shape[1], dtype=torch.float32)
    keep = q_pos[:, None] >= k_pos[None, :]
    keep &= (q_pos[:, None] - k_pos[None, :]) < (window if window > 0
                                                 else 1e18)
    mask = torch.where(keep, 0.0, -1e30) + kbias[None, :]
    probs = torch.softmax(scores + mask, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _setup(seed, b=2, s=32, t=32, kv=2, g=2, dh=8):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((b, s, kv, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, dh)).astype(np.float32)
    q_pos = np.arange(s, dtype=np.float32) + (t - s)
    kbias = np.zeros((t,), np.float32)
    return qg, k, v, q_pos, kbias


@pytest.mark.parametrize("window", [0.0, 9.0])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_flash_forward_matches_naive(window, chunk):
    arrays = _setup(0)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    got = flash.flash_attention(*t, window, chunk)
    _close(got, _naive(*t, window).numpy())
    _close(got, jflash.flash_attention(*j, jnp.float32(window), chunk))


def test_flash_decode_kbias():
    """kbias masks invalid cache tail exactly like a shorter cache."""
    qg, k, v, _, _ = _setup(2, s=1, t=32)
    q_pos = np.asarray([10.0], np.float32)
    kbias = np.where(np.arange(32) < 11, 0.0, -1e30).astype(np.float32)
    k2, v2 = k.copy(), v.copy()
    k2[:, 11:] = 777.0
    v2[:, 11:] = 777.0
    t = [torch.from_numpy(a) for a in (qg, k, v, q_pos, kbias)]
    out = flash.flash_attention(*t, 0.0, 8)
    out2 = flash.flash_attention(t[0], torch.from_numpy(k2),
                                 torch.from_numpy(v2), *t[3:], 0.0, 8)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-6)
    jout = jflash.flash_attention(*[jnp.asarray(a) for a in
                                    (qg, k, v, q_pos, kbias)],
                                  jnp.float32(0), 8)
    _close(out, jout)


# -- layers (tests/test_model_core.py:175-198) -----------------------------------------
def test_rope_preserves_norm_and_relativity():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    pos = np.arange(6)[None]
    y = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(np.linalg.norm(y.numpy(), axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)
    _close(y, jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    # relative property: <rope(q,m), rope(k,n)> depends only on m-n
    q = torch.from_numpy(rng.standard_normal((1, 1, 1, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 1, 8)).astype(np.float32))

    def dot(m, n):
        qm = L.apply_rope(q, torch.tensor([[m]]), 1e4)
        kn = L.apply_rope(k, torch.tensor([[n]]), 1e4)
        return float(torch.sum(qm * kn))
    assert abs(dot(3, 1) - dot(7, 5)) < 1e-4


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_rope_matches_reference_at_serving_positions(theta):
    """Every arch's theta, positions to 2,048 (a flash prefill's cache)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2048, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(2048), (2, 2048))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                       theta)
    _close(got, jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-4, atol=1e-4)


def test_rms_norm_unit_scale():
    x = (np.random.default_rng(0).standard_normal((4, 16)) * 10).astype(
        np.float32)
    y = L.rms_norm(torch.from_numpy(x), torch.ones(16))
    rms = np.sqrt(np.mean(np.square(y.numpy()), axis=-1))
    np.testing.assert_allclose(rms, 1.0, rtol=1e-3)
    _close(y, jL.rms_norm(jnp.asarray(x), jnp.ones(16)))


def test_rms_norm_bfloat16_computes_in_float32():
    """A bf16 input is normed in float32 and rounded once, as the
    reference does: within one bf16 rounding of the reference's (a float32
    sum in another order may cross a rounding boundary)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    got = L.rms_norm(torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(s).bfloat16())
    want = jL.rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(s, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


# -- bfloat16 inputs: the float32 islands of the bf16 path -----------------------------
def _bf16_both(a):
    """The same bf16 values as (JAX array, torch tensor)."""
    a = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.view(np.int16)).view(
        torch.bfloat16)


def _within_one_bf16_ulp(port, ref, share=1e-3):
    """bf16 outputs equal but for at most ``share`` of the elements, each
    off by one bf16 ulp of the reference's (a float32 sum in another order
    may cross a rounding boundary). A float32 island computed in bf16
    instead (scores, softmax, RoPE, the norm) moves a third or more of the
    elements, by up to ten ulps."""
    assert port.dtype == torch.bfloat16
    got = port.float().numpy()
    want = np.asarray(ref.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    off = got != want
    assert off.mean() <= share, off.mean()
    assert (np.abs(got - want)[off] <= ulp[off]).all()


@pytest.mark.parametrize("case", ["prefill", "decode", "flash",
                                  "flash_window"])
def test_attention_bfloat16_matches_reference(case):
    """bf16 q, k, v: float32 scores from upcast q and k, a float32
    softmax, probabilities cast to bf16 before P.V, on both paths."""
    s, t, chunk, kw = {
        "prefill": (16, 64, 1024, dict(q_offset=48, kv_len=64)),
        "decode": (1, 64, 1024, dict(q_offset=40, kv_len=41)),
        "flash": (64, 64, 16, dict(q_offset=0)),
        "flash_window": (64, 64, 16, dict(q_offset=0, window=9))}[case]
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _bf16_both(rng.standard_normal(shape) * sd) for shape, sd in
        (((2, s, 4, 64), 2.0), ((2, t, 2, 64), 2.0), ((2, t, 2, 64), 1.0)))
    got = att.attention(tq, tk, tv, kv_chunk=chunk, **kw)
    _within_one_bf16_ulp(got, jatt.attention(jq, jk, jv, kv_chunk=chunk,
                                             **kw))


def test_rope_and_rms_norm_bfloat16_match_reference():
    """bf16 inputs rotated and normed in float32, rounded once."""
    rng = np.random.default_rng(8)
    jx, tx = _bf16_both(rng.standard_normal((2, 8, 4, 64)) * 3)
    pos = np.arange(8)[None] + 500
    _within_one_bf16_ulp(L.apply_rope(tx, torch.from_numpy(pos), 1e4),
                         jL.apply_rope(jx, jnp.asarray(pos), 1e4))
    jh, th = _bf16_both(rng.standard_normal((2, 8, 64)) * 3)
    js, ts = _bf16_both(rng.standard_normal(64))
    _within_one_bf16_ulp(L.rms_norm(th, ts), jL.rms_norm(jh, js))


# -- the per-forward tables (blocks.StepContext) ----------------------------------------
def test_step_context_tables_equal_per_layer_ones():
    """Port only: the RoPE tables and masks built once a forward give, bit
    for bit, what each layer would build itself: the halves formula
    x1*cos - x2*sin, and attention's own mask. The flash path gets no
    mask (it masks chunk by chunk)."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("glm4-9b"))
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(
        (2, 5, 4, cfg.head_dim)).astype(np.float32))
    ctx = blocks.StepContext(cfg, 5, 24, 11, 16, "cpu")
    angles = (11 + torch.arange(5.0))[None, :, None, None] * \
        L.rope_freqs(cfg.head_dim, cfg.rope_theta)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    halves = torch.cat([x1 * torch.cos(angles) - x2 * torch.sin(angles),
                        x2 * torch.cos(angles) + x1 * torch.sin(angles)], -1)
    assert torch.equal(L.rotate(x, ctx.cos, ctx.sin), halves)
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, cfg.head_dim))
                         .astype(np.float32))
    for window in (0, 3):
        assert ctx.mask(window) is ctx.mask(window)
        assert torch.equal(
            att.attention(x, k, k, q_offset=11, window=window, kv_len=16,
                          mask=ctx.mask(window)),
            att.attention(x, k, k, q_offset=11, window=window, kv_len=16))
    assert blocks.StepContext(cfg, 2048, 2048, 0, None, "cpu").mask(0) \
        is None


# -- int8 KV cache quantizer (tests/test_kv_int8.py:14) ----------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_kv_quantize_codes_and_scales_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((2, 8, 4, 16)) * 3).astype(np.float32)
    k[0, 0, 0] = 0.0                     # an all-zero head: scale 0
    k[1, 2, 3, :4] = [1.5, -0.5, 2.5, 127.0]
    q, s = blocks._kv_quantize(torch.from_numpy(k))
    jq, js = jblocks._kv_quantize(jnp.asarray(k))
    assert q.dtype == torch.int8 and s.shape == (2, 8, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    back = blocks._kv_dequantize(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jblocks._kv_dequantize(jq, js, jnp.float32)))
    err = np.abs(k - back.numpy())
    assert (err <= s.numpy()[..., None] * 0.51 + 1e-6).all()
