"""Port parity, the audio encoder-decoder: ``repro_torch.models`` against
``repro.models`` on the CPU, block by block and for the whole model.

The reference's parameters for reduced seamless-m4t-large-v2 (``init_params``
from ``PRNGKey(0)``) are carried into the port with
``params_from_reference``, and the same seeded numpy inputs go through both
packages. Tolerances:

- ``_bidir_attention`` alone: ``test_torch_lm_core.py``'s attention
  tolerance (rtol 2e-5 / atol 2e-5 in float32; bf16 outputs equal but for
  at most 0.1% of the elements, each one bf16 ulp off);
- blocks and logits in float32: ``test_torch_lm.py``'s TOL (rtol 1e-4 /
  atol 1e-5), greedy argmax equal;
- bf16 logits: within 2**-4 of the reference logits' std
  (``test_torch_lm._close_bf16``).

The reference chooses ``_bidir_attention``'s route by T alone: flash when T
is past ``kv_chunk`` and a multiple of it, direct otherwise (T = 1,500
too), so the encoder over 2,048 frames and cross-attention over them take
the flash route, in decode as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.configs import get_config, reduced
from repro_torch.models import blocks, lm
from test_torch_lm import TOL, _close, _close_bf16, _j, _t
from test_torch_lm_core import TOL as ATT_TOL
from test_torch_lm_core import _bf16_both, _within_one_bf16_ulp

ARCH = "seamless-m4t-large-v2"
B, S = 2, 8


def _carry(jparams):
    return lm.params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def audio_state():
    """dtype -> (jcfg, cfg, jparams, params), reduced seamless."""
    cache = {}

    def get(dtype="float32"):
        if dtype not in cache:
            jcfg = dataclasses.replace(jreduced(jget_config(ARCH)),
                                       dtype=dtype)
            cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype)
            jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            cache[dtype] = (jcfg, cfg, jparams, _carry(jparams))
        return cache[dtype]
    return get


def _group(tree, g=0):
    """One group's slice of a stacked parameter tree (either package)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


# -- _bidir_attention ------------------------------------------------------------------
def _qkv(rng, t, s=16, h=4, kv=2, dh=64):
    return [rng.standard_normal(shape) * sd for shape, sd in (
        ((B, s, h, dh), 2.0), ((B, t, kv, dh), 2.0), ((B, t, kv, dh), 1.0))]


@pytest.mark.parametrize("t", [0, 16, 24, 1500, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidir_attention_matches_reference(t, dtype):
    """T = 0 (an empty memory: zeros), 16 and 24 (direct), 1,500 (direct
    past 1,024: not a multiple of the chunk) and 2 x kv_chunk (flash)."""
    q, k, v = _qkv(np.random.default_rng(t), t)
    if dtype == "float32":
        (jq, tq), (jk, tk), (jv, tv) = (
            (jnp.asarray(a, jnp.float32), torch.from_numpy(
                a.astype(np.float32))) for a in (q, k, v))
    else:
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_both(a) for a in (q, k, v))
    got = blocks._bidir_attention(tq, tk, tv)
    want = jblocks._bidir_attention(jq, jk, jv)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    if t == 0:
        assert not got.any() and not np.asarray(want).any()
    elif dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    else:
        _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("s,t,flash", [(16, 16, False), (16, 24, False),
                                       (16, 1500, False), (4, 2048, True),
                                       (1, 2048, True), (1, 1024, False),
                                       (1, 0, False)])
def test_bidir_attention_route_is_the_references(s, t, flash, monkeypatch):
    """Flash exactly when T > kv_chunk and T % kv_chunk == 0, whatever S
    is (decode over 2,048 frames too): not ``attention.is_direct``'s rule."""
    calls = []
    real = blocks.flash_attention

    def spy(*args):
        calls.append(args[1].shape[1])
        return real(*args)

    monkeypatch.setattr(blocks, "flash_attention", spy)
    q, k, v = (torch.from_numpy(a.astype(np.float32))
               for a in _qkv(np.random.default_rng(1), t, s=s, dh=16))
    blocks._bidir_attention(q, k, v)
    assert calls == ([t] if flash else [])


# -- _attn_apply: cross-attention and the bidirectional switch -------------------------
def _ctx(cfg, s, t, pos, cached):
    return blocks.StepContext(cfg, s, t, pos, pos + s if cached else None,
                              "cpu")


@pytest.mark.parametrize("enc_len", [0, 8, 2048])
def test_attn_apply_cross_attention_matches_reference(enc_len, audio_state):
    """K and V from the memory, unrotated, no cache written (the one given
    stays as it was), every key attended: against the reference's
    ``_attn_apply(..., causal=False, rope=False, kv_src=memory)``."""
    jcfg, cfg, jparams, params = audio_state()
    jp, p = _group(jparams["blocks"][0]["xattn"]), \
        _group(params["blocks"][0]["xattn"])
    rng = np.random.default_rng(enc_len)
    x = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, enc_len, cfg.d_model)).astype(np.float32)
    cache = {"k": torch.zeros((B, 16, cfg.n_kv, cfg.head_dim)),
             "v": torch.zeros((B, 16, cfg.n_kv, cfg.head_dim))}
    got, kept = blocks._attn_apply(
        cfg, p, torch.from_numpy(x), cache=cache, pos=5, window=0,
        ctx=_ctx(cfg, 3, 16, 5, True), causal=False, rope=False,
        kv_src=torch.from_numpy(mem))
    want, _ = jblocks._attn_apply(jcfg, jp, jnp.asarray(x), cache=None,
                                  pos=5, window=0, causal=False, rope=False,
                                  kv_src=jnp.asarray(mem))
    assert kept is cache and not cache["k"].any() and not cache["v"].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if enc_len == 0:
        assert not got.any()


def test_attn_apply_bidirectional_self_attention(audio_state):
    """The encoder's attention: RoPE from ``pos`` on Q and K, every key
    attended (the causal mask of ``ctx`` is never built)."""
    jcfg, cfg, jparams, params = audio_state()
    jp, p = _group(jparams["enc_blocks"]["attn"]), \
        _group(params["enc_blocks"]["attn"])
    x = np.random.default_rng(2).standard_normal(
        (B, 12, cfg.d_model)).astype(np.float32)
    ctx = _ctx(cfg, 12, 12, 0, False)
    got, _ = blocks._attn_apply(cfg, p, torch.from_numpy(x), cache=None,
                                pos=0, window=0, ctx=ctx, causal=False)
    want, _ = jblocks._attn_apply(jcfg, jp, jnp.asarray(x), cache=None,
                                  pos=0, window=0, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ctx._masks == {}
    causal, _ = blocks._attn_apply(cfg, p, torch.from_numpy(x), cache=None,
                                   pos=0, window=0, ctx=ctx)
    assert not torch.allclose(causal[:, :-1], got[:, :-1])


# -- the block kinds ---------------------------------------------------------------------
@pytest.mark.parametrize("frames", [12, 2048])
def test_apply_enc_matches_reference(frames, audio_state):
    jcfg, cfg, jparams, params = audio_state()
    x = np.random.default_rng(frames).standard_normal(
        (B, frames, cfg.d_model)).astype(np.float32)
    got, cache, aux = blocks.apply_enc(
        cfg, _group(params["enc_blocks"], 1), {}, torch.from_numpy(x),
        ctx=_ctx(cfg, frames, frames, 0, False))
    want, jcache, _ = jblocks.apply_enc(
        jcfg, _group(jparams["enc_blocks"], 1), {}, jnp.asarray(x))
    assert cache is None and jcache is None and aux == (0.0, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_xdec_matches_reference(audio_state):
    """A prefill of 5 positions, then a decode step at position 5, over a
    memory of 10 rows: outputs and the self-attention cache (``{"self":
    K/V}``, written in place) against the reference's."""
    jcfg, cfg, jparams, params = audio_state()
    p, jp = _group(params["blocks"][0], 1), _group(jparams["blocks"][0], 1)
    rng = np.random.default_rng(3)
    mem = rng.standard_normal((B, 10, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
    shape = (B, 8, cfg.n_kv, cfg.head_dim)
    cache = {"self": {"k": torch.zeros(shape), "v": torch.zeros(shape)}}
    jcache = {"self": {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}}
    for pos, span in ((0, slice(0, 5)), (5, slice(5, 6))):
        s = span.stop - span.start
        got, cache_out, _ = blocks.apply_xdec(
            cfg, p, {}, torch.from_numpy(x[:, span]), cache=cache, pos=pos,
            ctx=_ctx(cfg, s, 8, pos, True), memory=torch.from_numpy(mem))
        want, jcache, _ = jblocks.apply_xdec(
            jcfg, jp, {}, jnp.asarray(x[:, span]), cache=jcache, pos=pos,
            memory=jnp.asarray(mem))
        assert cache_out is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache["self"][name].numpy(),
                                       np.asarray(jcache["self"][name]),
                                       **TOL)


# -- the model ---------------------------------------------------------------------------
def _batch(cfg, rng, enc_len, s=S):
    return {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
            "frames": rng.standard_normal(
                (B, enc_len, cfg.frontend_dim)).astype(np.float32)}


def _teacher_forcing(cfg, params, batch, port):
    """prefill(t0..t6) with the frames + decode(t7) on the memory, on one
    package -> (forward, prefill, step, memory)."""
    enc_len = batch["frames"].shape[1]
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    last = batch["tokens"][:, S - 1:]
    if port:
        full, _, _ = lm.forward(cfg, params, _t(batch))
        state = lm.init_serve_state(cfg, B, S, device="cpu", enc_len=enc_len)
        p, state = lm.prefill(cfg, params, state, _t(pre))
        step, state = lm.decode_step(cfg, params, state,
                                     torch.from_numpy(last))
        assert state["pos"] == S
        return full, p, step, state["memory"]
    full, _, _ = jlm.forward(cfg, params, _j(batch))
    state = jlm.init_serve_state(cfg, B, S, enc_len=enc_len)
    p, state = jlm.prefill(cfg, params, state, _j(pre))
    step, state = jlm.decode_step(cfg, params, state, jnp.asarray(last))
    return full, p, step, state["memory"]


@pytest.mark.parametrize("enc_len", [1500, 2048])
def test_teacher_forcing_over_long_memory(enc_len, audio_state):
    """``test_arch_smoke.py``'s teacher forcing over 1,500 frames (direct
    route) and 2,048 (flash) on both packages: the port's serve path
    against its forward (the reference's 2e-3), each of its logits and the
    memory the state keeps against JAX's."""
    jcfg, cfg, jparams, params = audio_state()
    batch = _batch(cfg, np.random.default_rng(enc_len), enc_len)
    full, pre, step, mem = _teacher_forcing(cfg, params, batch, True)
    jfull, jpre, jstep, jmem = _teacher_forcing(jcfg, jparams, batch, False)
    np.testing.assert_allclose(pre.numpy(), full[:, :S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    assert mem.shape == (B, enc_len, cfg.d_model)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
    for got, want in ((full, jfull), (pre, jpre), (step, jstep)):
        _close(got, want, cfg.vocab)


@pytest.mark.parametrize("enc_len", [8, 2048])
def test_bfloat16_teacher_forcing_over_memory(enc_len, audio_state):
    """The same in bf16 (the dtype served at full width), each logit within
    2**-4 of JAX's std."""
    jcfg, cfg, jparams, params = audio_state("bfloat16")
    batch = _batch(cfg, np.random.default_rng(enc_len + 1), enc_len)
    got = _teacher_forcing(cfg, params, batch, True)
    want = _teacher_forcing(jcfg, jparams, batch, False)
    for a, b in zip(got[:3], want[:3]):
        _close_bf16(a, b, cfg.vocab)


def test_empty_memory_serves_as_the_reference(audio_state):
    """``init_serve_state`` with no ``enc_len``: memory (B, 0, D) in the
    model's dtype; prefill with no frames reads it (cross-attention adds
    zeros), then decode, both against JAX's; the state keeps the memory."""
    jcfg, cfg, jparams, params = audio_state()
    state = lm.init_serve_state(cfg, B, S, device="cpu")
    assert state["memory"].shape == (B, 0, cfg.d_model)
    assert state["memory"].dtype == torch.float32
    jstate = jlm.init_serve_state(jcfg, B, S)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    pre, state = lm.prefill(cfg, params, state,
                            {"tokens": torch.from_numpy(tokens[:, :6])})
    jpre, jstate = jlm.prefill(jcfg, jparams, jstate,
                               {"tokens": jnp.asarray(tokens[:, :6])})
    _close(pre, jpre, cfg.vocab)
    step, state = lm.decode_step(cfg, params, state,
                                 torch.from_numpy(tokens[:, 6:7]))
    jstep, _ = jlm.decode_step(jcfg, jparams, jstate,
                               jnp.asarray(tokens[:, 6:7]))
    _close(step, jstep, cfg.vocab)
    assert state["memory"].shape == (B, 0, cfg.d_model)


def test_prefill_with_frames_re_encodes(audio_state):
    """Frames in a batch re-encode even when the state holds a memory; a
    decode step without them reads the state's."""
    _, cfg, _, params = audio_state()
    rng = np.random.default_rng(5)
    a, b = (_batch(cfg, rng, 6) for _ in range(2))
    state = lm.init_serve_state(cfg, B, S, device="cpu", enc_len=6)
    _, state = lm.prefill(cfg, params, state, _t(dict(a, tokens=a[
        "tokens"][:, :4])))
    mem_a = state["memory"].clone()
    _, state = lm.decode_step(cfg, params, state,
                              torch.from_numpy(a["tokens"][:, 4:5]))
    assert torch.equal(state["memory"], mem_a)
    fresh = lm.init_serve_state(cfg, B, S, device="cpu", enc_len=6)
    _, fresh = lm.prefill(cfg, params, fresh, _t(dict(b, tokens=b[
        "tokens"][:, :4])))
    _, state = lm.prefill(cfg, params, state, _t(dict(b, tokens=b[
        "tokens"][:, 5:6])))
    assert state["pos"] == 6
    assert torch.equal(state["memory"], fresh["memory"])
    assert not torch.equal(mem_a, fresh["memory"])


def test_refusals_as_for_the_dense_path(audio_state):
    """A token id outside [0, padded_vocab) raises ``IndexError``; a write
    past max_len raises ``ValueError``."""
    _, cfg, _, params = audio_state()
    frames = torch.zeros((1, 4, cfg.frontend_dim))
    state = lm.init_serve_state(cfg, 1, 4, device="cpu", enc_len=4)
    with pytest.raises(IndexError, match="outside"):
        lm.prefill(cfg, params, state, {
            "tokens": torch.tensor([[0, cfg.padded_vocab]]),
            "frames": frames})
    with pytest.raises(ValueError, match="overflow"):
        lm.prefill(cfg, params, state, {
            "tokens": torch.zeros((1, 5), dtype=torch.int32),
            "frames": frames})


def test_param_specs_bytes_at_full_size():
    """seamless-m4t-large-v2 at full size: 2,035,050,496 parameters,
    4,070,100,992 B in bf16, the reference's ``param_specs`` to the byte,
    on ``meta`` (nothing allocated)."""
    specs = lm.param_specs(get_config(ARCH))
    leaves = pytree.tree_leaves(specs)
    assert all(t.device.type == "meta" for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    jbytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize for s in
                 jax.tree_util.tree_leaves(jlm.param_specs(
                     jget_config(ARCH))))
    assert nbytes == jbytes == 4_070_100_992
    assert lm.param_count(specs) == 2_035_050_496


# -- the dense and MoE paths keep their calls ----------------------------------------------
class _Calls(TorchDispatchMode):
    """PyTorch operator calls (views included) dispatched inside."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# a reduced decode step's operator calls, counted before cross-attention
# and the bidirectional switch were added to the shared attention code
DECODE_CALLS = {"glm4-9b": 239, "moonshot-v1-16b-a3b": 373,
                "llama4-maverick-400b-a17b": 562}


@pytest.mark.parametrize("arch", sorted(DECODE_CALLS))
def test_decode_step_makes_as_many_calls_as_before(arch):
    """Cross-attention and the bidirectional switch are Python branches:
    a reduced decode step of the dense and MoE archs dispatches exactly
    the operators it did before, at max_len 8 and 2,048."""
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, 0, device="cpu")
    for max_len in (8, 2048):
        state = lm.init_serve_state(cfg, 2, max_len, device="cpu")
        tok = torch.zeros((2, 6), dtype=torch.int32)
        _, state = lm.prefill(cfg, params, state, {"tokens": tok})
        with _Calls() as calls:
            lm.decode_step(cfg, params, state, tok[:, :1])
        assert calls.n == DECODE_CALLS[arch], (max_len, calls.n)
