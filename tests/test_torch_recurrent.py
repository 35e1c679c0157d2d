"""Port parity, the recurrent families: ``repro_torch.models.blocks``'
``mlstm``, ``slstm`` and ``hymba`` kinds and their serve state against
``repro.models`` on the CPU.

Each block takes the reference's parameters (``init_<kind>`` from a JAX
key, carried with ``lm.params_from_reference``) and the same seeded numpy
input, in each of its three cache modes: none, a prefill that captures
the state, and a one-token decode step on the reference's own prefilled
state. Outputs and new states are held to JAX's within ``TOL`` (float32:
rtol 1e-5, atol 1e-5 of the output's std) and ``BF16_TOL`` (bfloat16,
2**-6 of the output's std; Hymba's block ``HYMBA_BF16_TOL``). The conv
equals JAX's bit for bit in bfloat16; in float32 its taps do, and its
SiLU is within float32 rounding of XLA's.

Then what the reference does that the port keeps on purpose: a prefill on
a live state restarts the GLA state (and mLSTM's normalizer) from zero
while the conv history and sLSTM's (h, c) carry over; a one-token
prefill takes the decode branch; xlstm has no KV cache, so nothing
overflows and the engine stops at max_len as the reference's does;
Hymba's attention cache raises past max_len. Hymba's per-layer windows,
the serve state's shapes and dtypes, and the full-size bytes close it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import blocks, lm
from repro_torch.serve import Request, ServeEngine

ARCHS = {"mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b", "hymba": "hymba-1.5b"}
TOL = 1e-5                # float32: rtol, and atol in units of the std
BF16_TOL = 2.0 ** -6      # bfloat16: atol in units of the output's std
# Hymba's block ends in the dense blocks' SwiGLU MLP (``layers.swiglu``,
# shared since the dense slice), whose ``F.silu`` rounds once where XLA
# rounds each op: a bf16 ulp at a large value (0.024 of the block
# output's std measured here, past BF16_TOL), so the block is held to
# ``test_torch_lm.py``'s bf16 rule, 2**-4 of the std
HYMBA_BF16_TOL = 2.0 ** -4
B, S = 2, 8
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)     # reduced models, float32 logits


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(port, ref, dtype, what="", bf16_tol=BF16_TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, what
    assert np.isfinite(port).all(), what
    scale = max(float(ref.std()), 1e-30)
    if dtype == "bfloat16":
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=bf16_tol * scale, err_msg=what)
    else:
        np.testing.assert_allclose(port, ref, rtol=TOL, atol=TOL * scale,
                                   err_msg=what)


def _to_torch(tree):
    return lm.params_from_reference(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def _configs(kind, dtype):
    arch = ARCHS[kind]
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    return jcfg, cfg


def _flat(tree, prefix=""):
    """{path: leaf} of a dict/list pytree (JAX's or the port's)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _group_cache(state, j):
    """Group 0's cache of pattern position ``j``: the port's as views."""
    return pytree.tree_map(lambda t: t[0], state["blocks"][j])


# -- the causal conv ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_bit_for_bit(dtype, history):
    """The taps summed in the reference's order and the SiLU as XLA
    expands it: in bfloat16 the output and the new history equal JAX's bit
    for bit, compiled or not. In float32 the history and the taps' sum
    equal the reference run op by op; the SiLU's ``exp`` is XLA's own
    polynomial, and compiled, XLA contracts the taps into fused
    multiply-adds, so the output is held within float32 rounding."""
    rng = np.random.default_rng(3)
    c, width = 24, 4
    x = rng.standard_normal((B, 5, c)).astype(np.float32)
    w = (rng.standard_normal((width, c)) * 0.5).astype(np.float32)
    st = rng.standard_normal((B, width - 1, c)).astype(np.float32)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jx, jw, jst = (jnp.asarray(a.astype(np_dt)) for a in (x, w, st))
    tx, tw, tst = (lm.params_from_reference(a.astype(np_dt), device="cpu")
                   for a in (x, w, st))
    y, new = blocks._causal_conv(tx, tw, tst if history else None)
    for fn in (jblocks._causal_conv, jax.jit(jblocks._causal_conv)):
        jy, jnew = fn(jx, jw, jst if history else None)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(y), _np(jy))
        else:
            np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(_np(new), _np(jnew))
    assert y.dtype == tx.dtype and new.shape == (B, width - 1, c)
    if dtype == "float32":          # the taps, before the SiLU
        pad = jst if history else jnp.zeros((B, width - 1, c))
        xp = jnp.concatenate([pad, jx], axis=1)
        want = sum(xp[:, i:i + 5] * jw[i] for i in range(width))
        tpad = tst if history else torch.zeros((B, width - 1, c))
        txp = torch.cat([tpad, tx], dim=1)
        got = sum(txp[:, i:i + 5] * tw[i] for i in range(width))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- each block in its three cache modes ---------------------------------------
def _block(kind, dtype, seed=0):
    jcfg, cfg = _configs(kind, dtype)
    j = jblocks.block_pattern(jcfg).index(kind)
    jp = jblocks.INIT[kind](jcfg, jax.random.PRNGKey(seed), 1)
    jp = jax.tree.map(lambda a: a[0], jp)
    return jcfg, cfg, j, jp, _to_torch(jp)


def _x(cfg, s, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    if cfg.dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    return jnp.asarray(a), lm.params_from_reference(a, device="cpu")


def _apply_both(kind, jcfg, cfg, jp, p, jx, x, *, jcache, cache, pos,
                window=0, max_len=S):
    """One block on both packages -> (port x, port cache, JAX x, JAX
    cache)."""
    s = x.shape[1]
    jmeta = {"window": jnp.asarray(window, jnp.int32)} if kind == "hymba" \
        else {}
    meta = {"window": np.int32(window)} if kind == "hymba" else {}
    ctx = blocks.StepContext(cfg, s, s if cache is None else max_len, pos,
                             None if cache is None else pos + s, "cpu")
    y, new, _ = blocks.APPLY[kind](cfg, p, meta, x, cache=cache, pos=pos,
                                   ctx=ctx)
    jy, jnew, _ = jblocks.APPLY[kind](jcfg, jp, jmeta, jx, cache=jcache,
                                      pos=jnp.asarray(pos, jnp.int32))
    return y, new, jy, jnew


def _close_caches(new, jnew, dtype, what):
    flat, jflat = _flat(new), _flat(jnew)
    assert flat.keys() == jflat.keys()
    for path, t in flat.items():
        ref = jflat[path]
        assert str(t.dtype).removeprefix("torch.") == str(ref.dtype), path
        _close(t, ref, dtype, f"{what} cache {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,window", [("mlstm", 0), ("slstm", 0),
                                         ("hymba", 0), ("hymba", 4)])
def test_block_cache_modes_match_reference(kind, window, dtype):
    """No cache over S tokens; a prefill of S - 1 tokens capturing the
    state; a decode step on JAX's prefilled state carried over."""
    jcfg, cfg, j, jp, p = _block(kind, dtype)
    jx, x = _x(cfg, S, seed=1)
    what = f"{kind} {dtype} window {window}"
    tol = HYMBA_BF16_TOL if kind == "hymba" else BF16_TOL
    y, new, jy, jnew = _apply_both(kind, jcfg, cfg, jp, p, jx, x,
                                   jcache=None, cache=None, pos=0,
                                   window=window)
    assert new is None and jnew is None and y.dtype == x.dtype
    _close(y, jy, dtype, what + " no cache", tol)

    jstate = jlm.init_serve_state(jcfg, B, S)
    state = lm.init_serve_state(cfg, B, S, device="cpu")
    jcache = jax.tree.map(lambda a: a[0], jstate["blocks"][j])
    cache = _group_cache(state, j)
    y, new, jy, jnew = _apply_both(kind, jcfg, cfg, jp, p, jx[:, :S - 1],
                                   x[:, :S - 1], jcache=jcache, cache=cache,
                                   pos=0, window=window)
    assert new is cache                   # written in place
    _close(y, jy, dtype, what + " prefill", tol)
    _close_caches(new, jnew, dtype, what + " prefill")

    cache = _to_torch(jnew)               # the reference's own state
    y, new, jy, jnew = _apply_both(kind, jcfg, cfg, jp, p, jx[:, S - 1:],
                                   x[:, S - 1:], jcache=jnew, cache=cache,
                                   pos=S - 1, window=window)
    _close(y, jy, dtype, what + " decode", tol)
    _close_caches(new, jnew, dtype, what + " decode")


# -- the reference's behaviour, kept ---------------------------------------------
@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jreduced(jget_config(arch))
            jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            cache[arch] = (jcfg, reduced(get_config(arch)), jparams,
                           _to_torch(jparams))
        return cache[arch]
    return get


def _tokens(cfg, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, s)).astype(np.int32)


def _prefills(arch, models, first, second, perturb=None, port=True):
    """prefill(first) then prefill(second) on a live state, on one
    package; ``perturb(state)`` edits the port's live state in between.
    -> the second prefill's logits (numpy for JAX's)."""
    jcfg, cfg, jparams, params = models(arch)
    max_len = first.shape[1] + second.shape[1]
    if not port:
        jstate = jlm.init_serve_state(jcfg, B, max_len)
        _, jstate = jlm.prefill(jcfg, jparams, jstate,
                                {"tokens": jnp.asarray(first)})
        jlogits, _ = jlm.prefill(jcfg, jparams, jstate,
                                 {"tokens": jnp.asarray(second)})
        return np.asarray(jlogits)
    state = lm.init_serve_state(cfg, B, max_len, device="cpu")
    _, state = lm.prefill(cfg, params, state,
                          {"tokens": torch.from_numpy(first)})
    if perturb is not None:
        perturb(state)
    logits, _ = lm.prefill(cfg, params, state,
                           {"tokens": torch.from_numpy(second)})
    return logits


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_prefill_on_a_live_state_restarts_the_gla_state(arch, models):
    """A second prefill matches the reference's, and its output does not
    read the GLA state or the normalizer left by the first (chunked_gla
    starts from zeros) but does read the conv history and sLSTM's h and
    c."""
    _, cfg, _, _ = models(arch)
    first, second = _tokens(cfg, 5, 1), _tokens(cfg, 3, 2)
    base = _prefills(arch, models, first, second)
    np.testing.assert_allclose(
        base.numpy(), _prefills(arch, models, first, second, port=False),
        **MODEL_TOL)
    kinds = blocks.block_pattern(cfg)

    def fill(names):
        def perturb(state):
            for kind, c in zip(kinds, state["blocks"]):
                for name in names.get(kind, ()):
                    c[name].fill_(3.0)
        return perturb

    gla_state = {"mlstm": ("state", "nstate"), "hymba": ("state",)}
    same = _prefills(arch, models, first, second, fill(gla_state))
    assert torch.equal(same, base)
    carried = {"mlstm": ("conv",), "slstm": ("h", "c")} \
        if arch == "xlstm-1.3b" else {"hymba": ("conv",)}
    for kind, names in carried.items():
        for name in names:
            moved = _prefills(arch, models, first, second,
                              fill({kind: (name,)}))
            assert not torch.allclose(moved, base), (kind, name)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_one_token_prefill_takes_the_decode_branch(arch, models):
    """On a live state, a one-token prefill is the decode step (the GLA
    state carries on), bit for bit, and the reference's agrees."""
    jcfg, cfg, jparams, params = models(arch)
    first, last = _tokens(cfg, 5, 3), _tokens(cfg, 1, 4)
    out = []
    for step in (lm.prefill, lambda c, p, s, t: lm.decode_step(
            c, p, s, t["tokens"])):
        state = lm.init_serve_state(cfg, B, 8, device="cpu")
        _, state = lm.prefill(cfg, params, state,
                              {"tokens": torch.from_numpy(first)})
        logits, state = step(cfg, params, state,
                             {"tokens": torch.from_numpy(last)})
        out.append((logits, state))
    (a, sa), (b, sb) = out
    assert torch.equal(a, b)
    for x, y in zip(pytree.tree_leaves(sa["blocks"]),
                    pytree.tree_leaves(sb["blocks"])):
        assert torch.equal(x, y)
    jstate = jlm.init_serve_state(jcfg, B, 8)
    _, jstate = jlm.prefill(jcfg, jparams, jstate,
                            {"tokens": jnp.asarray(first)})
    jlogits, _ = jlm.prefill(jcfg, jparams, jstate,
                             {"tokens": jnp.asarray(last)})
    np.testing.assert_allclose(a.numpy(), np.asarray(jlogits), **MODEL_TOL)
    # a fresh state would have given another answer: the state was read
    fresh, _ = lm.prefill(cfg, params,
                          lm.init_serve_state(cfg, B, 8, device="cpu"),
                          {"tokens": torch.from_numpy(last)})
    assert not torch.allclose(fresh, a)


def test_xlstm_decodes_past_max_len_and_the_engine_stops_there(models):
    """No KV cache: a decode step past max_len runs on both packages
    (nothing to overflow, and the port adds no refusal); the engine stops
    at max_len, with the reference's tokens."""
    jcfg, cfg, jparams, params = models("xlstm-1.3b")
    tok = _tokens(cfg, 1, 5)
    state = lm.init_serve_state(cfg, B, 2, device="cpu")
    jstate = jlm.init_serve_state(jcfg, B, 2)
    for _ in range(4):
        logits, state = lm.decode_step(cfg, params, state,
                                       torch.from_numpy(tok))
        jlogits, jstate = jlm.decode_step(jcfg, jparams, jstate,
                                          jnp.asarray(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL_TOL)
    assert state["pos"] == int(jstate["pos"]) == 4
    prompt = _tokens(cfg, 6, 6)[0]
    outs = []
    for eng, req in ((ServeEngine(cfg, params, batch_size=1, max_len=9,
                                  device="cpu"), Request),
                     (JServeEngine(jcfg, jparams, batch_size=1, max_len=9),
                      JRequest)):
        done = eng.run_batch([req(prompt=prompt.copy(), max_new_tokens=10)])
        outs.append(done[0].out_tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 9 - 6 + 1


def test_hymba_attention_cache_overflow_raises(models):
    _, cfg, _, params = models("hymba-1.5b")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    state = lm.init_serve_state(cfg, 1, max_len=4, device="cpu")
    _, state = lm.prefill(cfg, params, state,
                          {"tokens": torch.zeros((1, 3), dtype=torch.int32)})
    _, state = lm.decode_step(cfg, params, state, tok)
    assert state["pos"] == 4
    with pytest.raises(ValueError, match="overflow"):
        lm.decode_step(cfg, params, state, tok)
    with pytest.raises(ValueError, match="overflow"):
        lm.prefill(cfg, params, lm.init_serve_state(cfg, 1, 4, device="cpu"),
                   {"tokens": torch.zeros((1, 5), dtype=torch.int32)})


# -- Hymba's per-layer windows -----------------------------------------------------
def test_hymba_windows_per_layer():
    """Full attention at the first, middle and last layers and the
    configured window elsewhere, as the reference's meta; a 4-layer
    reduced model, whose layer 1 keeps a 4-token window, against JAX past
    that window (and the window changes its logits)."""
    cfg = get_config("hymba-1.5b")
    want = [0 if i in (0, 16, 31) else 1024 for i in range(32)]
    assert lm.build_meta(cfg)[0]["window"].tolist() == want
    assert np.asarray(jlm.build_meta(jget_config("hymba-1.5b"))[0]
                      ["window"]).tolist() == want
    jcfg = dataclasses.replace(jreduced(jget_config("hymba-1.5b")),
                               n_layers=4)
    cfg = dataclasses.replace(reduced(cfg), n_layers=4)
    assert lm.build_meta(cfg)[0]["window"].tolist() == [0, 4, 0, 0]
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    params = _to_torch(jparams)
    tokens = _tokens(cfg, 12, 7)
    logits, _, _ = lm.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jlogits, _, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    full, _, _ = lm.forward(dataclasses.replace(cfg, sliding_window=0),
                            params, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(full[:, :4], logits[:, :4])   # within the window
    assert not torch.allclose(full[:, 4:], logits[:, 4:])


# -- the serve state and the sizes -----------------------------------------------------
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_serve_state_matches_reference(arch, dtype):
    """Every cache of the reference's serve state: the same path, shape
    and dtype (the recurrent states float32 in a bf16 model), all zeros."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype=dtype)
    state = lm.init_serve_state(cfg, 3, 10, device="cpu")
    jstate = jlm.init_serve_state(jcfg, 3, 10)
    flat, jflat = _flat(state["blocks"]), _flat(jstate["blocks"])
    assert flat.keys() == jflat.keys()
    for path, t in flat.items():
        a = jflat[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), path
        assert not t.any()
    assert state["pos"] == 0


@pytest.mark.parametrize("arch,nbytes", [("xlstm-1.3b", 4_497_625_088),
                                         ("hymba-1.5b", 3_448_838_400)])
def test_full_size_bytes_on_meta(arch, nbytes):
    specs = lm.param_specs(get_config(arch))
    leaves = pytree.tree_leaves(specs)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) == nbytes
