"""Port parity, the LM: ``repro_torch.models.lm`` and ``repro_torch.configs``
against ``repro.models.lm`` and ``repro.configs`` on the CPU.

For each arch of every family (``dense``, ``vlm``, ``moe``, ``ssm``,
``hybrid``, ``audio``) at ``reduced()``, the reference's parameters
(``init_params`` from a JAX key) are carried into the port with
``params_from_reference`` and the same seeded numpy batches go through both
packages. Logits (forward, prefill, decode) are held to JAX's within rtol
1e-4 / atol 1e-5 with argmax equal: float32 matmuls, norms and softmax
sums in another order, over two layers (tied embeddings put logits at ~5x
the others' scale). xlstm's atol is ``lm_parity.ATOL_BY_ARCH``'s 1e-4: its
16 reduced layers, 14 of them a chunked GLA, put two float32
implementations ~3e-5 apart. The
reference's own asserts (teacher forcing at 2e-3, the int8 cache's
closeness) run on the port as well.

For a MoE arch the reference runs op by op (``jax.disable_jit``) with its
``moe_ff`` wrapped to record each call's expert ids (:func:`jax_routes`),
and the port's ids (``moe.routing_trace``) must equal them with no
forcing; the forward's load-balance and z losses are held as the logits.
The bf16 MoE cases, which force JAX's ids, are in ``test_torch_moe.py``.
In bf16, xlstm is held to the reference run op by op (:data:`OP_BY_OP`);
the recurrent blocks' own cases are in ``test_torch_recurrent.py``.
An audio arch's batches carry ``frames`` as ``tests/test_arch_smoke.py``'s
do (S of them, the serve state's ``enc_len`` S); its block-level cases are
in ``test_torch_audio.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import blocks, lm, moe
from repro_torch.serve import lm_parity

LM_ARCHS = ["glm4-9b", "qwen2-7b", "minicpm-2b", "starcoder2-15b",
            "llava-next-mistral-7b"]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
AUDIO_ARCHS = ["seamless-m4t-large-v2"]
RECURRENT_ARCHS = ["xlstm-1.3b", "hymba-1.5b"]
SERVED_ARCHS = LM_ARCHS + MOE_ARCHS + AUDIO_ARCHS + RECURRENT_ARCHS
TOL = dict(rtol=1e-4, atol=1e-5)
S = 8          # smoke sequence length
B = 2


def _flat(tree, prefix=""):
    """{path: leaf} of a dict/list pytree (JAX's or the port's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _carry(jparams):
    return lm.params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _batch(cfg, rng, s=S, b=B):
    """``tests/test_arch_smoke.py``'s batch, as numpy."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@contextlib.contextmanager
def jax_routes(monkeypatch):
    """``with jax_routes(monkeypatch) as ids:`` — the reference runs op by
    op, and each call of its ``moe_ff`` appends its expert ids (G,S,k) to
    ``ids``: ``jax.lax.top_k`` of the router probabilities, recomputed
    from the call's own inputs before the original runs. No file of the
    reference changes."""
    ids: list = []
    original = jblocks.moe_ff

    def recording(x, router_w, *args, top_k, **kw):
        logits = jnp.einsum("gsd,de->gse", x, router_w,
                            preferred_element_type=jnp.float32)
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        ids.append(torch.from_numpy(np.asarray(jax.lax.top_k(probs,
                                                             top_k)[1])))
        return original(x, router_w, *args, top_k=top_k, **kw)

    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jblocks, "moe_ff", recording)
        yield ids


@contextlib.contextmanager
def both_routed(cfg, monkeypatch):
    """For a MoE ``cfg``: JAX's calls inside record their expert ids and
    the port's their routing; on leaving, the two lists must be equal,
    call by call. For the other families nothing is recorded."""
    if cfg.family != "moe":
        yield
        return
    with jax_routes(monkeypatch) as ids, moe.routing_trace() as tr:
        yield
    assert len(tr.calls) == len(ids) > 0
    for call, want in zip(tr.calls, ids):
        assert torch.equal(call.idx, want.to(call.idx.dtype))


def _close(port, ref, vocab=None, arch=None):
    port, ref = port.numpy(), np.asarray(ref)
    if vocab is not None:
        port, ref = port[..., :vocab], ref[..., :vocab]
        np.testing.assert_array_equal(port.argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(port, ref, rtol=TOL["rtol"],
                               atol=lm_parity.ATOL_BY_ARCH.get(arch,
                                                               TOL["atol"]))


@pytest.fixture(scope="module")
def arch_state():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jreduced(jget_config(arch))
            jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            cache[arch] = (jcfg, reduced(get_config(arch)), jparams,
                           _carry(jparams))
        return cache[arch]
    return get


# -- configs ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """Every arch's config and its ``reduced()`` equal the reference's,
    field by field, with the same block pattern and group count."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == \
        dataclasses.asdict(jreduced(jcfg))
    for c, jc in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        assert blocks.block_pattern(c) == jblocks.block_pattern(jc)
        assert blocks.n_groups(c) == jblocks.n_groups(jc)
        assert c.param_count() == jc.param_count()
        assert c.padded_vocab == jc.padded_vocab


def test_param_counts_full_configs():
    """Full configs hit the published parameter scale (±20%)."""
    expect = {"glm4-9b": 9.4e9, "qwen2-7b": 7.6e9, "minicpm-2b": 2.7e9,
              "starcoder2-15b": 15e9, "xlstm-1.3b": 1.55e9,
              "hymba-1.5b": 1.5e9, "llava-next-mistral-7b": 7.2e9}
    for arch, n in expect.items():
        cfg = get_config(arch)
        got = cfg.param_count()
        assert 0.7 * n < got < 1.35 * n, (arch, got, n)
    # MoE: total vs active split
    l4 = get_config("llama4-maverick-400b-a17b")
    assert 3.2e11 < l4.param_count() < 4.8e11
    assert 1.2e10 < l4.active_param_count() < 2.2e10
    ms = get_config("moonshot-v1-16b-a3b")
    assert ms.active_param_count() < 0.25 * ms.param_count()


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_param_specs_match_reference_at_full_size(arch):
    """``param_specs`` of the full config: every tensor of the reference's
    pytree, same path, shape and dtype (a MoE router float32 in a bf16
    model), on ``meta`` (nothing allocated); glm4-9b has 9,399,767,040
    (18,799,534,080 B in bf16)."""
    cfg = get_config(arch)
    specs = _flat(lm.param_specs(cfg))
    jspecs = _flat(jlm.param_specs(jget_config(arch)))
    assert specs.keys() == jspecs.keys()
    for path, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == jspecs[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == \
            str(jspecs[path].dtype), path
    assert lm.param_count(lm.param_specs(cfg)) == \
        sum(int(np.prod(s.shape)) for s in jspecs.values())
    if arch == "glm4-9b":
        assert lm.param_count(lm.param_specs(cfg)) == 9_399_767_040


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_init_params_layout_and_seed(arch, arch_state):
    """The port's own init: the reference's layout, shapes and dtypes; the
    same seed (or an equal generator) gives the same tensors; layer norms
    ones and biases zeros, as the reference's."""
    jcfg, cfg, jparams, _ = arch_state(arch)
    a = lm.init_params(cfg, 7, device="cpu")
    b = lm.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    fa, fb, fj = _flat(a), _flat(b), _flat(jparams)
    assert fa.keys() == fj.keys()
    for path, t in fa.items():
        assert tuple(t.shape) == fj[path].shape and t.dtype == torch.float32
        assert torch.equal(t, fb[path]), path
        name = path.rsplit("/", 1)[-1]
        if name in ("ln", "ln1", "ln2", "ln_x", "ln_heads", "norm_attn",
                    "norm_ssm", "final_norm", "enc_norm"):
            assert torch.equal(t, torch.ones_like(t))
        elif name in ("bq", "bk", "bv", "b", "a_log"):
            assert torch.equal(t, torch.zeros_like(t))
        else:
            assert t.std() > 0
    assert not torch.equal(fa["/embed"],
                           lm.init_params(cfg, 8, device="cpu")["embed"])


def test_params_carry_bfloat16_bit_for_bit():
    """A bf16 reference pytree carries into bf16 tensors and back, bits
    unchanged."""
    jcfg = dataclasses.replace(jreduced(jget_config("glm4-9b")),
                               dtype="bfloat16")
    jparams = jax.tree.map(np.asarray,
                           jlm.init_params(jcfg, jax.random.PRNGKey(3)))
    params = lm.params_from_reference(jparams, device="cpu")
    back = _flat(lm.params_to_numpy(params))
    for path, a in _flat(jparams).items():
        assert _flat(params)[path].dtype == torch.bfloat16
        assert back[path].dtype == a.dtype
        np.testing.assert_array_equal(back[path].view(np.uint16),
                                      a.view(np.uint16))


# -- forward ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_forward_matches_reference(arch, arch_state, monkeypatch):
    """``test_arch_smoke.py``'s forward (shapes, finite, padded vocab
    masked) on the port, and the logits against JAX's; a MoE arch's
    expert ids equal, its aux and z losses within the same tolerance."""
    jcfg, cfg, jparams, params = arch_state(arch)
    batch = _batch(cfg, np.random.default_rng(1))
    with both_routed(cfg, monkeypatch):
        logits, (aux, z), caches = lm.forward(cfg, params, _t(batch))
        jlogits, (jaux, jz), _ = jlm.forward(jcfg, jparams, _j(batch))
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert logits.dtype == torch.float32 and caches is None
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    assert float(logits[..., cfg.vocab:].max()) < -1e29
    _close(logits, jlogits, cfg.vocab, arch)
    np.testing.assert_allclose([float(aux), float(z)],
                               [float(jaux), float(jz)], **TOL)
    if cfg.family == "moe":
        assert float(aux) > 0 and float(z) > 0


# -- serving ----------------------------------------------------------------------
def _prefill_decode(cfg, params, batch, max_len, port):
    """prefill(t0..t6) + decode(t7) on one package -> (pre, step, pos). An
    audio batch's frames go to the prefill (``enc_len`` their count)."""
    pre = {k: (v[:, :S - 1] if k == "tokens" else v)
           for k, v in batch.items()}
    last = batch["tokens"][:, S - 1:S]
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    if port:
        state = lm.init_serve_state(cfg, B, max_len=max_len, device="cpu",
                                    enc_len=enc_len)
        pre_logits, state = lm.prefill(cfg, params, state, _t(pre))
        step, state = lm.decode_step(cfg, params, state,
                                     torch.from_numpy(last))
        return pre_logits, step, state["pos"]
    state = jlm.init_serve_state(cfg, B, max_len=max_len, enc_len=enc_len)
    pre_logits, state = jlm.prefill(cfg, params, state, _j(pre))
    step, state = jlm.decode_step(cfg, params, state, jnp.asarray(last))
    return pre_logits, step, int(state["pos"])


@pytest.mark.parametrize("arch", SERVED_ARCHS)
@pytest.mark.parametrize("max_len", [S, 2048])
def test_prefill_decode_matches_forward(arch, max_len, arch_state,
                                        monkeypatch):
    """Teacher forcing (``test_arch_smoke.py:77-98``): prefill(t0..t6) +
    decode(t7) == forward(t0..t7) on the port, and each against JAX's
    (a MoE arch's expert ids equal, call by call). At max_len 2,048 the
    prefill's 2,048 cached keys take the flash path (t > kv_chunk = 1,024)
    in both packages."""
    jcfg, cfg, jparams, params = arch_state(arch)
    batch = _batch(cfg, np.random.default_rng(3))
    full, _, _ = lm.forward(cfg, params, _t(batch))
    with both_routed(cfg, monkeypatch):
        pre, step, pos = _prefill_decode(cfg, params, batch, max_len, True)
        jpre, jstep, jpos = _prefill_decode(jcfg, jparams, batch, max_len,
                                            False)
    np.testing.assert_allclose(pre.numpy(), full[:, :S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    assert pos == S and isinstance(pos, int)
    _close(pre, jpre, cfg.vocab, arch)
    _close(step, jstep, cfg.vocab, arch)
    assert jpos == pos


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_multi_step_decode(arch, arch_state, monkeypatch):
    """``test_arch_smoke.py:101-111`` on the port, each step's logits and
    greedy token (and a MoE arch's expert ids) against JAX's."""
    jcfg, cfg, jparams, params = arch_state(arch)
    rng = np.random.default_rng(4)
    state = lm.init_serve_state(cfg, B, max_len=S, device="cpu")
    jstate = jlm.init_serve_state(jcfg, B, max_len=S)
    first = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    tok, jtok = torch.from_numpy(first), jnp.asarray(first)
    for _ in range(4):
        with both_routed(cfg, monkeypatch):
            logits, state = lm.decode_step(cfg, params, state, tok)
            jlogits, jstate = jlm.decode_step(jcfg, jparams, jstate, jtok)
        assert logits.shape == (B, 1, cfg.padded_vocab)
        assert torch.isfinite(logits[..., :cfg.vocab]).all()
        _close(logits, jlogits, cfg.vocab, arch)
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        jtok = jnp.argmax(jlogits[..., :cfg.vocab], axis=-1).astype(
            jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert state["pos"] == 4


# -- bfloat16, the dtype served at full width ---------------------------------------
# Allowed |logit| difference in bf16, in units of the reference logits'
# standard deviation. XLA's fusions keep float32 between elementwise ops
# (SiLU times the up projection, residual adds) where the port rounds each
# op's output to bf16, so ~3/4 of the logits differ by a few bf16 ulps (up
# to 0.035 std over these archs). The float32 islands themselves (scores,
# softmax, RoPE, norms) are held bit for bit in test_torch_lm_core.py.
BF16_TOL = 2.0 ** -4
# Archs held to the reference run op by op (``jax.disable_jit``), which
# rounds every bf16 op's result as the reference's code writes it. The
# port equals that run in each block bit for bit. Compiled, the scan over
# a group keeps the residual stream in float32 from one block into the
# next one's RMS norm (XLA's excess precision on the CPU), and xlstm's 16
# reduced layers amplify that to ~0.34 of the logits' std between the
# reference's own two runs: the compiled run is not held.
OP_BY_OP = {"xlstm-1.3b"}


def _reference_run(arch):
    return jax.disable_jit() if arch in OP_BY_OP else \
        contextlib.nullcontext()


@pytest.fixture(scope="module")
def bf16_state():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                                       dtype="bfloat16")
            jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
            cfg = dataclasses.replace(reduced(get_config(arch)),
                                      dtype="bfloat16")
            cache[arch] = (jcfg, cfg, jparams, _carry(jparams))
        return cache[arch]
    return get


def _close_bf16(port, ref, vocab):
    """Within BF16_TOL std of the reference, argmax equal wherever the
    reference's top-2 margin exceeds that."""
    assert port.dtype == torch.float32
    port = port.numpy()[..., :vocab]
    ref = np.asarray(ref, np.float32)[..., :vocab]
    assert np.isfinite(port).all()
    tol = BF16_TOL * float(ref.std())
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    np.testing.assert_array_equal(port.argmax(-1)[clear],
                                  ref.argmax(-1)[clear])


@pytest.mark.parametrize("arch", LM_ARCHS + AUDIO_ARCHS + RECURRENT_ARCHS)
def test_bfloat16_forward_matches_reference(arch, bf16_state):
    """The reference's bf16 parameters carried bit for bit; the forward's
    logits against JAX's."""
    jcfg, cfg, jparams, params = bf16_state(arch)
    assert params["embed"].dtype == torch.bfloat16
    batch = _batch(cfg, np.random.default_rng(5))
    logits, _, _ = lm.forward(cfg, params, _t(batch))
    with _reference_run(arch):
        jlogits, _, _ = jlm.forward(jcfg, jparams, _j(batch))
    _close_bf16(logits, jlogits, cfg.vocab)


@pytest.mark.parametrize("arch", LM_ARCHS + AUDIO_ARCHS + RECURRENT_ARCHS)
@pytest.mark.parametrize("max_len", [S, 2048])
def test_bfloat16_prefill_decode_matches_reference(arch, max_len,
                                                   bf16_state):
    """bf16 prefill (the flash path at max_len 2,048) and decode on both
    packages, each step's logits against JAX's."""
    jcfg, cfg, jparams, params = bf16_state(arch)
    batch = _batch(cfg, np.random.default_rng(6))
    pre, step, pos = _prefill_decode(cfg, params, batch, max_len, True)
    with _reference_run(arch):
        jpre, jstep, jpos = _prefill_decode(jcfg, jparams, batch, max_len,
                                            False)
    assert pos == jpos == S
    _close_bf16(pre, jpre, cfg.vocab)
    _close_bf16(step, jstep, cfg.vocab)


# -- int8 KV cache (tests/test_kv_int8.py:27-56) ------------------------------------
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-7b"])
def test_int8_cache_decode_close_to_bf16(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32")
    jcfg8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = _carry(jparams)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}

    def run(c, port):
        pre, step, _ = _prefill_decode(c, params if port else jparams,
                                       batch, S, port)
        return pre, step

    pre_f, step_f = run(cfg, True)
    pre_q, step_q = run(cfg8, True)
    # quantized cache tracks full-precision logits closely (not exactly)
    np.testing.assert_allclose(pre_q.numpy(), pre_f.numpy(), rtol=0.1,
                               atol=0.15)
    np.testing.assert_allclose(step_q.numpy(), step_f.numpy(), rtol=0.1,
                               atol=0.15)
    # and the argmax decisions agree almost everywhere
    agree = (pre_q.argmax(-1) == pre_f.argmax(-1)).float().mean()
    assert agree > 0.9, agree
    # against the reference's int8 cache
    jpre_q, jstep_q = run(jcfg8, False)
    _close(pre_q, jpre_q, cfg.vocab)
    _close(step_q, jstep_q, cfg.vocab)


def test_int8_cache_memory_halves():
    cfg = reduced(get_config("glm4-9b"))
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    s16 = lm.init_serve_state(cfg, 2, max_len=64, device="cpu")
    s8 = lm.init_serve_state(cfg8, 2, max_len=64, device="cpu")

    def nbytes(state):
        return sum(t.numel() * t.element_size()
                   for t in _flat(state["blocks"]).values())
    assert nbytes(s8) < 0.62 * nbytes(s16)
    jcfg = jreduced(jget_config("glm4-9b"))
    jstate = jlm.init_serve_state(
        dataclasses.replace(jcfg, kv_cache_dtype="int8"), 2, max_len=64)
    assert nbytes(s8) == sum(x.size * x.dtype.itemsize for x in
                             jax.tree_util.tree_leaves(jstate["blocks"]))


# -- refusals the reference does not make ------------------------------------------------
def test_token_ids_outside_the_table_raise(arch_state):
    """``jnp.take`` fills NaN for an id outside [0, padded_vocab); the port
    raises before any row is read. Ids in the padded tail are rows."""
    _, cfg, _, params = arch_state("glm4-9b")
    for bad in (-1, cfg.padded_vocab, 2 ** 31 - 1):
        tokens = torch.tensor([[0, bad]], dtype=torch.int32)
        with pytest.raises(IndexError, match="outside"):
            lm.forward(cfg, params, {"tokens": tokens})
        state = lm.init_serve_state(cfg, 1, max_len=S, device="cpu")
        with pytest.raises(IndexError, match="outside"):
            lm.prefill(cfg, params, state, {"tokens": tokens})
    logits, _, _ = lm.forward(cfg, params, {"tokens": torch.tensor(
        [[cfg.vocab, cfg.padded_vocab - 1]], dtype=torch.int32)})
    assert torch.isfinite(logits[..., :cfg.vocab]).all()


def test_cache_overflow_raises(arch_state):
    """Where ``dynamic_update_slice`` would clamp a write past max_len (and
    overwrite the last cached keys), the port raises."""
    _, cfg, _, params = arch_state("glm4-9b")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    state = lm.init_serve_state(cfg, 1, max_len=S, device="cpu")
    _, state = lm.prefill(cfg, params, state,
                          {"tokens": torch.zeros((1, S - 1), dtype=torch.int32)})
    _, state = lm.decode_step(cfg, params, state, tok)
    assert state["pos"] == S
    with pytest.raises(ValueError, match="overflow"):
        lm.decode_step(cfg, params, state, tok)
    fresh = lm.init_serve_state(cfg, 1, max_len=S, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        lm.prefill(cfg, params, fresh,
                   {"tokens": torch.zeros((1, S + 1), dtype=torch.int32)})
