"""Port parity, MoE: ``repro_torch.models.moe`` and the MoE archs against
``repro.models.moe`` and ``repro.models.lm`` on the CPU.

``tests/test_model_core.py``'s three MoE tests run on both packages;
``route`` and ``moe_ff`` take the same inputs in both. In float32 the
dispatch is equal, the combine within 1e-6 and the output within rtol
1e-4 / atol 1e-5. In bf16 the expert ids are equal and the output equals
JAX's but for at most 0.1% of elements, each one bf16 ulp off (the rule
``test_torch_lm_core.py`` holds attention to): the port rounds the SiLU
op by op as XLA expands ``jax.nn.silu``, the gates to bf16 before the
combine, and sums a token's k products in float32.

The MoE archs at ``reduced()`` in bf16 run with JAX's expert ids forced
in the port (``moe.routing_trace(forced=...)``): reduced moonshot's
least top-k margin in bf16 is ~1e-3 and smaller, so a near-tie choosing
another expert must not decide the test. Their float32 runs, with ids
equal and unforced, are in ``test_torch_lm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import lm, moe
from repro_torch.serve import lm_parity
from test_torch_lm import (MOE_ARCHS, S, _batch, _carry, _close_bf16, _j,
                           _prefill_decode, _t, jax_routes)

TOL = dict(rtol=1e-4, atol=1e-5)
B = 2


def _bf16(a: np.ndarray):
    """The same bf16 values in both packages."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.int16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _ff_inputs(seed, g=2, s=16, d=64, f=96, e=8, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, s, d)).astype(np.float32)
    router = np.zeros((d, e), np.float32) if tie else \
        (rng.standard_normal((d, e)) / 8).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, d, f)) / 8).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((e, f, d)) / 10).astype(np.float32)
    return x, router, wg, wu, wd


def _both_ff(inputs, k, factor, dtype=np.float32):
    """moe_ff on both packages (the router float32) -> (JAX's (out, aux,
    z) as numpy, the port's, the port's routing) and JAX's ids."""
    x, router, wg, wu, wd = inputs
    if dtype == np.float32:
        j = [jnp.asarray(a) for a in (x, wg, wu, wd)]
        t = [torch.from_numpy(a) for a in (x, wg, wu, wd)]
    else:
        j, t = zip(*(_bf16(a) for a in (x, wg, wu, wd)))
    jr, tr_w = jnp.asarray(router), torch.from_numpy(router)
    jout = jmoe.moe_ff(j[0], jr, *j[1:], top_k=k, cap_factor=factor)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", j[0], jr,
                                      preferred_element_type=jnp.float32))
    jids = np.asarray(jax.lax.top_k(probs, k)[1])
    with moe.routing_trace() as tr:
        out = moe.moe_ff(t[0], tr_w, *t[1:], top_k=k, cap_factor=factor)
    jout = [np.asarray(jnp.asarray(v, jnp.float32)) for v in jout]
    out = [v.float().numpy() for v in out]
    return jout, out, tr.calls[0], jids


# -- tests/test_model_core.py:117-173 on both packages -----------------------------
def test_route_respects_capacity_and_gates():
    rng = np.random.default_rng(0)
    g, s, e, k = 2, 16, 4, 2
    cap = moe.capacity(s, k, e, 1.0)
    assert cap == jmoe.capacity(s, k, e, 1.0)
    logits = rng.standard_normal((g, s, e)).astype(np.float32)
    jd, jc, jaux, jz = jmoe.route(jnp.asarray(logits), k, e, cap)
    dispatch, combine, aux, z = moe.route(torch.from_numpy(logits), k, e, cap)
    for d, c, a, zz in ((np.asarray(jd, np.float32), np.asarray(jc),
                         float(jaux), float(jz)),
                        (dispatch.float().numpy(), combine.numpy(),
                         float(aux), float(z))):
        assert d.sum(axis=1).max() <= 1.0 + 1e-6      # a slot, one token
        assert d.sum(axis=(2, 3)).max() <= k + 1e-6   # a token, k slots
        assert c.sum(axis=(2, 3)).max() <= 1.0 + 1e-5
        assert a > 0 and zz >= 0
    np.testing.assert_array_equal(dispatch.float().numpy(),
                                  np.asarray(jd, np.float32))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)


def test_moe_ff_no_drop_equals_dense_mixture():
    """With huge capacity, MoE out == the gate-weighted sum of the expert
    MLPs, on both packages."""
    rng = np.random.default_rng(1)
    g, s, d, f, e, k = 1, 6, 8, 16, 4, 2
    x = rng.standard_normal((g, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    wg, wu, wd = (rng.standard_normal(sh).astype(np.float32) * 0.1
                  for sh in ((e, d, f), (e, d, f), (e, f, d)))
    jout, _, _ = jmoe.moe_ff(*map(jnp.asarray, (x, router, wg, wu, wd)),
                             top_k=k, cap_factor=8.0)
    out, _, _ = moe.moe_ff(*map(torch.from_numpy, (x, router, wg, wu, wd)),
                           top_k=k, cap_factor=8.0)
    probs = torch.softmax(torch.from_numpy(x @ router), dim=-1)
    gv, idx = torch.topk(probs, k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = np.zeros((g, s, d), np.float32)
    for si in range(s):
        for kk in range(k):
            eid = int(idx[0, si, kk])
            xe = torch.from_numpy(x[0, si])
            h = torch.nn.functional.silu(xe @ wg[eid]) * (xe @ wu[eid])
            want[0, si] += float(gv[0, si, kk]) * (h @ wd[eid]).numpy()
    np.testing.assert_allclose(np.asarray(jout), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_moe_capacity_drops_tokens():
    """cap_factor -> tiny: overflowing tokens produce zero output, not
    junk; every token ties, and both packages keep the same early ones."""
    rng = np.random.default_rng(2)
    g, s, d, f, e = 1, 16, 4, 8, 2
    x = rng.standard_normal((g, s, d)).astype(np.float32)
    router = np.zeros((d, e), np.float32)
    w = [np.ones(sh, np.float32) * 0.1 for sh in ((e, d, f), (e, d, f),
                                                  (e, f, d))]
    jout, _, _ = jmoe.moe_ff(jnp.asarray(x), jnp.asarray(router),
                             *map(jnp.asarray, w), top_k=1, cap_factor=0.25)
    out, _, _ = moe.moe_ff(torch.from_numpy(x), torch.from_numpy(router),
                           *map(torch.from_numpy, w), top_k=1,
                           cap_factor=0.25)
    for o in (np.asarray(jout), out.numpy()):
        norms = np.linalg.norm(o[0], axis=-1)
        assert (norms[-4:] == 0).all()        # late tokens dropped
        assert (norms[:2] > 0).all()          # early tokens kept
    np.testing.assert_array_equal(out.numpy() == 0, np.asarray(jout) == 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


# -- route and moe_ff against the reference ------------------------------------------
@pytest.mark.parametrize("k,factor", [(2, 1.0), (2, 0.5), (3, 8.0),
                                      (1, 1.25), (3, 0.75)])
def test_route_matches_reference(k, factor):
    """Slot-major slots and drops: dispatch equal, combine within 1e-6,
    aux and z within rtol 1e-4; also on all-equal logits (every token
    ties, ids to the lower expert)."""
    rng = np.random.default_rng(10 + k)
    g, s, e = 2, 24, 8
    cap = moe.capacity(s, k, e, factor)
    for logits in (rng.standard_normal((g, s, e)).astype(np.float32),
                   np.zeros((g, s, e), np.float32)):
        jd, jc, jaux, jz = jmoe.route(jnp.asarray(logits), k, e, cap)
        d, c, aux, z = moe.route(torch.from_numpy(logits), k, e, cap)
        np.testing.assert_array_equal(d.float().numpy(),
                                      np.asarray(jd, np.float32))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose([float(aux), float(z)],
                                   [float(jaux), float(jz)], rtol=1e-4)


@pytest.mark.parametrize("case", ["no_drops", "drops", "tie_router"])
def test_moe_ff_matches_reference_float32(case):
    """float32: the port's expert ids equal JAX's top_k, the output within
    rtol 1e-4 / atol 1e-5, aux and z too; with a capacity that drops
    pairs, and on a router of zeros (every token ties: experts 0..k-1)."""
    factor = {"no_drops": 8.0, "drops": 1.0, "tie_router": 0.5}[case]
    jout, out, routed, jids = _both_ff(
        _ff_inputs(20, tie=case == "tie_router"), 3, factor)
    np.testing.assert_array_equal(routed.idx.numpy(), jids)
    assert routed.keep.all() == (case == "no_drops")
    if case == "tie_router":
        assert (jids == np.arange(3)).all()
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got, want, **TOL)


def _ulps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in bf16 steps (both bf16 values as float32): the distance
    of their bit patterns on a line ordered like the numbers."""
    def ordered(x):
        bits = (x.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("factor", [8.0, 1.0])
def test_moe_ff_bfloat16_matches_reference(factor):
    """bf16 inputs identical in both packages: expert ids equal, the
    output equal to JAX's but for at most 0.1% of elements, each one bf16
    ulp off."""
    jout, out, routed, jids = _both_ff(_ff_inputs(30), 3, factor,
                                       dtype=jnp.bfloat16)
    np.testing.assert_array_equal(routed.idx.numpy(), jids)
    apart = _ulps_apart(out[0], jout[0])
    assert apart.max() <= 1
    assert (apart > 0).mean() <= 1e-3


# -- the routing trace ----------------------------------------------------------------
def test_routing_trace_records_and_forces():
    """Outside the trace nothing is kept; inside, each call's ids and
    margin (k-th minus (k+1)-th probability); forced ids replace the
    top-k, with the call's own probabilities at them as gates; a call
    past the forced list raises."""
    x, router, wg, wu, wd = map(torch.from_numpy, _ff_inputs(40))
    args = (x, router, wg, wu, wd)
    base, _, _ = moe.moe_ff(*args, top_k=2, cap_factor=8.0)
    assert moe._TRACE.get() is None
    with moe.routing_trace() as tr:
        again, _, _ = moe.moe_ff(*args, top_k=2, cap_factor=8.0)
    assert torch.equal(again, base) and len(tr.calls) == 1
    probs = torch.softmax(x @ router, dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    torch.testing.assert_close(tr.calls[0].margin, top[..., 1] - top[..., 2])
    ids = tr.calls[0].idx
    flipped = ids.flip(-1)                # the same experts, slots swapped
    other = (ids + 1) % router.shape[1]
    with moe.routing_trace(forced=[ids, other]) as forced:
        same, _, _ = moe.moe_ff(*args, top_k=2, cap_factor=8.0)
        moved, _, _ = moe.moe_ff(*args, top_k=2, cap_factor=8.0)
        with pytest.raises(RuntimeError, match="forced"):
            moe.moe_ff(*args, top_k=2, cap_factor=8.0)
    assert torch.equal(same, base)
    assert torch.equal(forced.calls[1].idx, other)
    assert not torch.allclose(moved, base)
    # the forced call's output is the gate-weighted mixture at those ids
    with moe.routing_trace(forced=[flipped]):
        swapped, _, _ = moe.moe_ff(*args, top_k=2, cap_factor=8.0)
    torch.testing.assert_close(swapped, base, rtol=1e-6, atol=1e-6)


def test_route_flips_rule():
    """``lm_parity.route_flips``: equal ids pass; a flip under the margin
    counts once a sequence and bounds its compared positions (back to its
    call's start when that call dropped a pair of the sequence); a flip
    with a clear margin raises."""
    b, s, k = 3, 10, 2
    idx = torch.arange(b * s * k).reshape(b, s, k) % 7
    margin = torch.full((b, s), 0.5)

    def table(i, m, dropped=None):
        return [{"idx": i.clone(), "margin": m.clone(),
                 "dropped": torch.zeros((b, s), dtype=torch.bool)
                 if dropped is None else dropped}]
    spans = lm_parity.replay_spans(6, s)
    flips, first = lm_parity.route_flips(table(idx, margin),
                                         table(idx, margin), spans)
    assert flips == 0 and first.tolist() == [s] * b
    other = idx.clone()
    other[1, 8, 0] += 1                     # a decode step's call
    other[1, 9, 1] += 1                     # reached by the first: ignored
    other[2, 3, 1] += 1                     # inside the prefill's call
    close = margin.clone()
    close[1, 8] = close[2, 3] = 1e-6
    flips, first = lm_parity.route_flips(table(idx, close),
                                         table(other, close), spans)
    assert flips == 2 and first.tolist() == [s, 8, 3]
    dropped = torch.zeros((b, s), dtype=torch.bool)
    dropped[2, :6] = True
    flips, first = lm_parity.route_flips(table(idx, close, dropped),
                                         table(other, close), spans)
    assert flips == 2 and first.tolist() == [s, 8, 0]
    with pytest.raises(AssertionError, match="not under"):
        lm_parity.route_flips(table(idx, margin), table(other, margin),
                              spans)


# -- full-size parameters ---------------------------------------------------------------
@pytest.mark.parametrize("arch,layers,nbytes", [
    ("moonshot-v1-16b-a3b", None, 56_959_045_632),
    ("llama4-maverick-400b-a17b", 2, 37_111_777_280),
    ("llama4-maverick-400b-a17b", None, 795_419_289_600)])
def test_moe_param_specs_full_size(arch, layers, nbytes):
    """``param_specs`` on ``meta``: the bytes the reference's
    ``param_specs`` gives (``chip_smoke.py`` draws the first two on one
    card), every router float32 in the bf16 model."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
    specs = lm.param_specs(cfg)
    leaves = jax.tree_util.tree_leaves(jlm.param_specs(jcfg))
    got = sum(t.numel() * t.element_size()
              for t in torch.utils._pytree.tree_leaves(specs))
    assert got == nbytes == sum(int(np.prod(x.shape)) * x.dtype.itemsize
                                for x in leaves)
    routers = [p["router"] for p in specs["blocks"] if "router" in p]
    assert routers and all(r.dtype == torch.float32 and r.device.type ==
                           "meta" for r in routers)
    assert specs["embed"].dtype == torch.bfloat16


def test_bf16_router_carries_float32():
    """A bf16 reference's router stays float32 through
    ``params_from_reference`` and the port's own init, bits unchanged."""
    jcfg = dataclasses.replace(jreduced(jget_config("moonshot-v1-16b-a3b")),
                               dtype="bfloat16")
    jparams = jax.tree.map(np.asarray,
                           jlm.init_params(jcfg, jax.random.PRNGKey(3)))
    params = lm.params_from_reference(jparams, device="cpu")
    blk, jblk = params["blocks"][0], jparams["blocks"][0]
    assert blk["router"].dtype == torch.float32
    assert blk["we_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(blk["router"].numpy(), jblk["router"])
    cfg = dataclasses.replace(reduced(get_config("moonshot-v1-16b-a3b")),
                              dtype="bfloat16")
    own = lm.init_params(cfg, 0, device="cpu")["blocks"][0]
    assert own["router"].dtype == torch.float32
    assert own["shared"]["wg"].dtype == torch.bfloat16


# -- the MoE archs in bf16, JAX's expert ids forced ---------------------------------
@pytest.fixture(scope="module")
def bf16_moe():
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bfloat16_moe_forward_forced(arch, bf16_moe, monkeypatch):
    """The forward's logits with JAX's expert ids forced, held by
    ``_close_bf16``; aux and z within 2**-7 (two bf16 steps)."""
    jcfg, cfg, jparams, params = bf16_moe(arch)
    batch = _batch(cfg, np.random.default_rng(5))
    with jax_routes(monkeypatch) as ids:
        jlogits, (jaux, jz), _ = jlm.forward(jcfg, jparams, _j(batch))
    with moe.routing_trace(forced=ids) as tr:
        logits, (aux, z), _ = lm.forward(cfg, params, _t(batch))
    assert len(tr.calls) == len(ids) == cfg.n_moe_layers
    _close_bf16(logits, jlogits, cfg.vocab)
    np.testing.assert_allclose([float(aux), float(z)],
                               [float(jaux), float(jz)], rtol=2 ** -7)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("max_len", [S, 2048])
def test_bfloat16_moe_prefill_decode_forced(arch, max_len, bf16_moe,
                                            monkeypatch):
    """bf16 prefill (the flash path at max_len 2,048) and a decode step,
    JAX's ids forced call by call, each held by ``_close_bf16``."""
    jcfg, cfg, jparams, params = bf16_moe(arch)
    batch = _batch(cfg, np.random.default_rng(6))
    with jax_routes(monkeypatch) as ids:
        jpre, jstep, jpos = _prefill_decode(jcfg, jparams, batch, max_len,
                                            False)
    with moe.routing_trace(forced=ids):
        pre, step, pos = _prefill_decode(cfg, params, batch, max_len, True)
    assert pos == jpos == S
    _close_bf16(pre, jpre, cfg.vocab)
    _close_bf16(step, jstep, cfg.vocab)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bfloat16_moe_multi_step_decode_forced(arch, bf16_moe, monkeypatch):
    """Four decode steps on each package, JAX's greedy token fed to both
    and its ids forced; each step's logits by ``_close_bf16``."""
    jcfg, cfg, jparams, params = bf16_moe(arch)
    rng = np.random.default_rng(4)
    state = lm.init_serve_state(cfg, B, max_len=S, device="cpu")
    jstate = jlm.init_serve_state(jcfg, B, max_len=S)
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    for _ in range(4):
        with jax_routes(monkeypatch) as ids:
            jlogits, jstate = jlm.decode_step(jcfg, jparams, jstate,
                                              jnp.asarray(tok))
        with moe.routing_trace(forced=ids):
            logits, state = lm.decode_step(cfg, params, state,
                                           torch.from_numpy(tok))
        _close_bf16(logits, jlogits, cfg.vocab)
        tok = np.asarray(jnp.argmax(jlogits[..., :cfg.vocab], axis=-1)
                         .astype(jnp.int32))


def test_forced_replay_maps_forward_ids_by_position():
    """``lm_parity.forced_routes``: the forward's ids over a sequence, cut
    to a replay's calls (the prefill, then a decode step a position),
    route the replay exactly as it routes itself (reduced float32, no
    drops), and its logits are unchanged."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    params = lm.init_params(cfg, 0, device="cpu")
    seq = np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    plen, s = 5, seq.shape[1] - 1
    with moe.routing_trace() as ftr:
        lm.forward(cfg, params, {"tokens": torch.from_numpy(seq[:, :s])})
    table = lm_parity.routing_table(ftr.calls, cfg.n_moe_layers)
    spans = lm_parity.replay_spans(plen, s)
    with moe.routing_trace() as own:
        free, _, _, _ = lm_parity.replay(cfg, params, seq, plen, 16, "cpu")
    forced_ids = lm_parity.forced_routes(table, spans)
    assert len(forced_ids) == len(own.calls) == \
        len(spans) * cfg.n_moe_layers
    for want, call in zip(forced_ids, own.calls):
        assert torch.equal(call.idx, want)
    with moe.routing_trace(forced=forced_ids):
        forced, _, _, _ = lm_parity.replay(cfg, params, seq, plen, 16,
                                           "cpu")
    assert torch.equal(forced, free)
