"""Port parity, the training loss: ``repro_torch.models.lm.train_loss`` and
its gradients against ``jax.value_and_grad(repro.models.lm.train_loss)`` on
the CPU.

For every arch of ``configs.ARCH_IDS`` at ``reduced()`` in float32
(mirroring ``tests/test_arch_smoke.py:59-74``: MoE's aux and z losses,
audio frames, vlm patches, the recurrent blocks), the reference's
parameters are carried into the port and the same seeded numpy batch goes
through both: the loss and the metrics within rtol 1e-5, each gradient leaf
within rtol 1e-4 and atol 1e-5 x that leaf's std (``train.parity``'s
per-arch atol where a family's noise floor is above it: two float32
implementations sum in another order). Then ``chunked_ce`` at
``loss_chunk`` 8 against the reference's and against the unchunked loss,
and remat ``"layer"`` and ``"dots"`` against ``"none"``: the same loss and
gradients, and fewer saved bytes.
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
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import lm
from repro_torch.train import parity

S, B = 8, 2
LOSS_RTOL = 1e-5


def _cfgs(arch, **kw):
    return (dataclasses.replace(reduced(get_config(arch)), **kw),
            dataclasses.replace(jreduced(jget_config(arch)), **kw))


def _batch(cfg, seed, s=S):
    return parity.train_batch(cfg, np.random.default_rng(seed), B, s)


def _ref(jcfg, jparams, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, {k: jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True)(jparams)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        dict(parity._paths(lm.params_from_reference(
            jax.tree.map(np.asarray, grads), device="cpu")))


def _port(cfg, params, batch):
    loss, metrics, grads = parity.loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        dict(parity._paths(grads))


def _assert_grads(got, want, atol_std, rtol=1e-4):
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        std = float(w.double().std(correction=0))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=atol_std * std, err_msg=path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_reference(arch):
    cfg, jcfg = _cfgs(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm.params_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    batch = _batch(cfg, 2)
    loss, metrics, grads = _port(cfg, params, batch)
    jloss, jmetrics, jgrads = _ref(jcfg, jparams, batch)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert metrics.keys() == jmetrics.keys() == {"ce", "aux", "z", "tokens"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    if cfg.family == "moe":
        assert metrics["aux"] > 0 and metrics["z"] > 0
    assert metrics["tokens"] == B * S - 1
    _assert_grads(grads, jgrads, parity.ATOL_BY_ARCH.get(arch, parity.ATOL))
    assert float(grads["/embed"].abs().max()) > 0


def test_chunked_ce_matches_reference_and_unchunked():
    """loss_chunk 8 over S 16: two checkpointed chunks, against the
    reference's chunked loss and the port's own unchunked one."""
    cfg, jcfg = _cfgs("glm4-9b", loss_chunk=8)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    params = lm.params_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    batch = _batch(cfg, 3, s=16)
    loss, metrics, grads = _port(cfg, params, batch)
    jloss, _, jgrads = _ref(jcfg, jparams, batch)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    _assert_grads(grads, jgrads, parity.ATOL)
    whole, wmetrics, wgrads = _port(dataclasses.replace(cfg, loss_chunk=0),
                                    params, batch)
    np.testing.assert_allclose(loss, whole, rtol=LOSS_RTOL)
    assert metrics["tokens"] == wmetrics["tokens"] == 2 * 16 - 1
    _assert_grads(grads, wgrads, parity.ATOL)


def test_chunked_ce_direct():
    """chunked_ce's (loss_sum, count) against the reference's on the same
    x_final and tied head, and its gradients against the unchunked sum's."""
    cfg, jcfg = _cfgs("minicpm-2b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.d_model, cfg.padded_vocab)).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels[1, :5] = -1
    js, jn = jlm.chunked_ce(jcfg, jnp.asarray(x), jnp.asarray(head),
                            jnp.asarray(labels), 8)
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(head).requires_grad_()
    ts, tn = lm.chunked_ce(cfg, xt, ht, torch.from_numpy(labels), 8)
    assert int(tn) == int(jn) == 2 * 24 - 5
    np.testing.assert_allclose(float(ts.detach()), float(js), rtol=1e-6)
    got = torch.autograd.grad(ts, [xt, ht])
    xu = torch.from_numpy(x).requires_grad_()
    hu = torch.from_numpy(head).requires_grad_()
    us, _ = lm._ce_terms(cfg, lm._mask_pad_vocab(cfg, (xu @ hu).float()),
                         torch.from_numpy(labels))
    want = torch.autograd.grad(us, [xu, hu])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # the pad columns of the vocabulary get no gradient
    assert not got[1][:, cfg.vocab:].any()


def _held_bytes(cfg, params, batch) -> tuple:
    """One train step, and the bytes its forward leaves allocated for the
    backward (the profiler's allocations less frees over the forward:
    autograd's saved tensors and a selective checkpoint's kept outputs
    alike)."""
    from torch.utils import _pytree as pytree
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU],
                                profile_memory=True) as prof:
        loss, metrics = lm.train_loss(cfg, params, tb)
    held = sum(e.self_cpu_memory_usage for e in prof.events())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    for p in leaves:
        p.requires_grad_(False)
    out = (float(loss.detach()), {k: float(v.detach()) for k, v in
                                  metrics.items()},
           dict(parity._paths(pytree.tree_unflatten(
               grads, pytree.tree_structure(params)))))
    return out, held


@pytest.mark.parametrize("arch", ["glm4-9b", "moonshot-v1-16b-a3b",
                                  "hymba-1.5b"])
def test_remat_matches_none_and_saves_less(arch):
    """"layer" keeps each group's input, "dots" also its products without
    batch dimensions; both recompute the rest in the backward."""
    cfg, _ = _cfgs(arch, remat="none")
    params = lm.init_params(cfg, 7, device="cpu")
    batch = _batch(cfg, 4, s=16)
    (loss, metrics, grads), none_b = _held_bytes(cfg, params, batch)
    held = {}
    for mode in ("layer", "dots"):
        (rl, rm, rg), held[mode] = _held_bytes(
            dataclasses.replace(cfg, remat=mode), params, batch)
        assert rl == loss and rm == metrics, mode
        _assert_grads(rg, grads, 0.0, rtol=1e-6)
    assert 0 < held["layer"] < held["dots"] < none_b, (held, none_b)
