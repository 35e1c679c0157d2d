"""Port parity, the Trainer: ``repro_torch.train.trainer`` and
``repro_torch.launch.train`` on the CPU.

The four tests of ``tests/test_trainer_integration.py`` run on the port
(the reference's initial parameters carried over, the port's own loader):
loss descent, checkpoint and resume with the restart in the fault log, the
WSD schedule, AdamW8 through the loop. Then the port's train step against
the reference's ``make_train_step`` step by step: at each of 8 steps, from
the reference's parameters and state, the loss, the metrics and every
gradient (rtol 1e-4 / atol 1e-5 std), the port's update from the
reference's gradients (rtol 1e-6 / atol 1e-7: Adafactor's means and
its update's RMS sum in another order) and the metrics of the
port's whole step.
Last, the launcher at ``--preset smoke`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import TokenStore as JTokenStore
from repro.data import synthetic_corpus as jsynthetic_corpus
from repro.data import token_batches as jtoken_batches
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, reduced
from repro_torch.data import TokenStore, synthetic_corpus, token_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.train import checkpoint as ck
from repro_torch.train import parity
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         opt_state_from_reference,
                                         opt_state_to_numpy)
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step


def _setup(arch="qwen2-7b", vocab=512, key=0):
    cfg = dataclasses.replace(reduced(get_config(arch)), vocab=vocab,
                              vocab_pad_multiple=64)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), vocab=vocab,
                               vocab_pad_multiple=64)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(key))
    params = lm.params_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    store = TokenStore(synthetic_corpus(60_000, cfg.vocab), cfg.vocab)
    return cfg, params, store, jcfg, jparams


def _data(store, cfg, **kw):
    return token_batches(store, cfg, device="cpu", **kw)


def test_trainer_descends_and_checkpoints(tmp_path):
    cfg, params, store, *_ = _setup()
    trainer = Trainer(
        cfg=cfg, opt=OptConfig(lr=3e-2),
        train=TrainConfig(steps=24, warmup=2, log_every=4, ckpt_every=8,
                          ckpt_dir=str(tmp_path), donate=False))
    data = _data(store, cfg, batch=8, seq=16)
    params, history = trainer.fit(params, data)
    assert history[-1]["loss"] < history[0]["loss"] - 0.4
    assert ck.latest_steps(str(tmp_path))[-1] == 24


def test_trainer_resume_after_interrupt(tmp_path):
    """Phase 1 runs 16/32 steps; phase 2 resumes from the checkpoint and the
    restart is recorded in the fault log — the node-failure recovery path."""
    cfg, params, store, *_ = _setup()
    opt = OptConfig(lr=1e-2)
    t1 = Trainer(cfg=cfg, opt=opt,
                 train=TrainConfig(steps=16, warmup=2, log_every=4,
                                   ckpt_every=8, ckpt_dir=str(tmp_path),
                                   donate=False))
    _, hist1 = t1.fit(params, _data(store, cfg, batch=8, seq=16))
    assert ck.latest_steps(str(tmp_path))[-1] == 16
    # 'crash' + new process: fresh params, resume pulls step-16 state
    _, fresh, *_ = _setup(key=99)
    t2 = Trainer(cfg=cfg, opt=opt,
                 train=TrainConfig(steps=32, warmup=2, log_every=4,
                                   ckpt_every=8, ckpt_dir=str(tmp_path),
                                   donate=False))
    data2 = _data(store, cfg, batch=8, seq=16, start_step=16)
    _, hist2 = t2.fit(fresh, data2)
    assert t2.fault_log.summary().get("restart") == 1
    assert hist2[0]["loss"] < hist1[0]["loss"]
    assert hist2[0]["step"] == 16


def test_trainer_wsd_schedule_applied():
    cfg, params, store, *_ = _setup()
    trainer = Trainer(cfg=cfg, opt=OptConfig(lr=1e-2),
                      train=TrainConfig(steps=10, warmup=2, schedule="wsd",
                                        log_every=1, ckpt_every=0,
                                        donate=False))
    _, history = trainer.fit(params, _data(store, cfg, batch=4, seq=16))
    lrs = [h["lr"] for h in history]
    assert lrs[0] == 0.0                       # warmup start
    assert abs(lrs[5] - 1e-2) < 1e-9           # stable phase at peak
    assert lrs[-1] < 1e-2                      # decay tail


def test_trainer_adamw8_path():
    """Quantized-state optimizer trains through the full Trainer loop."""
    cfg, params, store, *_ = _setup()
    trainer = Trainer(cfg=cfg, opt=OptConfig(name="adamw8", lr=3e-2),
                      train=TrainConfig(steps=16, warmup=2, log_every=4,
                                        ckpt_every=0, donate=False))
    _, history = trainer.fit(params, _data(store, cfg, batch=8, seq=16))
    assert history[-1]["loss"] < history[0]["loss"] - 0.3
    assert trainer.opt_state["step"] == 16


def test_trainer_refuses_a_mesh():
    """A mesh runs (tests/test_torch_distributed.py); what is not a
    DeviceMesh with named axes is refused before a step."""
    cfg, params, store, *_ = _setup()
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg=cfg, opt=OptConfig(), train=TrainConfig(steps=1),
                mesh=object()).fit(params, _data(store, cfg, batch=2,
                                                 seq=8))


def _close_tree(port, ref, **tol):
    flat_p = jax.tree_util.tree_flatten_with_path(port)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_train_step_matches_reference_step_by_step(opt_name):
    cfg, _, _, jcfg, jparams = _setup()
    jopt_cfg = jopt.OptConfig(name=opt_name, lr=1e-2)
    opt = OptConfig(name=opt_name, lr=1e-2)
    jtrain = jtrainer.TrainConfig(steps=8, warmup=2, schedule="wsd",
                                  donate=False)
    train = TrainConfig(steps=8, warmup=2, schedule="wsd", donate=False)
    jstep, _ = jtrainer.make_train_step(jcfg, jopt_cfg, jtrain)
    step_fn, _ = make_train_step(cfg, opt, train)
    jstore = JTokenStore(jsynthetic_corpus(60_000, cfg.vocab), cfg.vocab)
    jdata = jtoken_batches(jstore, jcfg, batch=4, seq=16)
    jstate = jopt.init_opt_state(jopt_cfg, jparams)
    for step in range(8):
        jbatch = next(jdata)
        batch = {k: torch.from_numpy(np.array(v)) for k, v in
                 jbatch.items()}
        np_params = jax.tree.map(np.asarray, jparams)
        np_state = jax.tree.map(np.asarray, jstate)
        # the reference's gradients, its update from them, and its step
        (jl, jm), jg = jax.value_and_grad(
            lambda p: jlm.train_loss(jcfg, p, jbatch), has_aux=True)(jparams)
        lr = jtrainer.SCHEDULES["wsd"](step, peak_lr=1e-2, warmup=2,
                                       total=8)
        ref_update = jax.tree.map(np.asarray, jopt.apply_updates(
            jopt_cfg, jg, jstate, jparams, lr))
        jparams, jstate, jmetrics = jstep(jparams, jstate, jbatch,
                                          jnp.asarray(step, jnp.int32))
        # the port's loss and gradients from the reference's parameters
        params = lm.params_from_reference(np_params, "cpu")
        loss, metrics, grads = parity.loss_and_grads(cfg, params, batch)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                                   rtol=1e-5)
        want = dict(parity._paths(lm.params_from_reference(
            jax.tree.map(np.asarray, jg), "cpu")))
        for path, g in parity._paths(grads):
            std = float(want[path].double().std(correction=0))
            np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                       rtol=1e-4, atol=1e-5 * std,
                                       err_msg=f"step {step} {path}")
        # the port's update from the reference's gradients and state
        p2, s2 = apply_updates(
            opt, lm.params_from_reference(jax.tree.map(np.asarray, jg),
                                          "cpu"),
            opt_state_from_reference(np_state, "cpu"),
            lm.params_from_reference(np_params, "cpu"),
            torch.from_numpy(np.array(jmetrics["lr"])))
        _close_tree((lm.params_to_numpy(p2), opt_state_to_numpy(s2)),
                    ref_update, rtol=1e-6, atol=1e-7)
        # the port's whole step from the reference's parameters and state:
        # its metrics (its update is the one above from its own gradients;
        # Adam turns the round-off of a gradient that is zero in exact
        # arithmetic, the key bias's under softmax's shift invariance, into
        # a full-size step, so the two parameter sets are not compared)
        _, s3, m3 = step_fn(lm.params_from_reference(np_params, "cpu"),
                            opt_state_from_reference(np_state, "cpu"),
                            batch, step)
        assert s3["step"] == step + 1
        assert m3["lr"].numpy() == np.asarray(jmetrics["lr"])
        for k in ("loss", "ce", "tokens"):
            np.testing.assert_allclose(float(m3[k]), float(jmetrics[k]),
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(m3["grad_norm"]),
                                   float(jopt.global_norm(jg)), rtol=1e-5)


def test_launcher_smoke_on_cpu(capsys):
    history = launch_train.main(["--arch", "qwen2-7b", "--preset", "smoke",
                                 "--steps", "8", "--batch", "4", "--seq",
                                 "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out and "trained 8 steps" in out
    assert history[-1]["loss"] < history[0]["loss"]
