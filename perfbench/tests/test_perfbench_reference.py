"""The plain reference against the port at tiny widths of both
configurations, in float32 on the CPU: forward logits, prefill then decode
through the cache, the loss, every gradient, and the AdamW steps of the
training job. The reference imports nothing of the port; these tests hold
the two to the same numbers."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_model
from perfbench import weights
from perfbench.reference import dense

CPU = torch.device("cpu")
CONFIGS = ["glm4-9b", "minicpm-2b"]


def _cfg(model):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**model)


def _close(got, want, rtol=1e-4, atol=1e-5):
    scale = float(want.std()) or 1.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_logits(config):
    from repro_torch.models import lm
    model = tiny_model(config, dtype="float32")
    params = weights.make(dense, model, 11, CPU)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, model["vocab"], (3, 24)))
    got, _, _ = lm.forward(_cfg(model), params, {"tokens": tokens})
    want = dense.logits_at(model, params, tokens, torch.arange(24))
    _close(got[..., :model["vocab"]], want)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("plen,max_len", [(9, 16), (1030, 2048),
                                          (1500, 2048)])
def test_prefill_then_decode(config, plen, max_len):
    """The engine's prefill and decode steps through the cache (the flash
    prefill past 1,024 keys too) against the reference's full forward
    over the same tokens."""
    from repro_torch.models import lm
    model = tiny_model(config, dtype="float32")
    cfg = _cfg(model)
    params = weights.make(dense, model, 12, CPU)
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, model["vocab"], (2, plen + 4)))
    state = lm.init_serve_state(cfg, 2, max_len, device=CPU)
    logits, state = lm.prefill(cfg, params, state, {"tokens": seq[:, :plen]})
    got = [logits[:, -1]]
    for i in range(plen, seq.shape[1] - 1):
        logits, state = lm.decode_step(cfg, params, state, seq[:, i:i + 1])
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)[..., :model["vocab"]]
    want = dense.logits_at(model, params, seq[:, :-1],
                           torch.arange(plen - 1, seq.shape[1] - 1))
    _close(got, want)


@pytest.mark.parametrize("config", CONFIGS)
def test_loss_and_gradients(config):
    from repro_torch.train.trainer import loss_and_grads
    model = tiny_model(config, dtype="float32")
    params = weights.make(dense, model, 13, CPU)
    corpus = np.random.default_rng(2).integers(0, model["vocab"], 5_000)
    (tokens, labels), = dense.loader_batches(corpus, 5, [0], 2, 2048, CPU)
    loss, _, grads = loss_and_grads(_cfg(model), params, {
        "tokens": tokens.int(), "labels": labels.int()})
    ref_loss, ref_grads = dense.loss_and_grads(model, params, tokens, labels)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    want = dense.leaves(ref_grads)
    for name, g in dense.leaves(grads).items():
        _close(g, want[name], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("config", CONFIGS)
def test_adamw_steps(config):
    """Three steps of the training job (WSD warm-up, clipping, weight
    decay) from the port's step function and from the reference: each
    step's loss and the parameters after the three."""
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    model = tiny_model(config, dtype="float32")
    job = json.loads((ROOT / "perfbench/traffic/train.s2048.json")
                     .read_text())
    params = weights.make(dense, model, 14, CPU)
    corpus = np.random.default_rng(3).integers(0, model["vocab"], 20_000)
    batches = dense.loader_batches(corpus, 6, range(3), 2, 64, CPU)
    ref = dense.adamw_steps(model, job, params, batches)
    opt = OptConfig(name="adamw", lr=job["lr"], b1=job["b1"], b2=job["b2"],
                    eps=job["eps"], weight_decay=job["weight_decay"],
                    clip_norm=job["clip_norm"])
    step_fn, _ = make_train_step(_cfg(model), opt, TrainConfig(
        steps=job["total_steps"], warmup=job["warmup"],
        schedule=job["schedule"]))
    p = {k: v.clone() for k, v in dense.leaves(params).items()}
    state = init_opt_state(opt, params)
    losses = []
    for k, (tokens, labels) in enumerate(batches):
        params, state, met = step_fn(params, state, {
            "tokens": tokens.int(), "labels": labels.int()}, k)
        losses.append(float(met["loss"]))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for name, t in dense.leaves(params).items():
        assert float((t - p[name]).norm()) == pytest.approx(
            ref["change_norms"][name], rel=1e-3, abs=1e-9)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; "
            "import perfbench.reference.dense; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    names = set(eval(out))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
