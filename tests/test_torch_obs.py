"""``repro_torch.obs``: the program's profiler ranges and host-read counts
on the LM path, on the CPU.

With no profiler recording, nothing opens a profiler range;
under ``torch.profiler`` a served batch and a training step give exactly
the ranges their calls make (the engine decodes once for each new token,
the last one included); ``obs.counts()`` counts the host reads whether a
profiler records or not; and tokens, losses and gradients are bit for bit
the same with the profiler on and off.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.trainer import loss_and_grads

CFG = reduced(get_config("glm4-9b"))
L = CFG.n_layers
B, PLEN, NEW = 2, 8, 3
SEQ = 2048                      # past the flash path's 1,024-key chunk


def _params(cfg=CFG):
    return lm.init_params(cfg, 0, device="cpu")


def _serve(params):
    eng = ServeEngine(CFG, params, batch_size=B, max_len=PLEN + NEW,
                      device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, CFG.vocab, PLEN).astype(np.int32),
                    max_new_tokens=NEW) for _ in range(B)]
    return [r.out_tokens for r in eng.run_batch(reqs)]


def _train_batch(seq=SEQ):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, CFG.vocab, (1, seq + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train(params, cfg=CFG, seq=SEQ):
    loss, _, grads = loss_and_grads(cfg, params, _train_batch(seq))
    return loss, grads


def _ranges(prof) -> dict:
    """{name without the prefix: [(start_ns, end_ns), ...]} of the
    program's ranges in the profiler's trace. None is a user-scope range,
    which the profiler would copy onto the device's timeline."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(obs.PREFIX):
            assert not e.is_user_annotation(), e.name()
            out.setdefault(e.name()[len(obs.PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
    return out


@pytest.fixture(scope="module")
def served():
    """The profiled batch's ranges, the counts it left and its tokens."""
    params = _params()
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tokens = _serve(params)
    return _ranges(prof), obs.counts(), tokens, params


@pytest.mark.parametrize("what", ["serve", "train"])
def test_no_range_opens_without_a_profiler(monkeypatch, what):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(obs, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not obs.recording()
    params = _params()
    if what == "serve":
        assert all(len(t) == NEW for t in _serve(params))
    else:
        loss, _ = _train(params, seq=64)
        assert torch.isfinite(loss)


@pytest.mark.parametrize("name,want", [
    ("engine.prefill", 1),
    ("engine.decode_step", NEW),
    ("host_read.engine_tokens", NEW),
    ("host_read.embed_ids", NEW + 1),            # one a forward
    ("attn.direct", L * (NEW + 1)),              # a layer a forward
    ("lm.head", NEW + 1),
])
def test_a_served_batch_gives_its_ranges(served, name, want):
    ranges, _, _, _ = served
    assert len(ranges.get(name, [])) == want
    assert "attn.flash" not in ranges and "attn.flash_bwd" not in ranges


def test_decode_steps_hold_one_host_read_each(served):
    """The embedding's id check lies inside each decode step; the engine's
    read of the step's tokens lies outside every one."""
    ranges, _, _, _ = served
    steps = ranges["engine.decode_step"]

    def inside(r):
        return any(a <= r[0] <= b for a, b in steps)

    assert sum(map(inside, ranges["host_read.embed_ids"])) == NEW
    assert not any(map(inside, ranges["host_read.engine_tokens"]))


def test_counts_equal_the_read_ranges(served):
    ranges, counts, _, _ = served
    assert counts == {"engine_tokens": NEW, "embed_ids": NEW + 1}
    assert counts == {site: len(ranges["host_read." + site])
                      for site in counts}


def test_counts_run_without_a_profiler_and_reset():
    params = _params()
    obs.reset()
    assert obs.counts() == {}
    _serve(params)
    assert obs.counts() == {"engine_tokens": NEW, "embed_ids": NEW + 1}
    obs.reset()
    assert obs.counts() == {}


def test_tokens_are_the_same_with_the_profiler_off(served):
    _, _, tokens, params = served
    assert _serve(params) == tokens


@pytest.mark.parametrize("remat,forwards", [("layer", 2), ("none", 1)])
def test_a_train_step_past_the_chunk_gives_flash_ranges(remat, forwards):
    """Remat "layer" runs each layer's forward again in the backward, so
    the flash forward twice a layer; its backward once a layer."""
    cfg = dataclasses.replace(CFG, remat=remat)
    params = _params(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(params, cfg)
    ranges = _ranges(prof)
    assert len(ranges.get("attn.flash", [])) == forwards * L
    assert len(ranges.get("attn.flash_bwd", [])) == L
    assert "attn.direct" not in ranges and "lm.head" not in ranges


def test_loss_and_gradients_are_the_same_with_the_profiler_on():
    """On one thread: the CPU's threaded reductions alone reorder sums
    between two runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = _params()
        off_loss, off_grads = _train(params)
        with profile(activities=[ProfilerActivity.CPU]):
            on_loss, on_grads = _train(params)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(on_loss, off_loss)
    flat_on = torch.utils._pytree.tree_leaves(on_grads)
    flat_off = torch.utils._pytree.tree_leaves(off_grads)
    assert len(flat_on) == len(flat_off) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat_on, flat_off))
