"""The check must fail what it exists to catch, judged by each cell's own
limits (``perfbench/limits/``), on the CPU at widths a test run holds:

- the control: the reference put in the program's place with its products
  in float8 e4m3, the precision below the configurations' bf16;
- a whole run of the harness, past its look for a card, with the
  program's timed path broken underneath: a step that leaves its state
  unchanged, half of the batch left out (the mean taken over the rest),
  and a token or an answer altered where it is produced. (Every cell is on
  one chip: there is no exchange between chips to leave out.)
"""
from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import ROOT, make_tiny_root
from perfbench import check, harness, spec

CPU = torch.device("cpu")
TRAIN = "minicpm-2b.train.s2048"
SERVE = ["glm4-9b.serve.azure-code"]
# sizes at which the control reads, on the CPU, as it does on the card at
# full width (its float8 rounding grows with width and depth, and a widest
# gap with the tokens compared): bf16, as the configurations state
CONTROL_SIZES = {
    TRAIN: (dict(n_layers=4, d_model=256, d_head=64, d_ff=704, vocab=4099,
                 dtype="bfloat16"), {"corpus_tokens": 200_000}),
    SERVE[0]: (dict(n_layers=8, d_model=512, n_heads=8, d_head=64, d_ff=1408,
                    vocab=8191, dtype="bfloat16"),
               {"batch": 8, "prompt_len": 1100, "new_tokens": 32,
                "max_len": 2048, "checked_requests": 16}),
}
# a serving fault reaches the served tokens through attention, which
# random weights keep near uniform, each layer adding a few per cent: it
# takes eight layers for a broken cache to show (the cells run 40)
FAULT_SIZES = {
    TRAIN: ({}, {}),
    SERVE[0]: (dict(n_layers=8, d_model=256, d_head=64, d_ff=704),
               {"batch": 4, "prompt_len": 1100, "new_tokens": 16,
                "max_len": 2048, "checked_requests": 8}),
}


def _limits(workload: str) -> dict:
    return json.loads((ROOT / "perfbench/limits" /
                       f"{workload}.json").read_text())


@pytest.mark.parametrize("workload", [TRAIN] + SERVE)
def test_the_control_fails(tmp_path, workload):
    model, mix = CONTROL_SIZES[workload]
    cell = spec.Cell(ROOT, workload)
    root = make_tiny_root(tmp_path, {cell.entry["traffic"]: mix}, **model)
    cell = spec.Cell(root, workload)
    run = cell.driver.run(cell, 2147483901, 0.0, False, CPU,
                          time.perf_counter())
    _, ref = cell.driver.readings(run)
    ctrl = cell.driver.control(run, ref)
    assert not check.judge(ctrl, _limits(workload))[0], ctrl


def _frozen(cfg, grads, state, params, lr, stats=None):
    if stats is not None:
        stats["grad_norm"] = torch.zeros(())
    return params, state


def _half_batch_loss(train_loss):
    def half(cfg, params, batch):
        n = batch["tokens"].shape[0] // 2
        return train_loss(cfg, params, {k: v[:n] for k, v in batch.items()})
    return half


def _labels_off_by_one(token_batches):
    def altered(store, cfg, **kw):
        for b in token_batches(store, cfg, **kw):
            yield dict(b, labels=(b["labels"] + 1) % cfg.vocab)
    return altered


def _train_fault(monkeypatch, fault: str) -> None:
    import repro_torch.data
    from repro_torch.models import lm
    from repro_torch.train import trainer
    if fault == "state_unchanged":
        monkeypatch.setattr(trainer, "apply_updates", _frozen)
    elif fault == "half_batch":
        monkeypatch.setattr(lm, "train_loss", _half_batch_loss(lm.train_loss))
    else:
        monkeypatch.setattr(repro_torch.data, "token_batches",
                            _labels_off_by_one(repro_torch.data.token_batches))


def _serve_fault(monkeypatch, fault: str) -> None:
    from repro_torch.models import blocks, lm
    from repro_torch.serve.engine import ServeEngine
    if fault == "state_unchanged":
        monkeypatch.setattr(blocks, "_write_cache", lambda *a, **k: None)
    elif fault == "half_batch":
        step = lm.decode_step

        def half(cfg, params, state, tokens):
            logits, state = step(cfg, params, state, tokens)
            n = logits.shape[0] // 2
            logits = logits.clone()
            logits[n:2 * n] = logits[:n]
            return logits, state
        monkeypatch.setattr(lm, "decode_step", half)
    else:
        sample = ServeEngine._sample

        def altered(self, logits):
            return (sample(self, logits) + 1) % self.cfg.vocab
        monkeypatch.setattr(ServeEngine, "_sample", altered)


FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", [TRAIN] + SERVE)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch,
                                            workload, fault):
    model, mix = FAULT_SIZES[workload]
    traffic = spec.Cell(ROOT, workload).entry["traffic"]
    root = make_tiny_root(tmp_path, {traffic: mix}, **model)
    (_train_fault if workload == TRAIN else _serve_fault)(monkeypatch, fault)
    result, log = harness.run_cell(root, workload, 2147483902, 0.0, False,
                                   CPU, time.perf_counter())
    assert result["correct"] is False, log


@pytest.mark.parametrize("workload", [TRAIN] + SERVE)
def test_a_sound_run_is_correct(tiny_root, workload):
    result, log = harness.run_cell(tiny_root, workload, 2147483903, 0.0,
                                   False, CPU, time.perf_counter())
    assert result["correct"] is True, log
