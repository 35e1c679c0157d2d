"""The ``train`` kind: a training job. Set-up makes the weights from the
seed, the job's ``TokenStore`` over a corpus drawn from the seed, the step
``repro_torch.train.trainer.make_train_step`` returns and the optimizer
state, then takes the job's first ``checked_steps`` steps through that
same step and feed (the check's, and the warm-up). The window goes on
with the same objects, a step a unit.

The check's numbers (the reference follows the first ``checked_steps``
steps of the job from the same weights and the corpus's batches):

- ``loss_gap``: the largest over the steps of |loss - reference's| /
  |reference's|;
- ``grad_norm_gap``: the first step's clipped gradient, as the optimizer
  holds it (its first moment over 1 - b1), leaf by leaf: the worst leaf's
  |norm - reference's norm| over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change_norm_gap``: the same of the parameters' change over the
  checked steps, leaving out the leaves whose reference gradient is under
  a thousandth of the median leaf's (they move by round-off alone);
- ``grad_error``: the first gradient again, entry by entry over a sample
  drawn from the seed (:data:`GRAD_ENTRIES` a leaf): the worst leaf's
  norm of the difference over the larger of the reference's norm there
  and the median leaf's. The norms' gaps barely see errors of random sign;
  this number is the one a lower precision fails (PERF.md, section 2).
"""
from __future__ import annotations

import contextlib
import math
import statistics
import time

import numpy as np
import torch

from perfbench import generate, trace as tr, weights, work
from perfbench.drivers import Run, Timer, free, patched, peak, span, sync

GRAD_ENTRIES = 1 << 20         # sampled entries of each leaf's gradient
MOVE_FLOOR = 1e-3       # of the median leaf's reference gradient norm


def _change_norm(p: torch.Tensor, p0: torch.Tensor) -> float:
    """||p - p0|| in float64, a slice of the leading dimension at a time."""
    step = max(1, (1 << 26) // max(1, p[0].numel()))
    s = 0.0
    for a in range(0, p.shape[0], step):
        d = p[a:a + step].double() - p0[a:a + step].double()
        s += float(d.square().sum())
    return math.sqrt(s)


def grad_entries(ref, model: dict, seed: int) -> dict:
    """{leaf: the flat indices of its first gradient that the check
    compares entry by entry}, drawn from the seed."""
    return {name: generate.entries(math.prod(shape), GRAD_ENTRIES, seed, i)
            for i, (name, shape, _) in enumerate(ref.shapes(model))}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> Run:
    from repro_torch.data import TokenStore, token_batches
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    model, mix, ref = cell.model, cell.mix, cell.reference
    device = torch.device(device)
    cfg = ModelConfig(**model)
    b, s = mix["batch"], mix["seq"]
    parts = {"start": time.perf_counter() - t0}
    params = weights.make(ref, model, seed, device)
    sync(device)
    parts["weights"] = time.perf_counter() - t0
    corpus = generate.corpus(mix["corpus_tokens"], model["vocab"], seed)
    store = TokenStore(corpus, model["vocab"], device_unpack=True)
    parts["store"] = time.perf_counter() - t0
    data = token_batches(store, cfg, batch=b, seq=s, seed=seed,
                         device=device)
    opt = OptConfig(name=mix["optimizer"], lr=mix["lr"], b1=mix["b1"],
                    b2=mix["b2"], eps=mix["eps"],
                    weight_decay=mix["weight_decay"],
                    clip_norm=mix["clip_norm"])
    job = trainer_mod.TrainConfig(steps=mix["total_steps"],
                                  warmup=mix["warmup"],
                                  schedule=mix["schedule"])
    step_fn, _ = trainer_mod.make_train_step(cfg, opt, job)
    opt_state = init_opt_state(opt, params)
    sync(device)
    parts["optimizer state"] = time.perf_counter() - t0

    # the checked steps: the window's own call and feed, from the seed
    prog: dict = {"loss": []}
    for k in range(mix["checked_steps"]):
        params, opt_state, met = step_fn(params, opt_state, next(data), k)
        prog["loss"].append(float(met["loss"]))
        if k == 0:
            moments = ref.leaves(opt_state["m"])
            prog["grad_norms"] = {
                name: float(m.double().norm()) / (1 - mix["b1"])
                for name, m in moments.items()}
            prog["grad_sample"] = {
                name: moments[name].reshape(-1)[torch.from_numpy(idx).to(
                    device)].double().cpu().numpy() / (1 - mix["b1"])
                for name, idx in grad_entries(ref, model, seed).items()}
            del moments
            parts["first step"] = time.perf_counter() - t0
    parts["checked steps"] = time.perf_counter() - t0
    flat = ref.leaves(params)
    prog["change_norms"] = {
        name: _change_norm(flat[name],
                           weights.leaf(ref, model, seed, i, device))
        for i, (name, _, _) in enumerate(ref.shapes(model))}
    del flat, met
    sync(device)

    loader_s, losses = [], []
    opt_timer = Timer(device)
    step = mix["checked_steps"]
    wrap = patched(trainer_mod, "apply_updates",
                   opt_timer.wrap(trainer_mod.apply_updates)) if trace \
        else contextlib.nullcontext()
    with wrap:
        start = time.perf_counter()
        setup_s = start - t0
        while True:
            a = time.perf_counter()
            batch = next(data)
            loader_s.append(time.perf_counter() - a)
            params, opt_state, met = step_fn(params, opt_state, batch, step)
            losses.append(met["loss"])
            sync(device)
            step += 1
            end = time.perf_counter()
            if end - start >= seconds:
                break
    window_s = end - start
    units = len(losses)
    traced = None
    if trace:
        n_traced = 2

        def stretch():
            nonlocal params, opt_state, step
            for _ in range(n_traced):
                batch = span("loader", lambda: next(data))()
                params, opt_state, _ = span("step", step_fn)(
                    params, opt_state, batch, step)
                sync(device)
                step += 1

        with patched(trainer_mod, "apply_updates",
                     span("optimizer", trainer_mod.apply_updates)):
            traced = tr.profile(stretch) if device.type == "cuda" else None
        if traced is not None:
            traced["units"] = n_traced
    mem = peak(device)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del params, opt_state, data, store, met, batch, losses
    free(device)
    return Run(kind="train", model=model, mix=mix, seed=seed,
               device=device, reference=ref, setup_s=setup_s,
               window_s=window_s, units=units, tokens=units * b * s,
               latencies_s=[],
               spans={"loader_s": loader_s,
                      "optimizer_s": opt_timer.seconds()},
               trace=traced, flops=work.train_flops(model, b, s),
               least_s=work.least_seconds(work.train_products(model, b, s)),
               attempted=units, failed=failed, memory_peak_bytes=mem,
               program=prog, corpus=corpus, setup_parts=parts)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """{leaf: |got - want| / max(want, the median leaf's want)}."""
    names = [k for k in want if keep is None or k in keep]
    floor = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in names}


def reference_steps(run, prec: str = "float32",
                    half_batch: bool = False) -> dict:
    """The reference's (or, with ``prec="fp8"``, the control's) first
    steps of the job from the seed's weights and the corpus's batches."""
    mix, device, ref = run.mix, run.device, run.reference
    params = weights.make(ref, run.model, run.seed, device)
    batches = ref.loader_batches(run.corpus, run.seed,
                                 range(mix["checked_steps"]), mix["batch"],
                                 mix["seq"], device)
    out = ref.adamw_steps(run.model, mix, params, batches, prec=prec,
                          half_batch=half_batch,
                          sample=grad_entries(ref, run.model, run.seed))
    del params, batches
    free(device)
    return out


def compare(got: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    raw = ref["grad_norms_raw"]
    floor = statistics.median(raw.values())
    moved = {k for k, v in raw.items() if v >= MOVE_FLOOR * floor}
    err = {k: float(np.linalg.norm(got["grad_sample"][k] - v))
           for k, v in ref["grad_sample"].items()}
    size = {k: float(np.linalg.norm(v)) for k, v in ref["grad_sample"].items()}
    floor_s = statistics.median(size.values())
    return {"loss_gap": loss,
            "grad_error": max(err[k] / max(size[k], floor_s, 1e-30)
                              for k in err),
            "grad_norm_gap": max(leaf_gaps(got["grad_norms"],
                                           ref["grad_norms"]).values()),
            "change_norm_gap": max(leaf_gaps(got["change_norms"],
                                             ref["change_norms"],
                                             moved).values())}


def readings(run) -> tuple[dict, dict]:
    ref = reference_steps(run)
    return compare(run.program, ref), ref


def control(run, ref: dict) -> dict:
    return compare(reference_steps(run, prec="fp8"), ref)


def faults(run, ref: dict) -> dict:
    """Half the batch left out (the mean over the rest), planted in the
    reference put in the program's place; each step's loss on the three
    sides; the worst leaves of the norms' gaps."""
    half = reference_steps(run, half_batch=True)
    out = {"half_batch": compare(half, ref),
           "loss": {"program": run.program["loss"],
                    "reference": ref["loss"]}}
    for what in ("grad_norms", "change_norms"):
        gaps = leaf_gaps(run.program[what], ref[what])
        out["worst_" + what] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return out
