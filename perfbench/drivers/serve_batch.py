"""The ``serve_batch`` kind: a closed loop of fixed-shape batches through
``repro_torch.serve.ServeEngine.run_batch`` (greedy, no early stop).
Set-up makes the weights from the seed and the engine, and serves one
short batch at the cell's shapes. The window hands batch after batch to
``run_batch``, each as the last returns, a batch a unit.

The check's number, ``served_logit_gap``: the widest gap, over a sample
of the window's requests drawn from the seed (the longest among them), by
which a served token's logit lies below the reference's best at its
position, the reference's forward run over the prompt and the served
tokens.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import generate, weights, work
from perfbench import trace as tr
from perfbench.drivers import Run, free, patched, peak, span, sync


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> Run:
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.engine import Request, ServeEngine

    model, mix, ref = cell.model, cell.mix, cell.reference
    device = torch.device(device)
    cfg = ModelConfig(**model)
    b, plen, new = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    parts = {"start": time.perf_counter() - t0}
    params = weights.make(ref, model, seed, device)
    sync(device)
    parts["weights"] = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, batch_size=b, max_len=mix["max_len"],
                      temperature=0.0, seed=seed, device=device)

    def requests(index: int, n_new: int) -> list:
        p = generate.prompts(mix, model["vocab"], seed, index)
        return [Request(prompt=row, max_new_tokens=n_new, eos_id=-1)
                for row in p]

    eng.run_batch(requests(generate.WARM_UP, 2))
    sync(device)
    parts["warm-up batch"] = time.perf_counter() - t0

    calls: list = []

    def noted(*a, **k):
        calls.append(time.perf_counter())
        return decode(*a, **k)

    decode = lm.decode_step
    wrap = patched(lm, "decode_step", noted) if trace else \
        contextlib.nullcontext()
    need = -(-mix["checked_requests"] // b)
    lat, prompts, served, spans = [], [], [], {"prefill_s": [],
                                               "decode_s": [],
                                               "decode_calls": []}
    with wrap:
        start = time.perf_counter()
        setup_s = start - t0
        while True:
            reqs = requests(len(lat), new)
            calls.clear()
            a = time.perf_counter()
            eng.run_batch(reqs)
            sync(device)
            end = time.perf_counter()
            lat.append(end - a)
            prompts.append(np.stack([r.prompt for r in reqs]))
            served.append([list(r.out_tokens) for r in reqs])
            if calls:
                spans["prefill_s"].append(calls[0] - a)
                spans["decode_s"].append(end - calls[0])
                spans["decode_calls"].append(len(calls))
            if end - start >= seconds and len(lat) >= need:
                break
    window_s = end - start
    units = len(lat)
    traced = None
    if trace and device.type == "cuda":
        reqs = requests(units, new)
        with patched(lm, "decode_step", span("decode_step",
                                             lm.decode_step)), \
                patched(lm, "prefill", span("prefill", lm.prefill)):
            traced = tr.profile(lambda: eng.run_batch(reqs))
        traced["units"] = 1
        traced["decode_calls"] = len(traced["spans"].get("decode_step", []))
    mem = peak(device)
    lengths = [len(t) for batch in served for t in batch]
    failed = sum(len(t) != new or any(not 0 <= x < model["vocab"] for x in t)
                 for batch in served for t in batch)
    del eng, params
    free(device)
    return Run(kind="serve_batch", model=model, mix=mix, seed=seed,
               device=device, reference=ref, setup_s=setup_s,
               window_s=window_s, units=units,
               tokens=sum(plen + n for n in lengths),
               latencies_s=[x for x in lat for _ in range(b)], spans=spans,
               trace=traced, flops=work.serve_flops(model, b, plen, new),
               least_s=work.least_seconds(
                   work.serve_products(model, b, plen, new)),
               attempted=units * b, failed=failed, memory_peak_bytes=mem,
               program={"prompts": np.concatenate(prompts),
                        "served": [t for batch in served for t in batch]},
               setup_parts=parts)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------
def sample(run) -> tuple[np.ndarray, np.ndarray, int]:
    """(tokens (k, plen + new - 1), served (k, new), plen) of the sampled
    requests; the longest request is always among them."""
    served = run.program["served"]
    idx = generate.sample(len(served), run.mix["checked_requests"], run.seed)
    longest = int(np.argmax([len(t) for t in served]))
    if longest not in idx:
        idx[0] = longest
    new = max(len(served[i]) for i in idx)
    plen = run.program["prompts"].shape[1]
    toks = np.zeros((len(idx), plen + new - 1), np.int64)
    out = np.zeros((len(idx), new), np.int64)
    for j, i in enumerate(idx):
        t = np.asarray(served[i], np.int64)
        toks[j, :plen] = run.program["prompts"][i]
        toks[j, plen:plen + len(t) - 1] = t[:-1]
        out[j, :len(t)] = t
    return toks, out, plen


def reference_logits(run, prec: str = "float32") -> torch.Tensor:
    """The reference's (or the control's) logits (k, new, vocab) at the
    positions where the sampled requests' tokens were served."""
    toks, served, plen = sample(run)
    params = weights.make(run.reference, run.model, run.seed, run.device)
    pos = torch.arange(plen - 1, plen - 1 + served.shape[1],
                       device=run.device)
    logits = run.reference.logits_at(run.model, params,
                                     torch.from_numpy(toks).to(run.device),
                                     pos, prec=prec)
    del params
    free(run.device)
    return logits


def gaps(ref_logits: torch.Tensor, chosen) -> dict:
    """Of (reference's best logit - its logit of the chosen token) over
    the positions: the widest (``served_logit_gap``) and the mean
    (``served_logit_gap_mean``)."""
    chosen = torch.as_tensor(chosen, device=ref_logits.device).long()
    best = ref_logits.amax(dim=-1)
    gap = best - ref_logits.gather(-1, chosen[..., None])[..., 0]
    return {"served_logit_gap": float(gap.max()),
            "served_logit_gap_mean": float(gap.double().mean())}


def readings(run) -> tuple[dict, torch.Tensor]:
    ref = reference_logits(run)
    _, served, _ = sample(run)
    return gaps(ref, served), ref


def control(run, ref: torch.Tensor) -> dict:
    """At each position of the same prompts and served tokens, the gaps of
    the token the control puts first."""
    return gaps(ref, reference_logits(run, prec="fp8").argmax(dim=-1))


def faults(run, ref: torch.Tensor) -> dict:
    top2 = ref.topk(2, dim=-1).values
    return {"ref_top2_margin_median":
            float((top2[..., 0] - top2[..., 1]).median())}
