"""The LM training step on a card held against the same step on the CPU.

``chip_smoke.py`` (phase 9) and ``tests/test_torch_kernels_cuda.py`` both
hold the card to the CPU through :func:`check_train_card_matches_cpu`, so
the two share one definition of "the card trains as the CPU does":

- one ``train_loss`` step: the loss within :data:`LOSS_RTOL` x max(1,
  loss), and each gradient leaf within rtol :data:`RTOL` and atol
  :data:`ATOL` x the standard deviation of that leaf's CPU gradient
  (:data:`ATOL_BY_ARCH` where a family's own noise floor is above it);
- one ``apply_updates`` of each optimizer from the same gradients and
  state (the CPU's): parameters and float moments within rtol
  :data:`UPD_RTOL` and atol :data:`UPD_ATOL`; AdamW8's scales within rtol
  :data:`UPD_RTOL`, and at most :data:`MAX_CODE_FLIPS` int8 codes a leaf
  one apart, none further.

cuBLAS and the CPU's BLAS sum in another order (TF32 off). A MoE model's
routing on the card is recorded (``moe.routing_trace``); where its expert
ids differ from the CPU's, each such decision must have a CPU top-k margin
under ``lm_parity.ROUTE_MARGIN``, at most ``lm_parity.MAX_ROUTE_FLIPS``,
and the card's step is then taken again with the CPU's ids forced.

``python -m repro_torch.train.parity --arch ARCH ... --seeds N`` prints
the gradient gap at seeds 0 to N-1 without stopping at one past its atol.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.pipeline import resolve_device
from repro_torch.models import lm, moe
from repro_torch.serve import lm_parity
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.trainer import loss_and_grads

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5        # atol in units of each CPU gradient's std
# Two float32 implementations on the same inputs: the port's CPU gradients
# against the reference's jax.grad on this check's own weights and batch
# (B 2 x S 16, seeds 0 and 1) need an atol of up to 2.66e-4 std for xlstm
# (its chunked GLA sums its float32 state in another order) and 1.40e-5
# std for llama4-maverick's router, the others under 6.8e-6 (PERF.md
# section 6, LM training; fixed before the first card reading): about
# twice that
ATOL_BY_ARCH = {"xlstm-1.3b": 1e-3, "llama4-maverick-400b-a17b": 3e-5}
UPD_RTOL, UPD_ATOL = 1e-6, 1e-8
MAX_CODE_FLIPS = 8             # AdamW8 int8 codes one apart, per leaf
OPTIMIZERS = ("adamw", "adamw8", "adafactor")


def train_batch(cfg, rng: np.random.Generator, b: int, s: int) -> dict:
    """``tests/test_arch_smoke.py``'s train batch, as numpy: tokens and
    labels (one label masked), a vlm's patches, an audio arch's frames."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, min(3, s - 1)] = -1
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _on(tree, device):
    return pytree.tree_map(
        lambda t: t.detach().to(device, copy=True)
        if isinstance(t, torch.Tensor) else t, tree)


def _routed_step(cfg, params, batch, cpu_calls, what: str):
    """The card's step, its routing recorded; where its expert ids differ
    from ``cpu_calls``' the flips are checked and the step is taken again
    with the CPU's ids forced. -> (loss, metrics, grads, note)."""
    with moe.routing_trace() as tr:
        out = loss_and_grads(cfg, params, batch)
    if not cpu_calls:
        return (*out, "")
    flips = 0
    for layer, (c, d) in enumerate(zip(cpu_calls, tr.calls)):
        differ = (c.idx != d.idx.cpu()).any(dim=-1)
        for seq, pos in differ.nonzero().tolist():
            margin = float(c.margin[seq, pos])
            if not margin < lm_parity.ROUTE_MARGIN:
                raise AssertionError(
                    f"{what}: MoE call {layer}, sequence {seq}, position "
                    f"{pos}: experts {d.idx[seq, pos].tolist()} on the "
                    f"card, {c.idx[seq, pos].tolist()} on the CPU, whose "
                    f"top-k margin {margin:.3e} is not under "
                    f"{lm_parity.ROUTE_MARGIN}")
            flips += 1
    least = min(float(c.margin.detach().min()) for c in cpu_calls)
    note = (f", {len(cpu_calls)} MoE calls routed, {flips} flips (least "
            f"CPU top-k margin {least:.3e})")
    if flips > lm_parity.MAX_ROUTE_FLIPS:
        raise AssertionError(f"{what}: {flips} MoE routing flips (at most "
                             f"{lm_parity.MAX_ROUTE_FLIPS})")
    if flips:
        with moe.routing_trace(forced=[c.idx for c in cpu_calls]):
            out = loss_and_grads(cfg, params, batch)
        note += ", the card's step retaken with the CPU's ids"
    return (*out, note)


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float) -> bool:
    return bool(torch.allclose(got.double(), want.double(), rtol=rtol,
                               atol=atol))


def _check_update(name: str, cfg, grads, params, state, lr, device,
                  what: str) -> str:
    """One ``apply_updates`` on the card against the CPU's from the same
    gradients, parameters and state."""
    opt = OptConfig(name=name, lr=1e-2)
    card = apply_updates(opt, _on(grads, device), _on(state, device),
                         _on(params, device), lr)
    cpu = apply_updates(opt, grads, _on(state, "cpu"), _on(params, "cpu"),
                        lr)
    worst, codes = 0.0, 0
    for (path, want), (_, got) in zip(_paths(cpu), _paths(card)):
        if not isinstance(want, torch.Tensor):
            if want != got:
                raise AssertionError(f"{what} {name}{path}: {got} on the "
                                     f"card, {want} on the CPU")
            continue
        got = got.cpu()
        if want.dtype == torch.int8:
            d = (got.to(torch.int16) - want.to(torch.int16)).abs()
            n = int((d > 0).sum())
            codes = max(codes, n)
            if int(d.max()) > 1 or n > MAX_CODE_FLIPS:
                raise AssertionError(
                    f"{what} {name}{path}: {n} int8 codes differ (up to "
                    f"{int(d.max())} apart; at most {MAX_CODE_FLIPS}, one "
                    "apart)")
            continue
        atol = 0.0 if path.endswith("/scale") else UPD_ATOL
        d = (got.double() - want.double()).abs()
        worst = max(worst, float((d / want.double().abs().clamp_min(
            1e-30)).max()) if d.numel() else 0.0)
        if not _close(got, want, UPD_RTOL, atol):
            raise AssertionError(
                f"{what} {name}{path}: the card's update differs from the "
                f"CPU's by up to {float(d.max()):.3e} (rtol {UPD_RTOL}, "
                f"atol {atol})")
    return f"{name} (max rel {worst:.2e}, {codes} codes one apart)"


def _steps(cfg, device, seed: int, b: int, s: int):
    """The seeded float32 config and batch, one step on the CPU and one on
    ``device`` -> (cfg, what, params, (loss, metrics, grads) on the CPU,
    (loss, metrics, grads) on the card, routing note)."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = lm.init_params(cfg, seed, device="cpu")
    np_batch = train_batch(cfg, np.random.default_rng(seed), b, s)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    what = (f"{cfg.name} B {b} x S {s}, remat {cfg.remat}, loss_chunk "
            f"{cfg.loss_chunk}")
    with moe.routing_trace() as cpu_tr:
        cpu = loss_and_grads(cfg, params, batch)
    *card, note = _routed_step(
        cfg, _on(params, device), {k: v.to(device) for k, v in batch.items()},
        cpu_tr.calls, what)
    return cfg, what, params, cpu, card, note


def gradient_gaps(grads, c_grads):
    """Each leaf's gap, card against CPU -> [(path, the largest |d| past
    rtol :data:`RTOL` in units of the CPU gradient's std (inf for any such
    |d| where that std is 0), max |d|, std)]."""
    out = []
    for (path, want), (_, got) in zip(_paths(grads), _paths(c_grads)):
        if not want.numel():
            out.append((path, 0.0, 0.0, 0.0))
            continue
        want, got = want.double(), got.cpu().double()
        std = float(want.std(correction=0))
        d = (got - want).abs()
        excess = float((d - RTOL * want.abs()).clamp_min(0).max())
        gap = excess / std if std else (0.0 if excess == 0 else math.inf)
        out.append((path, gap, float(d.max()), std))
    return out


def check_train_card_matches_cpu(cfg, device=None, *, seed: int, b: int = 2,
                                 s: int = 16) -> str:
    """One reduced float32 config: the port's seeded init on the CPU, copied
    to ``device`` (``cuda`` unless named); one ``train_loss`` step (B ``b``
    x S ``s``) on the card against the CPU's, then one ``apply_updates`` of
    each optimizer from the CPU's gradients and state (the state after one
    CPU step, so its moments are not zero). Raises ``AssertionError`` on a
    difference; returns a line that says what was compared."""
    device = resolve_device(device)
    cfg, what, params, (loss, metrics, grads), card, note = _steps(
        cfg, device, seed, b, s)
    c_loss, c_metrics, c_grads = card
    c_loss = float(c_loss)
    if not abs(c_loss - float(loss)) <= LOSS_RTOL * max(1.0, abs(float(loss))):
        raise AssertionError(f"{what}: loss {c_loss} on the card, "
                             f"{float(loss)} on the CPU")
    for k in ("ce", "aux", "z", "tokens"):
        if not _close(c_metrics[k].cpu(), metrics[k], LOSS_RTOL, 0.0):
            raise AssertionError(f"{what}: metric {k} {float(c_metrics[k])} "
                                 f"on the card, {float(metrics[k])} on the "
                                 "CPU")
    atol = ATOL_BY_ARCH.get(cfg.name, ATOL)
    gaps = gradient_gaps(grads, c_grads)
    for path, gap, d_max, std in gaps:
        if not gap <= atol:
            raise AssertionError(
                f"{what}: gradient {path} on the card differs from the "
                f"CPU's by up to {d_max:.3e} (rtol {RTOL}, atol {atol} x its "
                f"std {std:.3e}; {gap:.3e} std past rtol)")
    worst = max(g[1] for g in gaps)
    n = sum(t.numel() for _, t in _paths(grads))
    state_line = []
    lr = torch.tensor(3e-3, dtype=torch.float32)
    for name in OPTIMIZERS:
        opt = OptConfig(name=name, lr=1e-2)
        p0 = _on(params, "cpu")
        _, state = apply_updates(opt, grads, init_opt_state(opt, p0), p0,
                                 torch.tensor(1e-2, dtype=torch.float32))
        state_line.append(_check_update(name, cfg, grads, p0, state, lr,
                                        device, what))
    return (f"{what}: loss {c_loss:.6f} (|d| {abs(c_loss - float(loss)):.2e})"
            f", {n} gradient entries within rtol {RTOL} / atol {atol} std "
            f"(worst {worst:.2e} std){note}; one update from the CPU's "
            f"state: {', '.join(state_line)}")


def main(argv=None) -> None:
    """``python -m repro_torch.train.parity --arch hymba-1.5b --seeds 8``:
    the gradient gap of :func:`check_train_card_matches_cpu`, card against
    CPU, at seeds 0 to N-1, the worst leaves of each beside the arch's
    atol; it reports and does not stop at a gap."""
    import argparse

    from repro_torch.configs import get_config, reduced
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--arch", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in args.arch:
        atol = ATOL_BY_ARCH.get(arch, ATOL)
        for seed in range(args.seeds):
            *_, (_, _, grads), (_, _, c_grads), _ = _steps(
                reduced(get_config(arch)), device, seed, 2, 16)
            gaps = sorted(gradient_gaps(grads, c_grads), key=lambda g: -g[1])
            top = "; ".join(f"{p} {g:.3e}" for p, g, _, _ in gaps[:3])
            held = "within" if gaps[0][1] <= atol else "PAST"
            print(f"{arch} seed {seed}: {held} atol {atol} std: {top}",
                  flush=True)


if __name__ == "__main__":
    main()
