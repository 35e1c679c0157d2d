"""The LM serving path on a card held against the same path on the CPU.

``chip_smoke.py`` (phase 8) and ``tests/test_torch_kernels_cuda.py`` both
hold the card to the CPU through :func:`check_card_matches_cpu`, so the two
share one definition of "the card equals the CPU": greedy tokens equal,
and prefill and decode logits within rtol 1e-4 / atol 1e-5 in units of the
CPU logits' standard deviation (xlstm's atol 1e-4: :data:`ATOL_BY_ARCH`).
cuBLAS and the CPU's BLAS sum in another order (TF32 off), and a logit's rounding follows the size of the terms it
sums, not its own: minicpm's tied embeddings put its logits at std ~5,
the other archs' at ~0.6.

With the int8 KV cache, a code whose float32 input lies within rounding of
a half step rounds one way on the card and the other on the CPU. Such a
code may differ by one, at most :data:`MAX_CODE_FLIPS` times in a run; the
logits are then held at the same tolerance on every position of each
sequence before its first differing code (a later position reads it).

MoE routing has the same kind of edge: where the k-th and (k+1)-th
router probabilities lie within rounding of each other, the card and the
CPU can choose another expert, and that moves the token's output by a
whole expert's share. Both replays record their routing
(``moe.routing_trace``), and the expert ids must be equal. The one
exception is a decision whose top-k margin on the CPU is under
:data:`ROUTE_MARGIN` (float32 rounds probabilities at ~1e-7), at most
:data:`MAX_ROUTE_FLIPS` in a run; the logits are then held on every
position of each sequence before its first such flip, or before the call
that held it when that call dropped pairs of the sequence at its capacity
(the slots of the others follow the flip). Greedy tokens stay equal.

The audio family serves with the encoder's ``frames`` through
:func:`greedy` (prefill with them, then decode on the memory), since the
engine takes no frames, as the reference's does not; without frames it
goes through the engine, whose cross-attention reads an empty memory.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.pipeline import resolve_device
from repro_torch.models import blocks, lm, moe
from repro_torch.serve.engine import Request, ServeEngine

RTOL, ATOL = 1e-4, 1e-5        # atol in units of the CPU logits' std
# xlstm's 16 reduced layers (14 of them a chunked GLA whose float32 state,
# normalizer and divisor each sum in another order) put two float32
# implementations on the same inputs 4.7e-5 / 2.1e-5 std apart at seeds 0 /
# 1 (the port's CPU replay against the reference's; PERF.md section 6,
# fixed before the first card reading)
ATOL_BY_ARCH = {"xlstm-1.3b": 1e-4}
MAX_CODE_FLIPS = 8             # int8 codes one apart, per run
MAX_ROUTE_FLIPS = 2            # MoE expert choices that differ, per run
ROUTE_MARGIN = 1e-5            # the CPU's top-k margin under which they may
PROMPT, NEW, BATCH = 6, 8, 3


def _prefill_batch(tokens: torch.Tensor, device, patches=None,
                   frames=None) -> dict:
    """The prefill's batch: ``tokens`` with a vlm's patches or the audio
    encoder's frames (numpy arrays or tensors), on ``device``."""
    batch = {"tokens": tokens}
    for name, a in (("patch_embeds", patches), ("frames", frames)):
        if a is not None:
            batch[name] = torch.as_tensor(a).to(device)
    return batch


def replay(cfg, params, seq: np.ndarray, plen: int, max_len: int, device,
           patches: np.ndarray | None = None, timed: bool = False,
           frames=None):
    """Teacher forcing through the serve path: prefill ``seq[:, :plen]``
    (with the vlm's ``patches`` or the audio encoder's ``frames``), then
    decode ``seq[:, i]`` for each i in [plen, S - 1). Returns the logits
    (B, S - 1, vocab) float32, the state, the prefill's seconds and each
    decode step's (host clock, synchronised when ``timed``)."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if timed and device.type == "cuda" else \
        (lambda: None)
    tokens = torch.from_numpy(seq).to(device)
    state = lm.init_serve_state(
        cfg, seq.shape[0], max_len, device=device,
        enc_len=0 if frames is None else frames.shape[1])
    batch = _prefill_batch(tokens[:, :plen], device, patches, frames)
    sync()
    t0 = time.perf_counter()
    logits, state = lm.prefill(cfg, params, state, batch)
    sync()
    prefill_s = time.perf_counter() - t0
    out, steps = [logits[..., :cfg.vocab]], []
    for i in range(plen, seq.shape[1] - 1):
        t0 = time.perf_counter()
        logits, state = lm.decode_step(cfg, params, state,
                                       tokens[:, i:i + 1])
        sync()
        steps.append(time.perf_counter() - t0)
        out.append(logits[..., :cfg.vocab])
    return torch.cat(out, dim=1), state, prefill_s, steps


def greedy(cfg, params, prompts: np.ndarray, new: int, max_len: int, device,
           frames=None) -> np.ndarray:
    """Greedy tokens (B, new): ``lm.prefill`` of ``prompts`` with the audio
    encoder's ``frames``, then ``lm.decode_step`` on the memory, the first
    maximum each step, as the engine samples."""
    device = torch.device(device)
    state = lm.init_serve_state(
        cfg, prompts.shape[0], max_len, device=device,
        enc_len=0 if frames is None else frames.shape[1])
    batch = _prefill_batch(torch.from_numpy(prompts).to(device), device,
                           frames=frames)
    logits, state = lm.prefill(cfg, params, state, batch)
    toks = []
    for i in range(new):
        tok = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1).to(torch.int32)
        toks.append(tok)
        if i + 1 < new:
            logits, state = lm.decode_step(cfg, params, state, tok)
    return torch.cat(toks, dim=1).cpu().numpy()


def _code_flips(card_state, cpu_state, s: int):
    """-> (flips, first): the int8 codes that differ between the two
    caches over the first ``s`` positions (each must differ by one), and
    per sequence the first position holding one (``s`` where none)."""
    flips, hit = 0, None
    for card_c, cpu_c in zip(card_state["blocks"], cpu_state["blocks"]):
        for name in ("k", "v"):
            d = (card_c[name].cpu()[:, :, :s].to(torch.int16) -
                 cpu_c[name][:, :, :s].to(torch.int16)).abs()
            if int(d.max()) > 1:
                raise AssertionError(
                    f"int8 cache {name}: codes on the card differ from the "
                    f"CPU's by up to {int(d.max())}")
            flips += int(d.sum())
            at = d.flatten(3).amax(dim=(0, 3)) > 0         # (B, s)
            hit = at if hit is None else hit | at
    pos = torch.arange(s).expand_as(hit)
    first = torch.where(hit, pos, s).amin(dim=1)
    return flips, first


def replay_spans(plen: int, s: int) -> list[tuple[int, int]]:
    """The positions each forward call of :func:`replay` reads: the
    prefill's [0, plen), then one decode step a position up to ``s``."""
    return [(0, plen)] + [(i, i + 1) for i in range(plen, s)]


def routing_table(calls: list, n_moe: int) -> list[dict]:
    """A run's ``routing_trace().calls`` (``n_moe`` a forward call, in
    call order) -> one dict a MoE layer over the whole sequence, the
    calls' positions laid end to end, on the CPU: ``idx`` (B,S,k),
    ``margin`` (B,S), and ``dropped`` (B,S): the call holding the
    position dropped a pair of that sequence at its capacity."""
    out = []
    for layer in range(n_moe):
        mine = calls[layer::n_moe]
        out.append({
            "idx": torch.cat([c.idx.cpu() for c in mine], dim=1),
            "margin": torch.cat([c.margin.cpu() for c in mine], dim=1),
            "dropped": torch.cat([(~c.keep).any(dim=(1, 2))[:, None]
                                  .expand(c.keep.shape[:2]).cpu()
                                  for c in mine], dim=1)})
    return out


def forced_routes(table: list[dict], spans: list[tuple[int, int]]) -> list:
    """The expert ids of a :func:`routing_table` over one forward call,
    cut to the calls of a run over ``spans`` (:func:`replay_spans`), in
    call order, for ``moe.routing_trace(forced=...)``."""
    return [layer["idx"][:, a:b] for a, b in spans for layer in table]


def route_flips(cpu: list[dict], card: list[dict], spans) -> tuple:
    """Two runs' :func:`routing_table` over the same tokens -> (flips,
    first (B,)). Per sequence, the first position whose expert ids differ
    in any layer is a flip, taken at its first differing layer; its CPU
    top-k margin must be under :data:`ROUTE_MARGIN`. ``first`` is that
    position, or the start of the call holding it when that call dropped
    pairs of the sequence (``spans``); positions from there on are not
    compared (their inputs differ by the flip). Raises ``AssertionError``
    on a flip with a clear margin."""
    b, s = cpu[0]["idx"].shape[:2]
    differ = torch.stack([(c["idx"] != d["idx"]).any(dim=-1)
                          for c, d in zip(cpu, card)])           # (L,B,S)
    first = torch.full((b,), s)
    flips = 0
    for seq in range(b):
        at = differ[:, seq].any(dim=0).nonzero()
        if not len(at):
            continue
        p = int(at[0])
        layer = int(differ[:, seq, p].nonzero()[0])
        margin = float(cpu[layer]["margin"][seq, p])
        if not margin < ROUTE_MARGIN:
            raise AssertionError(
                f"sequence {seq}, position {p}, MoE layer {layer}: experts "
                f"{card[layer]['idx'][seq, p].tolist()} on the card, "
                f"{cpu[layer]['idx'][seq, p].tolist()} on the CPU, whose "
                f"top-k margin {margin:.3e} is not under {ROUTE_MARGIN}")
        flips += 1
        start = next(a for a, e in spans if a <= p < e)
        dropped = any(bool(t["dropped"][seq, p]) for t in cpu + card)
        first[seq] = start if dropped else p
    return flips, first


def check_card_matches_cpu(cfg, device=None, *, seed: int, max_len: int,
                           frames: np.ndarray | None = None) -> str:
    """One reduced float32 config: the port's seeded init on the CPU, copied
    to ``device`` (``cuda`` unless named); the engine on the card against
    the same engine on the CPU (greedy tokens equal), then teacher-forced
    prefill and decode logits over those tokens, a MoE model's expert ids
    under :func:`route_flips`. An audio model with ``frames`` (BATCH,
    enc_len, frontend_dim) serves through :func:`greedy` and replays with
    them; without, through the engine on an empty memory. Raises
    ``AssertionError`` on a difference; returns a line that says what was
    compared."""
    device = resolve_device(device)
    cpu = torch.device("cpu")
    params = lm.init_params(cfg, seed, device=cpu)
    on_card = pytree.tree_map(lambda t: t.to(device), params)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    patches = None
    if cfg.family == "vlm":
        patches = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    toks = []
    for d, p in ((cpu, params), (device, on_card)):
        if frames is not None:
            toks.append(greedy(cfg, p, prompts, NEW, max_len, d,
                               frames).tolist())
            continue
        eng = ServeEngine(cfg, p, batch_size=BATCH + 1, max_len=max_len,
                          device=d)
        toks.append([r.out_tokens for r in eng.run_batch(
            [Request(prompt=q, max_new_tokens=NEW) for q in prompts])])
    what = (f"{cfg.name} max_len {max_len} cache {cfg.kv_cache_dtype}")
    if cfg.family == "audio":
        what += (f" over {frames.shape[1]} frames" if frames is not None
                 else " on an empty memory (the engine)")
    if toks[0] != toks[1]:
        raise AssertionError(f"{what}: greedy tokens on the card {toks[1]} "
                             f"differ from the CPU's {toks[0]}")
    seq = np.concatenate([prompts, np.asarray(toks[0], np.int32)], axis=1)
    with moe.routing_trace() as cpu_tr:
        cpu_l, cpu_s, _, _ = replay(cfg, params, seq, PROMPT, max_len, cpu,
                                    patches, frames=frames)
    with moe.routing_trace() as card_tr:
        card_l, card_s, _, _ = replay(cfg, on_card, seq, PROMPT, max_len,
                                      device, patches, frames=frames)
    card_l = card_l.cpu()
    s = cpu_l.shape[1]
    flips, first = 0, torch.full((BATCH,), s)
    routes = ""
    n_moe = cfg.n_moe_layers
    if n_moe:
        tables = [routing_table(tr.calls, n_moe) for tr in (cpu_tr, card_tr)]
        try:
            route_n, first = route_flips(*tables, replay_spans(PROMPT, s))
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None
        if route_n > MAX_ROUTE_FLIPS:
            raise AssertionError(f"{what}: {route_n} MoE routing flips "
                                 f"(at most {MAX_ROUTE_FLIPS})")
        least = min(float(t["margin"].min()) for t in tables[0])
        routes = (f", {n_moe} MoE layers x {BATCH * s} positions routed, "
                  f"{route_n} flips (least CPU top-k margin {least:.3e})")
    if cfg.kv_cache_dtype == "int8":
        # the quantizer itself, on the same float32 input: bit for bit
        x = torch.from_numpy(rng.standard_normal(
            (BATCH, s, cfg.n_kv, cfg.head_dim)).astype(np.float32) * 3)
        for want, got in zip(blocks._kv_quantize(x),
                             blocks._kv_quantize(x.to(device))):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{what}: the int8 quantizer on the "
                                     "card differs from the CPU's")
        flips, code_first = _code_flips(card_s, cpu_s, s)
        first = torch.minimum(first, code_first)
        if flips > MAX_CODE_FLIPS:
            raise AssertionError(f"{what}: {flips} int8 codes differ between "
                                 f"the card and the CPU (at most "
                                 f"{MAX_CODE_FLIPS})")
    scale = float(cpu_l.std())
    atol = ATOL_BY_ARCH.get(cfg.name, ATOL)
    err = 0.0
    for b in range(BATCH):
        got, want = card_l[b, :first[b]], cpu_l[b, :first[b]]
        if got.numel():
            err = max(err, float((got - want).abs().max()) / scale)
        if not torch.allclose(got / scale, want / scale, rtol=RTOL,
                              atol=atol):
            raise AssertionError(
                f"{what}: logits on the card differ from the CPU's by up to "
                f"{err:.3e} std (rtol {RTOL}, atol {atol} std)")
    compared = int(first.sum()) * cfg.vocab
    note = (f", {flips} int8 codes one apart" if flips else "") + routes
    return (f"{what}: {sum(map(len, toks[0]))} greedy tokens equal, "
            f"{compared} logits within rtol {RTOL} / atol {atol} std "
            f"(max |d| {err:.3e} std, std {scale:.4f}){note}")
