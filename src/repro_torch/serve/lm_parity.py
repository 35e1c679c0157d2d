"""The LM serving path on a card held against the same path on the CPU.

``chip_smoke.py`` (phase 8) and ``tests/test_torch_kernels_cuda.py`` both
hold the card to the CPU through :func:`check_card_matches_cpu`, so the two
share one definition of "the card equals the CPU": greedy tokens equal,
and prefill and decode logits within rtol 1e-4 / atol 1e-5 in units of the
CPU logits' standard deviation. cuBLAS and the CPU's BLAS sum in another
order (TF32 off), and a logit's rounding follows the size of the terms it
sums, not its own: minicpm's tied embeddings put its logits at std ~5,
the other archs' at ~0.6.

With the int8 KV cache, a code whose float32 input lies within rounding of
a half step rounds one way on the card and the other on the CPU. Such a
code may differ by one, at most :data:`MAX_CODE_FLIPS` times in a run; the
logits are then held at the same tolerance on every position of each
sequence before its first differing code (a later position reads it).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.pipeline import resolve_device
from repro_torch.models import blocks, lm
from repro_torch.serve.engine import Request, ServeEngine

RTOL, ATOL = 1e-4, 1e-5        # atol in units of the CPU logits' std
MAX_CODE_FLIPS = 8             # int8 codes one apart, per run
PROMPT, NEW, BATCH = 6, 8, 3


def replay(cfg, params, seq: np.ndarray, plen: int, max_len: int, device,
           patches: np.ndarray | None = None, timed: bool = False):
    """Teacher forcing through the serve path: prefill ``seq[:, :plen]``,
    then decode ``seq[:, i]`` for each i in [plen, S - 1). Returns the
    logits (B, S - 1, vocab) float32, the state, the prefill's seconds and
    each decode step's (host clock, synchronised when ``timed``)."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if timed and device.type == "cuda" else \
        (lambda: None)
    tokens = torch.from_numpy(seq).to(device)
    state = lm.init_serve_state(cfg, seq.shape[0], max_len, device=device)
    batch = {"tokens": tokens[:, :plen]}
    if patches is not None:
        batch["patch_embeds"] = torch.from_numpy(patches).to(device)
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


def check_card_matches_cpu(cfg, device=None, *, seed: int,
                           max_len: int) -> str:
    """One reduced float32 config: the port's seeded init on the CPU, copied
    to ``device`` (``cuda`` unless named); the engine on the card against
    the same engine on the CPU (greedy tokens equal), then teacher-forced
    prefill and decode logits over those tokens. Raises ``AssertionError``
    on a difference; returns a line that says what was compared."""
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
        eng = ServeEngine(cfg, p, batch_size=BATCH + 1, max_len=max_len,
                          device=d)
        toks.append([r.out_tokens for r in eng.run_batch(
            [Request(prompt=q, max_new_tokens=NEW) for q in prompts])])
    what = (f"{cfg.name} max_len {max_len} cache {cfg.kv_cache_dtype}")
    if toks[0] != toks[1]:
        raise AssertionError(f"{what}: greedy tokens on the card {toks[1]} "
                             f"differ from the CPU's {toks[0]}")
    seq = np.concatenate([prompts, np.asarray(toks[0], np.int32)], axis=1)
    cpu_l, cpu_s, _, _ = replay(cfg, params, seq, PROMPT, max_len, cpu,
                                patches)
    card_l, card_s, _, _ = replay(cfg, on_card, seq, PROMPT, max_len,
                                  device, patches)
    card_l = card_l.cpu()
    s = cpu_l.shape[1]
    flips, first = 0, torch.full((BATCH,), s)
    if cfg.kv_cache_dtype == "int8":
        # the quantizer itself, on the same float32 input: bit for bit
        x = torch.from_numpy(rng.standard_normal(
            (BATCH, s, cfg.n_kv, cfg.head_dim)).astype(np.float32) * 3)
        for want, got in zip(blocks._kv_quantize(x),
                             blocks._kv_quantize(x.to(device))):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{what}: the int8 quantizer on the "
                                     "card differs from the CPU's")
        flips, first = _code_flips(card_s, cpu_s, s)
        if flips > MAX_CODE_FLIPS:
            raise AssertionError(f"{what}: {flips} int8 codes differ between "
                                 f"the card and the CPU (at most "
                                 f"{MAX_CODE_FLIPS})")
    scale = float(cpu_l.std())
    err = 0.0
    for b in range(BATCH):
        got, want = card_l[b, :first[b]], cpu_l[b, :first[b]]
        if got.numel():
            err = max(err, float((got - want).abs().max()) / scale)
        if not torch.allclose(got / scale, want / scale, rtol=RTOL,
                              atol=ATOL):
            raise AssertionError(
                f"{what}: logits on the card differ from the CPU's by up to "
                f"{err:.3e} std (rtol {RTOL}, atol {ATOL} std)")
    compared = int(first.sum()) * cfg.vocab
    note = f", {flips} int8 codes one apart" if flips else ""
    return (f"{what}: {sum(map(len, toks[0]))} greedy tokens equal, "
            f"{compared} logits within rtol {RTOL} / atol {ATOL} std "
            f"(max |d| {err:.3e} std, std {scale:.4f}){note}")
