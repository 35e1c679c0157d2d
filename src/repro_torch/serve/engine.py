"""Batched serving engine: prefill + decode over a fixed-shape request
batch.

The engine owns a (B, max_len) slot array: requests are right-padded
into slots (ghost slots hold zeros), prefilled together, and decoded step
by step with per-slot stop tracking. Sampling is greedy (the first
maximum) or temperature-based, from the engine's own seeded generator on
the parameters' device. The caches come from
:func:`repro_torch.models.lm.init_serve_state`. Requests carry no frames,
as the reference's do not: an audio model's cross-attention reads the
state's empty memory (``enc_len`` 0).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import obs
from repro_torch.core.pipeline import resolve_device
from repro_torch.distributed.sharding import canonical_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    prompt: np.ndarray                 # (len,) int32 token ids
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stop early
    out_tokens: list[int] = field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_size: int,
                 max_len: int, temperature: float = 0.0, seed: int = 0,
                 device=None):
        """``params`` must all sit on ``device`` (``cuda`` unless named;
        without CUDA that raises): the engine moves nothing."""
        self.device = resolve_device(device)
        home = canonical_device(self.device)
        off = {str(t.device) for t in pytree.tree_leaves(params)
               if canonical_device(t.device) != home}
        if off:
            raise ValueError(f"parameters on {sorted(off)}, not on the "
                             f"engine's device {self.device}")
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[..., :self.cfg.vocab]
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # Gumbel-max: argmax(logits / T + G) draws from softmax(logits / T)
        u = torch.rand(logits.shape, generator=self.generator,
                       device=logits.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        g = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.temperature + g,
                            dim=-1).to(torch.int32)

    def run_batch(self, requests: list[Request]) -> list[Request]:
        """Serve up to ``batch_size`` requests of equal prompt length."""
        if len(requests) > self.b:
            raise ValueError("batch too large")
        plen = len(requests[0].prompt)
        if any(len(r.prompt) != plen for r in requests):
            raise ValueError("engine batches equal-length prompts "
                             "(bucket upstream)")
        prompts = np.zeros((self.b, plen), np.int32)
        for i, r in enumerate(requests):
            prompts[i] = r.prompt
        with obs.span("engine.prefill"):
            state = lm.init_serve_state(self.cfg, self.b,
                                        max_len=self.max_len,
                                        device=self.device)
            logits, state = lm.prefill(
                self.cfg, self.params, state,
                {"tokens": torch.from_numpy(prompts).to(self.device)})
            tok = self._sample(logits[:, -1:])
        max_new = max(r.max_new_tokens for r in requests)
        done = np.zeros(self.b, bool)
        for step in range(max_new):
            with obs.host_read("engine_tokens"):
                tok_np = tok[:, 0].cpu().numpy()
            for i, r in enumerate(requests):
                if not done[i] and step < r.max_new_tokens:
                    t = int(tok_np[i])
                    r.out_tokens.append(t)
                    if t == r.eos_id:
                        done[i] = True
            if done[:len(requests)].all():
                break
            if int(state["pos"]) >= self.max_len:
                break
            with obs.span("engine.decode_step"):
                logits, state = lm.decode_step(self.cfg, self.params, state,
                                               tok)
                tok = self._sample(logits)
        return requests

    def throughput_stats(self, requests: list[Request],
                         wall_s: float) -> dict:
        new = sum(len(r.out_tokens) for r in requests)
        # wall_s <= 0 cannot yield a rate: 0.0 + flag, not float('inf')
        # (json.dump renders inf as the non-standard Infinity token)
        wall_ok = wall_s > 0
        return {"requests": len(requests), "new_tokens": new,
                "wall_s_invalid": not wall_ok,
                "tok_per_s": new / wall_s if wall_ok else 0.0}
