"""Training launcher: any --arch of ``configs.ARCH_IDS`` at any preset on
--device (``cuda`` unless named), real optimization steps over the columnar
token pipeline (dictionary-encoded, bit-packed storage — the paper's data
path). Weights are drawn from --seed on the device; nothing is loaded.

Examples (minicpm-2b at full width on one card: 5.4 GB of bf16 weights,
as much again of gradients, 21.8 GB of AdamW moments):
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --preset full --batch 2 --seq 2048 --steps 12
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --preset small --steps 50 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.data import TokenStore, synthetic_corpus, token_batches
from repro_torch.models import lm
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def preset_config(cfg, preset: str):
    if preset == "full":
        return cfg
    if preset == "smoke":
        return reduced(cfg)
    if preset == "small":          # ~15M params, trainable on 1 CPU core
        return dataclasses.replace(
            reduced(cfg), d_model=256, d_head=32, d_ff=512 if cfg.d_ff else 0,
            vocab=4099, vocab_pad_multiple=64)
    raise ValueError(preset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--preset", default="small",
                    choices=["smoke", "small", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--opt", default="adamw",
                    choices=["adamw", "adamw8", "adafactor"])
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = preset_config(get_config(args.arch), args.preset)
    print(f"arch={cfg.name} family={cfg.family} params~"
          f"{cfg.param_count()/1e6:.1f}M (preset={args.preset})")

    params = lm.init_params(cfg, args.seed, device=args.device)
    device = params["embed"].device
    print(f"materialized params: {lm.param_count(params)/1e6:.1f}M "
          f"({cfg.dtype}, on {device})")

    corpus = synthetic_corpus(2_000_000, cfg.vocab, seed=args.seed)
    store = TokenStore(corpus, cfg.vocab)
    print(f"token store: {store.n} tokens, {store.bits}b codes, "
          f"{store.packed_nbytes/1e6:.1f}MB packed "
          f"vs {store.raw_nbytes/1e6:.1f}MB raw "
          f"({store.raw_nbytes/store.packed_nbytes:.1f}x), "
          f"unigram entropy {store.entropy_bits():.2f} bits "
          f"(from count metadata)")

    data = token_batches(store, cfg, batch=args.batch, seq=args.seq,
                         seed=args.seed, device=device)
    # MiniCPM gets its signature WSD schedule by default
    schedule = "wsd" if (args.arch == "minicpm-2b"
                         and args.schedule == "cosine") else args.schedule
    trainer = Trainer(
        cfg=cfg,
        opt=OptConfig(name=args.opt, lr=args.lr),
        train=TrainConfig(steps=args.steps, warmup=max(2, args.steps // 20),
                          schedule=schedule, log_every=max(1, args.steps // 20),
                          ckpt_every=max(10, args.steps // 4),
                          ckpt_dir=args.ckpt_dir),
    )
    obs.reset()
    t0 = time.time()
    params, history = trainer.fit(params, data)
    dt = time.time() - t0
    first, last = history[0], history[-1]
    toks = args.steps * args.batch * args.seq
    print(f"\ntrained {args.steps} steps in {dt:.1f}s "
          f"({toks/dt:.0f} tok/s)")
    print(f"loss: {first['loss']:.4f} -> {last['loss']:.4f}")
    print(json.dumps(history[-3:], indent=1))
    print("host reads: " + (", ".join(
        f"{site} {n}" for site, n in sorted(obs.counts().items())) or "none"))
    if trainer.fault_log.events:
        print("fault log:", trainer.fault_log.summary())
    assert last["loss"] < first["loss"], "training must reduce loss"
    return history


if __name__ == "__main__":
    main()
