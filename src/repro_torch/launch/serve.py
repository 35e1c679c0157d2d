"""Serving launcher: batched requests against any --arch of
``configs.ARCH_IDS`` (families ``dense``, ``vlm``, ``moe``, ``ssm``,
``hybrid`` and ``audio``) on --device (``cuda`` unless named). Weights are drawn
from --seed on the device, at any preset; nothing is loaded. The engine
takes no frames, as the reference's does not, so an audio arch's
cross-attention reads an empty memory here.

Examples (at full width on one card: glm4-9b, ~18.8 GB of bf16 weights;
moonshot-v1-16b-a3b, ~57.0 GB; seamless-m4t-large-v2, ~4.1 GB;
xlstm-1.3b, ~4.5 GB; hymba-1.5b, ~3.4 GB; llama4-maverick's ~795 GB do
not fit one):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --preset full --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch moonshot-v1-16b-a3b --preset full --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-large-v2 --preset full --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --preset full --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --preset full --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch.train import preset_config
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--preset", default="small",
                    choices=["smoke", "small", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = preset_config(get_config(args.arch), args.preset)
    params = lm.init_params(cfg, args.seed, device=args.device)
    engine = ServeEngine(cfg, params, batch_size=args.requests,
                         max_len=args.prompt_len + args.max_new,
                         temperature=args.temperature, seed=args.seed,
                         device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32), max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    obs.reset()
    t0 = time.time()
    done = engine.run_batch(reqs)
    dt = time.time() - t0
    stats = engine.throughput_stats(done, dt)
    print(f"arch={cfg.name} ({lm.param_count(params)/1e6:.1f}M params, "
          f"{cfg.dtype}, on {engine.device})")
    print(f"served {stats['requests']} requests, "
          f"{stats['new_tokens']} new tokens in {dt:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt[:8]={r.prompt[:8].tolist()} "
              f"-> out[:8]={r.out_tokens[:8]}")
    print("host reads: " + (", ".join(
        f"{site} {n}" for site, n in sorted(obs.counts().items())) or "none"))
    return stats


if __name__ == "__main__":
    main()
