"""Same-run A/B of the kernels this checkout rewrote against an earlier
checkout's, on one card:

    python3 src/repro_torch/kernels/compare_versions.py --base DIR [--seed S]

``DIR`` holds the earlier checkout (for instance its commit's ``git
archive`` unpacked under ``build/``). Each version runs in a child process
of its own, in turns earlier, this, this, earlier, with its checkout's
``src/`` first on the path: it builds its own sources into its own
``build/torch_ext/`` and is called through its own wrappers, so the two
versions need not share a C interface. A turn makes the same inputs from
the seed, holds each kernel against its plain version run on the CPU, and
times it with ``chip_smoke.py``'s timers (this checkout's): back to back
(the median of 15 runs of 50 launches queued behind a spin kernel) and
after a 128 MiB L2 flush (the median of 50 single launches); then its
device time per call from ``torch.profiler`` (the kernels' and memsets'
durations over 100 calls, without the gaps between launches), beside that
of a one-element fill, the least a launch takes. The shapes:

- the packed-rows gather: 2,048 rows (the serving path's launch) against a
  2**25-row stream at device widths 8/8/8/2 (27,262,976 random words) and
  the serving plan's tables, 72 x 2, 50 x 50, 230 x 2 and 4 x 4 (out_dim
  58);
- the single-table gather: ``zscore``'s (999, 1) float32 table by 2**25
  codes;
- the wide gradient at :data:`GRADIENT_SHAPES`: the train shape (codes of
  ``state`` below 50 and of ``device`` below 4), the JAX sweep's shape,
  the train shape's columns at more rows, and the edge sets' grouped
  shapes.

Both gathers must equal their plain versions, and the two versions each
other, bit for bit; the gradient of this checkout must equal the CPU's bit
for bit, the earlier one (float atomics) be within ``backward_sum_bound``
of it. One line per kernel and turn, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[3]       # this checkout's root
# (C, N, K, F) of the wide gradient
GRADIENT_SHAPES = ((2, 1024, 50, 1), (2, 256, 600, 128), (2, 2048, 50, 1),
                   (2, 4096, 50, 1), (2, 8192, 50, 1), (2, 65536, 50, 1),
                   (2, 131072, 50, 1), (2, 200_000, 1_000, 64),
                   (3, 20_000, 3, 2))


def _timers():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  THIS / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_us(fn, calls: int = 100) -> float:
    """Device time per call, in us: the durations of the kernels and
    memsets ``fn`` runs, traced by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if str(e.device_type).endswith("CUDA")) / calls


def _cases(rng, dev):
    """name -> (call, plain on the CPU, check kind), built from the seed
    with the checkout on the path."""
    import numpy as np
    import torch
    from repro_torch.kernels.adv_gather import ops as adv_ops
    from repro_torch.kernels.adv_gather import ref as adv_ref
    from repro_torch.kernels.onehot_wide import ops as wide_ops
    from repro_torch.kernels.onehot_wide import ref as wide_ref
    cases = {}
    n_rows, dbs = 1 << 25, (8, 8, 8, 2)
    words = [rng.integers(0, 1 << 32, n_rows * db // 32, dtype=np.uint64)
             .astype(np.uint32) for db in dbs]
    offs = [int(o) for o in np.cumsum([0] + [w.size for w in words])[:-1]]
    flat = torch.from_numpy(np.concatenate(words).view(np.int32)).to(dev)
    wmeta = adv_ops.word_meta(offs, dbs, dev)
    tables = [rng.standard_normal(s).astype(np.float32)
              for s in ((72, 2), (50, 50), (230, 2), (4, 4))]
    fused = adv_ops.fuse_tables(tables, dev)
    rows = torch.from_numpy(rng.integers(0, n_rows, 2048).astype(np.int32)
                            ).to(dev)
    cases["adv_gather_packed_rows"] = (
        lambda: adv_ops.adv_gather_packed_rows(flat, wmeta, fused, rows),
        lambda: adv_ref.adv_gather_packed_rows_ref(
            flat.cpu(), wmeta.cpu(), adv_ops.fuse_tables(tables, "cpu"),
            rows.cpu()), "equal")
    table = torch.from_numpy(rng.standard_normal((999, 1), dtype=np.float32)
                             ).to(dev)
    codes = torch.from_numpy(rng.integers(0, 999, 1 << 25).astype(np.int32)
                             ).to(dev)
    cases["adv_gather"] = (lambda: adv_ops.adv_gather(table, codes),
                           lambda: adv_ref.adv_gather_ref(codes.cpu(),
                                                          table.cpu()),
                           "equal")
    for c, n, k, f in GRADIENT_SHAPES:
        cards = (50, 4) if (c, k) == (2, 50) else (k,) * c
        wc = torch.from_numpy(np.stack([rng.integers(0, kc, n)
                                        for kc in cards]).astype(np.int32)
                              ).to(dev)
        g = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32)
                             ).to(dev)
        cases[f"onehot_wide_backward {(c, n, k, f)}"] = (
            lambda wc=wc, g=g, k=k: wide_ops.onehot_wide_backward(wc, g, k),
            lambda wc=wc, g=g, k=k: wide_ref.onehot_wide_backward_ref(
                wc.cpu(), g.cpu(), k),
            wide_ref.backward_sum_bound(wc.cpu(), g.cpu(), k))
    return cases


def run_turn(tree: Path, seed: int) -> None:
    """One version's turn: a JSON line per kernel on stdout."""
    sys.path[0] = str(tree / "src")
    import numpy as np
    import torch
    timers = _timers()
    dev = torch.device("cuda")
    flush = torch.empty(timers.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name, (call, plain, check) in _cases(np.random.default_rng(seed),
                                             dev).items():
        got = call()
        torch.cuda.synchronize()
        got, want = got.cpu(), plain()
        within = isinstance(check, str) or bool(
            ((got.double() - want.double()).abs() <= check.double()).all())
        print(json.dumps({
            "kernel": name, "equal": torch.equal(got, want),
            "within_bound": within,
            "digest": hashlib.sha256(got.numpy().tobytes()).hexdigest(),
            "ms": timers.time_ms(call, iters=50, reps=15, queue_ahead=True),
            "cold_ms": timers.time_cold_ms(call, flush, launches=50),
            "device_us": device_us(call)}), flush=True)
    one = torch.zeros(1, device=dev)
    print(json.dumps({"kernel": "one-element fill",
                      "device_us": device_us(one.zero_)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:
        run_turn(args.tree.resolve(), args.seed)
        return
    if args.base is None:
        ap.error("--base DIR is required")
    turns = (("earlier", args.base.resolve()), ("this", THIS),
             ("this", THIS), ("earlier", args.base.resolve()))
    digests = {}
    for turn, (label, tree) in enumerate(turns):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--tree", str(tree), "--seed", str(args.seed)],
                             capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"compare_versions: the {label} version's turn "
                             f"failed:\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            name = r["kernel"]
            if "ms" not in r:
                print(f"{name} turn {turn} {label}: {r['device_us']:.3f} us "
                      "of device time a call (torch.profiler)", flush=True)
                continue
            exact = name.startswith("adv_gather") or label == "this"
            if not (r["equal"] if exact else r["within_bound"]):
                raise SystemExit(f"compare_versions: {name}, {label} "
                                 "version: differs from its plain version")
            if name.startswith("adv_gather") and \
                    digests.setdefault(name, r["digest"]) != r["digest"]:
                raise SystemExit(f"compare_versions: {name}: the two "
                                 "versions disagree")
            print(f"{name} turn {turn} {label}: {r['ms']:.6f} ms back to "
                  f"back, {r['cold_ms']:.6f} ms after an L2 flush, "
                  f"{r['device_us']:.3f} us of device time a call "
                  f"(torch.profiler)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
