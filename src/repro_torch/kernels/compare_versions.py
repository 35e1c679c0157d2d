"""Same-run A/B of the kernels this checkout rewrote against an earlier
checkout's, on one card:

    python3 src/repro_torch/kernels/compare_versions.py --base DIR [--seed S]
                                                        [--only NAME ...]

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
of a fill of its output (``zero_``, the least time to write those bytes)
and of a one-element fill, the least a launch takes. ``--only`` keeps the
cases whose first word (the kernel's wrapper) is one of its words. The
shapes:

- the predicate scan over a 2**25-row random stream at device widths
  8/8/8/2 (27,262,976 words) at the pushdown path's two term shapes: P1, a
  range on an 8-bit column AND a 72-entry LUT on another (``predicate_scan
  P1``), and P2, a 4-entry LUT on the 2-bit column OR a 230-entry LUT on an
  8-bit one (``predicate_scan P2``);
- the packed-rows gather: 2,048 rows (the serving path's launch) against
  the same stream and the serving plan's tables, 72 x 2, 50 x 50, 230 x 2
  and 4 x 4 (out_dim 58);
- the range gather at :data:`RANGE_SHAPES`, against the same stream and
  tables: 1 range x 4,096 rows (``FeatureExecutor.batches(4096)``'s
  launch, out_dim 58), and two synthetic shapes that no path launches: 16
  ranges x 512 rows at random aligned starts (out_dim 58), and 1 range x
  1,024 rows of the 72 x 2 and 230 x 2 tables (out_dim 4);
- the int32 gather: (4, 512) codes against the same tables (the int32
  service's launch) and (2, 1,024) codes against 72 x 2 and 230 x 2
  (out_dim 4, the train step's);
- the single-table gather: ``zscore``'s (999, 1) float32 table by 2**25
  codes;
- the masked counts over the same stream: the 2-bit column, k = 4, under a
  52% random mask (``masked_counts groupby_where``, the shape of
  ``groupby_where("device", P2)``), and an 8-bit column, k = 230, under a
  0.44% one (``masked_counts agg_where``, of ``agg_where(P1, "income")``);
- the wide forward at :data:`FORWARD_SHAPES`: the train shape (codes of
  ``state`` below 50 and of ``device`` below 4) and the JAX sweep's;
- the wide gradient at :data:`GRADIENT_SHAPES`: the train shape (codes of
  ``state`` below 50 and of ``device`` below 4), the JAX sweep's shape,
  the train shape's columns at more rows, and the edge sets' grouped
  shapes.

The scan, mask and count, the masked counts, the wide forward and the
gathers must equal their plain versions, and the two versions each other,
bit for bit; the gradient of this checkout must equal the CPU's bit for
bit, the earlier one (float atomics) be within ``backward_sum_bound`` of
it. One line per kernel and turn, then the card's name and power limit.
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
# (ranges, rows a range, the plan's tables) of the range gather: the
# iterator's batch, then two synthetic shapes (16 ranges; out_dim 4)
RANGE_SHAPES = ((1, 4096, (0, 1, 2, 3)), (16, 512, (0, 1, 2, 3)),
                (1, 1024, (0, 2)))
# (C, N, K, F) of the wide forward: the train shape and the JAX sweep's
FORWARD_SHAPES = ((2, 1024, 50, 1), (2, 256, 600, 128))
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
    from repro_torch.kernels.predicate_scan import ops as scan_ops
    from repro_torch.kernels.predicate_scan import ref as scan_ref
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
    flat_cpu, wmeta_cpu = flat.cpu(), wmeta.cpu()
    dbs_cpu = wmeta_cpu[:, 1].tolist()
    for k, batch, plan in RANGE_SHAPES:
        fused_r = adv_ops.fuse_tables([tables[c] for c in plan], dev)
        wmeta_r = wmeta[list(plan)].contiguous()
        starts = torch.from_numpy(rng.integers(0, n_rows // batch, k)
                                  .astype(np.int32) * batch).to(dev)
        cases[f"adv_gather_packed {k} x {batch} out_dim {fused_r.out_dim}"] = (
            lambda fused_r=fused_r, wmeta_r=wmeta_r, starts=starts,
            batch=batch: adv_ops.adv_gather_packed(flat, wmeta_r, fused_r,
                                                   starts, batch),
            lambda plan=plan, wmeta_r=wmeta_r, starts=starts, batch=batch:
                adv_ref.adv_gather_packed_ref(
                    flat_cpu, wmeta_r.cpu(), adv_ops.fuse_tables(
                        [tables[c] for c in plan], "cpu"), starts.cpu(),
                    batch), "equal")

    def lut(size, on):
        return (np.arange(size) < on)[rng.permutation(size)].astype(np.int32)
    p1 = [scan_ops.ScanTerm(col=1, kind=0, lo=19, hi=19),
          scan_ops.ScanTerm(col=0, kind=1, lut=lut(72, 16))]
    p2 = [scan_ops.ScanTerm(col=3, kind=1, lut=np.array([0, 1, 0, 1],
                                                         np.int32)),
          scan_ops.ScanTerm(col=2, kind=1, lut=lut(230, 10))]
    for name, terms, combine in (("P1", p1, "and"), ("P2", p2, "or")):
        packed = scan_ops.pack_terms(terms, dbs_cpu, dev)
        packed_cpu = scan_ops.pack_terms(terms, dbs_cpu, "cpu")
        cases[f"predicate_scan {name}"] = (
            lambda packed=packed, combine=combine: scan_ops.predicate_scan(
                flat, wmeta, packed, n_rows, combine),
            lambda packed=packed_cpu, combine=combine:
                scan_ref.predicate_scan_ref(flat_cpu, wmeta_cpu, packed,
                                            n_rows, combine), "equal")
    for shape, plan in (((4, 512), tables),
                        ((2, 1024), [tables[0], tables[2]])):
        fused_m = adv_ops.fuse_tables(plan, dev)
        codes_m = torch.from_numpy(np.stack([
            rng.integers(0, t.shape[0], shape[1]) for t in plan])
            .astype(np.int32)).to(dev)
        cases[f"gather_fused_parts {shape} out_dim {fused_m.out_dim}"] = (
            lambda fused_m=fused_m, codes_m=codes_m:
                adv_ops.gather_fused_parts(fused_m, codes_m),
            lambda plan=plan, codes_m=codes_m: adv_ref.gather_fused_parts_ref(
                adv_ops.fuse_tables(plan, "cpu"), codes_m.cpu()), "equal")
    table = torch.from_numpy(rng.standard_normal((999, 1), dtype=np.float32)
                             ).to(dev)
    codes = torch.from_numpy(rng.integers(0, 999, 1 << 25).astype(np.int32)
                             ).to(dev)
    cases["adv_gather"] = (lambda: adv_ops.adv_gather(table, codes),
                           lambda: adv_ref.adv_gather_ref(codes.cpu(),
                                                          table.cpu()),
                           "equal")
    from repro_torch.kernels.hist import ops as hist_ops
    from repro_torch.kernels.hist import ref as hist_ref
    for label, col, k, share in (("groupby_where", 3, 4, 0.52),
                                 ("agg_where", 2, 230, 0.0044)):
        mask = torch.from_numpy(rng.random(n_rows) < share).to(dev)
        mask_cpu, off, db = mask.cpu(), offs[col], dbs[col]
        cases[f"masked_counts {label} ({db}-bit, k = {k})"] = (
            lambda mask=mask, off=off, db=db, k=k: hist_ops.masked_counts(
                flat, off, db, mask, k, n_rows),
            lambda mask=mask_cpu, off=off, db=db, k=k:
                hist_ref.masked_counts_ref(flat_cpu, off, db, mask, k,
                                           n_rows), "equal")
    for c, n, k, f in FORWARD_SHAPES:
        cards = (50, 4) if (c, k) == (2, 50) else (k,) * c
        wc = torch.from_numpy(np.stack([rng.integers(0, kc, n)
                                        for kc in cards]).astype(np.int32)
                              ).to(dev)
        w = torch.from_numpy(rng.standard_normal((c, k, f), dtype=np.float32)
                             ).to(dev)
        cases[f"onehot_wide {(c, n, k, f)}"] = (
            lambda wc=wc, w=w: wide_ops.onehot_wide(wc, w),
            lambda wc=wc, w=w: wide_ref.onehot_wide_ref(wc.cpu(), w.cpu()),
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


def run_turn(tree: Path, seed: int, only) -> None:
    """One version's turn: a JSON line per kernel on stdout."""
    sys.path[0] = str(tree / "src")
    import numpy as np
    import torch
    timers = _timers()
    dev = torch.device("cuda")
    flush = torch.empty(timers.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name, (call, plain, check) in _cases(np.random.default_rng(seed),
                                             dev).items():
        if only and name.split()[0] not in only:
            continue
        got = call()
        torch.cuda.synchronize()
        want = plain()
        fill = torch.empty_like(got[0] if isinstance(got, tuple) else got)
        if isinstance(got, tuple):       # the scan's (mask, count)
            equal = torch.equal(got[0].cpu(), want[0]) and \
                int(got[1]) == int(want[1])
            digest = hashlib.sha256(got[0].cpu().numpy().tobytes()
                                    + str(int(got[1])).encode())
        else:
            got = got.cpu()
            equal = torch.equal(got, want)
            digest = hashlib.sha256(got.numpy().tobytes())
        exact = isinstance(check, str)
        within = exact or bool(
            ((got.double() - want.double()).abs() <= check.double()).all())
        print(json.dumps({
            "kernel": name, "equal": equal, "exact": exact,
            "within_bound": within, "digest": digest.hexdigest(),
            "ms": timers.time_ms(call, iters=50, reps=15, queue_ahead=True),
            "cold_ms": timers.time_cold_ms(call, flush, launches=50),
            "device_us": device_us(call),
            "fill_us": device_us(fill.zero_)}), flush=True)
    one = torch.zeros(1, device=dev)
    print(json.dumps({"kernel": "one-element fill",
                      "device_us": device_us(one.zero_)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="*", default=[])
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:
        run_turn(args.tree.resolve(), args.seed, args.only)
        return
    if args.base is None:
        ap.error("--base DIR is required")
    turns = (("earlier", args.base.resolve()), ("this", THIS),
             ("this", THIS), ("earlier", args.base.resolve()))
    digests = {}
    for turn, (label, tree) in enumerate(turns):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--tree", str(tree), "--seed", str(args.seed),
                              "--only", *args.only],
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
            if not (r["equal"] if r["exact"] or label == "this"
                    else r["within_bound"]):
                raise SystemExit(f"compare_versions: {name}, {label} "
                                 "version: differs from its plain version")
            if r["exact"] and \
                    digests.setdefault(name, r["digest"]) != r["digest"]:
                raise SystemExit(f"compare_versions: {name}: the two "
                                 "versions disagree")
            print(f"{name} turn {turn} {label}: {r['ms']:.6f} ms back to "
                  f"back, {r['cold_ms']:.6f} ms after an L2 flush, "
                  f"{r['device_us']:.3f} us of device time a call "
                  f"(torch.profiler; a fill of its output "
                  f"{r['fill_us']:.3f} us)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
