#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed S] [--rows-log2 25]

Run from the root of a checkout; it builds the CUDA kernels from the
checkout's sources (into build/torch_ext/) and needs one card. Phases:

1. setup — the card's name and power limit, versions, the kernels' build
   time, and the host build of the serving table: the columns and features
   of ``benchmarks/bench_featurize.py`` (age/state/income/device; out_dim
   58; device widths 8/8/8/2) at 2**25 rows, a user table a feature store
   serves, made from ``--seed``.
2. kernels vs plain — each CUDA kernel against its plain PyTorch version
   on the card, bit for bit, at the shapes the main path gives it and on
   an edge-case set (widths 1-32, codes past every table, rows past the
   stream); median times of both.
3. main path — with every launch count set to 0 first: a FeatureService
   over the packed plan serves 4,096 requests of 128/256/512 uniform random
   rows; FeatureExecutor.batches(4096) serves 64 block-shuffled range
   batches; a FeatureService over the int32 plan serves 512 requests.
   Sampled results (>= 10,000 rows each) must equal the plan's numpy
   reference ``host_features`` bit for bit, and every kernel must have
   launched.
4. report — one JSON line per the kernel table, the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. Without CUDA, or
without the package beside this script, it exits nonzero at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published peak
SPIN_CYCLES = 50_000_000           # ~25 ms at 2 GHz: covers 50 launches
SOURCE = "src/repro_torch/kernels/adv_gather/adv_gather.cu"
REPLACES = {"adv_gather_packed_rows": "src/repro/kernels/adv_gather/kernel.py:111",
            "adv_gather_packed": "src/repro/kernels/adv_gather/kernel.py:69",
            "gather_fused_parts": "src/repro/kernels/adv_gather/kernel.py:41"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, reps: int, queue_ahead: bool) -> float:
    """Median over ``reps`` runs of the per-call time of ``iters`` calls,
    by CUDA events (after one warm-up call). ``queue_ahead`` parks the
    stream on a spin kernel first, so all ``iters`` launches are queued
    before the first runs: the events then time the kernels back to back,
    not the host's launch overhead. The plain versions synchronise inside
    (they read metadata on the host), so they are timed as called."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def words_touched(rows: np.ndarray, wmeta: np.ndarray) -> int:
    """Distinct packed words the rows read, over all columns."""
    rows = rows.astype(np.int64)
    return sum(np.unique(off + rows // (32 // db)).size
               for off, db in wmeta.tolist())


# -- phase 1 ------------------------------------------------------------------


def serving_data(rng: np.random.Generator, n: int) -> dict:
    return {"age": rng.integers(18, 90, n),
            "state": rng.integers(0, 50, n),
            "income": rng.integers(20, 250, n) * 1000,
            "device": rng.integers(0, 4, n)}


def serving_features(fs_cls):
    return (fs_cls().add("age", "zscore")
            .add("age", "bucketize", boundaries=(30.0, 45.0, 65.0))
            .add("state", "onehot")
            .add("income", "minmax").add("income", "log")
            .add("device", "onehot"))


# -- phase 2 ------------------------------------------------------------------


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not np.array_equal(g, w):
        fail(f"{name}: kernel differs from its plain version "
             f"(shapes {g.shape} vs {w.shape})")
    return float(np.abs(g - w).max()) if g.size else 0.0


def edge_cases(ops, ref, dev, rng) -> dict[str, float]:
    """Widths 1-32 mixed across columns, random words (codes past every
    table, 32-bit fields past 2**31), rows at word boundaries and past the
    stream, negative and oversized int32 codes."""
    dbs, cards, dims, cap = (1, 2, 4, 8, 16, 32), (2, 3, 11, 200, 3000,
                                                   1000), (1, 3, 2, 5, 2, 1), 4096
    tables = [rng.standard_normal((k, f)).astype(np.float32)
              for k, f in zip(cards, dims)]
    words = [rng.integers(0, 1 << 32, cap * db // 32,
                          dtype=np.uint64).astype(np.uint32) for db in dbs]
    offs = [int(o) for o in np.cumsum([0] + [w.size for w in words])[:-1]]
    flat = torch.from_numpy(np.concatenate(words).view(np.int32)).to(dev)
    wmeta = ops.word_meta(offs, dbs, dev)
    fused = ops.fuse_tables(tables, dev)
    rows = np.concatenate([[0, 1, 15, 16, 31, 32, 33, cap - 1, cap,
                            10 ** 9], rng.integers(0, cap, 20000)])
    rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
    starts = torch.tensor([0, 32, 1024, cap - 512], dtype=torch.int32,
                          device=dev)
    codes = torch.from_numpy(np.stack(
        [rng.integers(-5, k + 9, 20000) for k in cards]).astype(np.int32)
    ).to(dev)
    return {
        "adv_gather_packed_rows": check_equal(
            "adv_gather_packed_rows edge cases",
            ops.adv_gather_packed_rows(flat, wmeta, fused, rows),
            ref.adv_gather_packed_rows_ref(flat, wmeta, fused, rows)),
        "adv_gather_packed": check_equal(
            "adv_gather_packed edge cases",
            ops.adv_gather_packed(flat, wmeta, fused, starts, 512),
            ref.adv_gather_packed_ref(flat, wmeta, fused, starts, 512)),
        "gather_fused_parts": check_equal(
            "gather_fused_parts edge cases",
            ops.gather_fused_parts(fused, codes),
            ref.gather_fused_parts_ref(fused, codes)),
    }


def main_shape_kernels(ops, ref, ex_p, plan_p, plan_i, n_rows, rng,
                       rows_n, range_batch, codes_n) -> dict[str, dict]:
    """Each kernel at the main path's shapes: the packed service's launch
    (coalesce x bucket rows against the resident stream), one range batch
    of the iterator, one int32 service launch (C x bucket codes)."""
    dev = plan_p.device
    fused = plan_p.fused_tables()
    flat, wmeta = ex_p._flat_words, ex_p._wmeta
    wmeta_np = wmeta.cpu().numpy()
    tables_bytes = fused.nbytes + 4 * (fused.meta.numel()
                                       + fused.col_of.numel())
    out = {}

    rows_np = rng.integers(0, n_rows, rows_n).astype(np.int32)
    rows = torch.from_numpy(rows_np).to(dev)
    out["adv_gather_packed_rows"] = dict(
        call=lambda: ops.adv_gather_packed_rows(flat, wmeta, fused, rows),
        plain=lambda: ref.adv_gather_packed_rows_ref(flat, wmeta, fused,
                                                     rows),
        bytes=4 * rows_n + 4 * words_touched(rows_np, wmeta_np)
        + tables_bytes + 4 * rows_n * fused.out_dim,
        shape=f"rows ({rows_n},) int32 vs {flat.numel()} resident words")

    start = int(rng.integers(0, n_rows // range_batch)) * range_batch
    starts = torch.tensor([start], dtype=torch.int32, device=dev)
    range_rows = np.arange(start, start + range_batch)
    out["adv_gather_packed"] = dict(
        call=lambda: ops.adv_gather_packed(flat, wmeta, fused, starts,
                                           range_batch),
        plain=lambda: ref.adv_gather_packed_ref(flat, wmeta, fused, starts,
                                                range_batch),
        bytes=4 + 4 * words_touched(range_rows, wmeta_np) + tables_bytes
        + 4 * range_batch * fused.out_dim,
        shape=f"1 range x {range_batch} rows")

    fused_i = plan_i.fused_tables()
    codes = torch.from_numpy(plan_i.host_codes(
        rng.integers(0, n_rows, codes_n))).to(dev)
    out["gather_fused_parts"] = dict(
        call=lambda: ops.gather_fused_parts(fused_i, codes),
        plain=lambda: ref.gather_fused_parts_ref(fused_i, codes),
        bytes=4 * codes.numel() + tables_bytes
        + 4 * codes_n * fused_i.out_dim,
        shape=f"codes {tuple(codes.shape)} int32")

    for name, k in out.items():
        k["max_abs_err"] = check_equal(f"{name} at the main path's shapes",
                                       k["call"](), k["plain"]())
        k["ms"] = time_ms(k["call"], iters=50, reps=15, queue_ahead=True)
        k["plain_ms"] = time_ms(k["plain"], iters=5, reps=7,
                                queue_ahead=False)
        k["bound_ms"] = k["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"  {name} [{k['shape']}]: kernel {k['ms']:.6f} ms, plain "
            f"{k['plain_ms']:.6f} ms, bound {k['bound_ms']:.6f} ms "
            f"({k['bytes']} B at 3.35 TB/s)")
    return out


# -- phase 3 ------------------------------------------------------------------


def drive_service(svc, reqs, window: int, sample_every: int):
    """Closed-loop client: keep ``window`` requests outstanding; returns
    the wall seconds and the sampled (rows, features) pairs."""
    pending = deque()
    sampled = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        pending.append((i, r, svc.submit(r)))
        if len(pending) >= window:
            j, rr, t = pending.popleft()
            got = svc.result(t, timeout=120)
            if j % sample_every == 0:
                sampled.append((rr, got))
    while pending:
        j, rr, t = pending.popleft()
        got = svc.result(t, timeout=120)
        if j % sample_every == 0:
            sampled.append((rr, got))
    return time.perf_counter() - t0, sampled


def busy_share(kernels: dict, name: str, st: dict) -> float:
    """Share of a serving run's wall time its kernel kept the card busy:
    launches x the kernel's measured time at that shape / wall."""
    return st["launches"] * kernels[name]["ms"] / (st["wall_s"] * 1e3)


def check_sample(name: str, plan, sampled) -> int:
    rows = sum(r.size for r, _ in sampled)
    if rows < 10_000:
        fail(f"{name}: only {rows} rows sampled")
    for r, got in sampled:
        if got.shape != (r.size, plan.out_dim) or \
                not np.array_equal(got, plan.host_features(r)):
            fail(f"{name}: served features differ from host_features")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-log2", type=int, default=25)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.columnar import Table
    from repro_torch.core import FeatureExecutor, FeaturePlan, FeatureSet
    from repro_torch.kernels import build
    from repro_torch.kernels.adv_gather import ops, ref
    from repro_torch.serve import FeatureService

    # -- 1. setup ---------------------------------------------------------------
    smi = smi_line()
    log(f"card: {smi} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s ({built})")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    n_rows = 1 << args.rows_log2
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    table = Table.from_data(serving_data(rng, n_rows))
    t1 = time.perf_counter()
    plan_p = FeaturePlan(table, serving_features(FeatureSet), packed=True,
                         device=dev)
    ex_p = FeatureExecutor(plan_p, prefetch=2)
    plan_i = FeaturePlan(table, serving_features(FeatureSet), packed=False,
                         device=dev)
    torch.cuda.synchronize()
    log(f"serving table: {n_rows} rows, columns {plan_p.columns}, out_dim "
        f"{plan_p.out_dim}, device widths {plan_p.device_bits}; table "
        f"build {t1 - t0:.3f} s, plans {time.perf_counter() - t1:.3f} s; "
        f"{ex_p.resident_bytes()} B of packed words resident")
    if plan_p.out_dim != 58 or plan_p.device_bits != [8, 8, 8, 2]:
        fail("serving table does not have the benchmark's widths")

    # -- 2. kernels vs plain ----------------------------------------------------
    log("kernels vs plain versions (bit for bit):")
    errs = edge_cases(ops, ref, dev, np.random.default_rng(args.seed + 1))
    log(f"  edge cases equal: {sorted(errs)}")
    coalesce, bucket, range_batch = 4, 512, 4096
    kernels = main_shape_kernels(ops, ref, ex_p, plan_p, plan_i, n_rows,
                                 np.random.default_rng(args.seed + 2),
                                 coalesce * bucket, range_batch, bucket)

    # -- 3. main path ------------------------------------------------------------
    req_rng = np.random.default_rng(args.seed + 3)
    sizes = (128, 256, 512)
    packed_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                   for _ in range(4096)]
    int32_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                  for _ in range(512)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    with FeatureService(plan_p, prefetch=2, buckets=(bucket,),
                        coalesce=coalesce) as svc:
        wall, sampled = drive_service(svc, packed_reqs, window=16,
                                      sample_every=16)
        st = svc.throughput_stats(wall)
        p50, p99 = svc.latency_percentile(50), svc.latency_percentile(99)
    checked = check_sample("packed service", plan_p, sampled)
    log(f"packed service: {st['requests']} requests, {st['rows']} rows in "
        f"{wall:.6f} s = {st['rows_per_s']:.1f} rows/s; p50 "
        f"{p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms; {st['launches']} "
        f"launches, bytes_h2d {st['bytes_h2d']}; {checked} sampled rows "
        f"bit-exact; {busy_share(kernels, 'adv_gather_packed_rows', st):.6f}"
        " of the wall in the kernel")

    t0 = time.perf_counter()
    n_batches = 0
    kept = []
    for idx, feats in ex_p.batches(range_batch, seed=args.seed):
        if n_batches % 4 == 0:
            kept.append((idx, feats))
        n_batches += 1
        if n_batches == 64:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    checked = check_sample("range batches", plan_p,
                           [(i, f.cpu().numpy()) for i, f in kept])
    log(f"range batches: {n_batches} x {range_batch} rows in {wall:.6f} s "
        f"= {n_batches * range_batch / wall:.1f} rows/s; {checked} sampled "
        "rows bit-exact")

    with FeatureService(plan_i, prefetch=2, buckets=(bucket,)) as svc:
        wall, sampled = drive_service(svc, int32_reqs, window=16,
                                      sample_every=4)
        st = svc.throughput_stats(wall)
        p50, p99 = svc.latency_percentile(50), svc.latency_percentile(99)
    checked = check_sample("int32 service", plan_i, sampled)
    log(f"int32 service: {st['requests']} requests, {st['rows']} rows in "
        f"{wall:.6f} s = {st['rows_per_s']:.1f} rows/s; p50 "
        f"{p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms; {st['launches']} "
        f"launches, bytes_h2d {st['bytes_h2d']}; {checked} sampled rows "
        f"bit-exact; {busy_share(kernels, 'gather_fused_parts', st):.6f} of "
        "the wall in the kernel")
    launches = dict(ops.LAUNCHES)
    log(f"kernels launched on the main path: {launches}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")

    # -- 4. report ------------------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max(k["max_abs_err"], errs[name]), "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": "bytes", "library_ms": None}
        for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
