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
2. kernels vs plain — each of the five CUDA kernels (three ADV gathers,
   the predicate scan, the masked counts) against its plain PyTorch version
   on the card, bit for bit, at the shapes the main path gives it and on
   an edge-case set (widths 1-32, codes past every table, rows past the
   stream, n off every multiple of 32, empty and full selections, LUT
   clamps, k = 1, codes >= k, k past the shared-memory counters); median
   times of both, the kernels' both back to back and after an L2 flush.
3. serving path — with every launch count set to 0 first: a FeatureService
   over the packed plan serves 4,096 requests of 128/256/512 uniform random
   rows; FeatureExecutor.batches(4096) serves 64 block-shuffled range
   batches; a FeatureService over the int32 plan serves 512 requests.
   Sampled results (>= 10,000 rows each) must equal the plan's numpy
   reference ``host_features`` bit for bit, and every gather kernel must
   have launched.
4. pushdown path — launch counts set to 0 again; on the same packed plan
   and executor: count_where, filtered_rows, batch_where, groupby_where and
   agg_where of two predicates (AND and OR; range and LUT terms), and a
   FeatureService serving submit(where=...) among 256 plain requests. Each
   result must equal the numpy host reference over the whole table
   (``query.predicate_mask_host``, ``np.bincount`` over the host codes,
   ``host_features``), whose time is printed beside the card's; the scan
   and the masked counts must have launched.
5. report — one JSON line per the kernel table, the nvidia-smi line, and
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
COLD_SPIN_CYCLES = 2_000_000       # ~1 ms: covers one launch and a flush
L2_FLUSH_BYTES = 128 << 20         # written before each cold launch
ADV_SOURCE = "src/repro_torch/kernels/adv_gather/adv_gather.cu"
SOURCES = {"adv_gather_packed_rows": ADV_SOURCE,
           "adv_gather_packed": ADV_SOURCE,
           "gather_fused_parts": ADV_SOURCE,
           "predicate_scan":
           "src/repro_torch/kernels/predicate_scan/predicate_scan.cu",
           "masked_counts": "src/repro_torch/kernels/hist/hist.cu"}
REPLACES = {"adv_gather_packed_rows": "src/repro/kernels/adv_gather/kernel.py:111",
            "adv_gather_packed": "src/repro/kernels/adv_gather/kernel.py:69",
            "gather_fused_parts": "src/repro/kernels/adv_gather/kernel.py:41",
            "predicate_scan": "src/repro/kernels/predicate_scan/kernel.py:37",
            "masked_counts": "src/repro/kernels/hist/kernel.py:53"}


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


def time_cold_ms(fn, flush: torch.Tensor, launches: int) -> float:
    """Median time of one call with the L2 cache flushed before it (a write
    over ``flush``, larger than the 50 MB L2): what a caller that finds its
    inputs in HBM waits for. Each call is queued behind a short spin kernel
    and the flush, and timed alone by CUDA events."""
    fn()
    times = []
    for _ in range(launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(g, w):
        fail(f"{name}: kernel differs from its plain version "
             f"(shapes {g.shape} vs {w.shape}, {g.dtype} vs {w.dtype})")
    return float(np.abs(g.astype(np.float64) - w).max()) if g.size else 0.0


def gather_edge_cases(ec, ops, ref, dev, rng) -> dict[str, float]:
    """Widths 1-32 mixed across columns, random words (codes past every
    table, 32-bit fields past 2**31), rows at word boundaries and past the
    stream, negative and oversized int32 codes."""
    cards, dims, cap = (2, 3, 11, 200, 3000, 1000), (1, 3, 2, 5, 2, 1), 4096
    tables = [rng.standard_normal((k, f)).astype(np.float32)
              for k, f in zip(cards, dims)]
    flat, wmeta, _ = ec.random_stream(rng, cap, dev)
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


def pushdown_edge_cases(ec, scan_ops, scan_ref, hist_ops, hist_ref, dev,
                        rng) -> dict[str, float]:
    """The scan: ``ec.scan_term_sets`` (both kinds at widths 1-32 over
    random words, two terms on one column, LUT clamps, empty and full
    selections) under AND and OR, n off every multiple of 4 and 32 against
    a longer stream (the count covers [0, n) only). The masked counts:
    ``ec.masked_counts_cases`` (every width, k = 1, codes >= k, all-false /
    all-true / random masks, k at the shared-memory limit and past it)."""
    cap = 4096
    flat, wmeta, _ = ec.random_stream(rng, cap, dev)
    err = {"predicate_scan": 0.0, "masked_counts": 0.0}
    for i, terms in enumerate(ec.scan_term_sets(rng)):
        packed = scan_ops.pack_terms(terms, ec.DBS, dev)
        for combine in ("and", "or"):
            for n in (1, 33, 4001, cap):
                mask, count = scan_ops.predicate_scan(flat, wmeta, packed, n,
                                                      combine)
                want, want_count = scan_ref.predicate_scan_ref(
                    flat, wmeta, packed, n, combine)
                name = f"predicate_scan edge set {i} {combine} n={n}"
                err["predicate_scan"] = max(err["predicate_scan"],
                                            check_equal(name, mask, want))
                if not int(count) == int(want_count) == int(want.sum()):
                    fail(f"{name}: count {int(count)} vs {int(want_count)}")
    cases, masks = ec.masked_counts_cases(rng, cap, dev)
    for words, off, db, k in cases:
        for j, mask in enumerate(masks):
            for n in (4001, cap):
                err["masked_counts"] = max(err["masked_counts"], check_equal(
                    f"masked_counts edge set db={db} k={k} mask {j} n={n}",
                    hist_ops.masked_counts(words, off, db, mask, k, n),
                    hist_ref.masked_counts_ref(words, off, db, mask, k, n)))
    return err


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

    measure(out, iters=50, plain_iters=5)
    return out


def measure(kernels: dict, iters: int, plain_iters: int) -> None:
    """Check each kernel against its plain version, then time both and
    derive the byte bound. ``ms`` times launches back to back, where
    inputs that fit in L2 stay there between launches; ``cold_ms`` times
    single launches after an L2 flush."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for name, k in kernels.items():
        got, want = k["call"](), k["plain"]()
        if isinstance(got, tuple):       # the scan's (mask, count)
            if int(got[1]) != int(want[1]):
                fail(f"{name} at the main path's shape: count "
                     f"{int(got[1])} vs {int(want[1])}")
            got, want = got[0], want[0]
        k["max_abs_err"] = check_equal(f"{name} at the main path's shapes",
                                       got, want)
        k["ms"] = time_ms(k["call"], iters=iters, reps=15, queue_ahead=True)
        k["cold_ms"] = time_cold_ms(k["call"], flush, launches=iters)
        k["plain_ms"] = time_ms(k["plain"], iters=plain_iters, reps=7,
                                queue_ahead=False)
        k["bound_ms"] = k["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"  {name} [{k['shape']}]: kernel {k['ms']:.6f} ms back to "
            f"back, {k['cold_ms']:.6f} ms after an L2 flush, plain "
            f"{k['plain_ms']:.6f} ms, bound {k['bound_ms']:.6f} ms "
            f"({k['bytes']} B at 3.35 TB/s)")


def pushdown_shape_kernels(scan_ops, scan_ref, hist_ops, hist_ref, ex_p,
                           plan_p, n_rows, p_scan, p_mask,
                           group_col: str) -> dict[str, dict]:
    """Both pushdown kernels at the pushdown path's shapes: the scan of
    ``p_scan`` over the whole resident table, and the masked counts of
    ``group_col`` under ``p_mask``'s mask (the groupby_where call).
    The scan's bytes: every word of each column a term reads, one mask
    byte per row, the term table and LUTs, the count. The counts' bytes:
    the words holding at least one selected row, one mask byte per row,
    4k bytes out."""
    flat, wmeta = ex_p._flat_words, ex_p._wmeta
    dbs = plan_p.device_bits
    _, comb1, packed1 = ex_p._compiled_pred(p_scan)
    _, comb2, packed2 = ex_p._compiled_pred(p_mask)
    mask2, _ = scan_ops.predicate_scan(flat, wmeta, packed2, n_rows, comb2)
    ci = plan_p.columns.index(group_col)
    off, db = ex_p._word_offs[ci], dbs[ci]
    k = ex_p._dictionary(group_col).cardinality
    s = 32 // db
    padded = torch.nn.functional.pad(mask2.to(torch.uint8), (0, -n_rows % s))
    words_needed = int(padded.view(-1, s).any(1).sum())
    out = {}
    out["predicate_scan"] = dict(
        call=lambda: scan_ops.predicate_scan(flat, wmeta, packed1, n_rows,
                                             comb1),
        plain=lambda: scan_ref.predicate_scan_ref(flat, wmeta, packed1,
                                                  n_rows, comb1),
        bytes=sum(4 * -(-n_rows // (32 // dbs[c])) for c in set(packed1.cols))
        + n_rows + packed1.nbytes + 4,
        shape=f"{packed1.n_terms} terms ({comb1}) over columns "
        f"{sorted(set(packed1.cols))} x {n_rows} rows")
    out["masked_counts"] = dict(
        call=lambda: hist_ops.masked_counts(flat, off, db, mask2, k, n_rows),
        plain=lambda: hist_ref.masked_counts_ref(flat, off, db, mask2, k,
                                                 n_rows),
        bytes=4 * words_needed + n_rows + 4 * k,
        shape=f"{group_col} ({db}-bit, k={k}) x {n_rows} rows, "
        f"{int(mask2.sum())} selected")
    measure(out, iters=20, plain_iters=2)
    return out


# -- phase 3 ------------------------------------------------------------------


def drive_service(svc, reqs, window: int, sample_every: int):
    """Closed-loop client: keep ``window`` requests outstanding; returns
    the wall seconds and the sampled (request, features) pairs. A request
    is an array of rows or a predicate (``submit(where=...)``)."""
    pending = deque()
    sampled = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        ticket = svc.submit(r) if isinstance(r, np.ndarray) \
            else svc.submit(where=r)
        pending.append((i, r, ticket))
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


# -- phase 4 ------------------------------------------------------------------


def clocked(fn, reps: int = 3):
    """(last result, median seconds) of ``reps`` calls, each closed by a
    device synchronise: the wall a caller waits for the answer."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def host_clock(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def compiled_kinds(ex, preds: dict) -> None:
    """Print each predicate's compiled term kinds; fail unless together
    they cover both kinds (range, LUT) and both combinators."""
    kinds, combines = set(), set()
    for name, pred in preds.items():
        terms, combine, _ = ex._compiled_pred(pred)
        log(f"  {name} = {pred!r}: {combine} of term kinds "
            f"{[t.kind for t in terms]}")
        kinds |= {t.kind for t in terms}
        combines.add(combine)
    if kinds != {0, 1} or combines != {"and", "or"}:
        fail(f"predicates cover kinds {kinds} and combinators {combines}; "
             "both of each are needed")


def pushdown_path(Q, FeatureService, ex, plan, table, p1, p2, group_col,
                  agg_col, svc_kw, plain_reqs) -> None:
    """Every pushdown entry point on the resident table, each result held
    against the numpy host reference over the whole table; card and host
    times side by side (card: median of 3 calls, each synchronised)."""
    n = plan.n_rows
    h1, th1 = host_clock(lambda: Q.predicate_mask_host(table, p1))
    h2, th2 = host_clock(lambda: Q.predicate_mask_host(table, p2))
    rows1, tr1 = host_clock(lambda: np.flatnonzero(h1))
    for name, pred, h, th in (("P1", p1, h1, th1), ("P2", p2, h2, th2)):
        cnt, t = clocked(lambda: ex.count_where(pred))
        if cnt != int(h.sum()):
            fail(f"count_where({name}) = {cnt}, host {int(h.sum())}")
        log(f"count_where({name}): {cnt} of {n} rows in {t:.6f} s = "
            f"{n / t:.1f} rows scanned/s; host predicate_mask_host "
            f"{th:.6f} s")
    rows, t = clocked(lambda: ex.filtered_rows(p1))
    if not np.array_equal(rows, rows1):
        fail("filtered_rows(P1) differs from the host mask's rows")
    log(f"filtered_rows(P1): {rows.size} rows in {t:.6f} s = "
        f"{n / t:.1f} rows scanned/s; host mask + flatnonzero "
        f"{th1 + tr1:.6f} s")
    feats_h, tf = host_clock(lambda: plan.host_features(rows1))
    (brows, feats), t = clocked(lambda: ex.batch_where(p1))
    if not (np.array_equal(brows, rows1)
            and np.array_equal(feats.cpu().numpy(), feats_h)):
        fail("batch_where(P1) differs from host_features of the host rows")
    log(f"batch_where(P1): {brows.size} rows x {plan.out_dim} in {t:.6f} s "
        f"= {brows.size / t:.1f} matched rows/s; host mask + flatnonzero + "
        f"host_features {th1 + tr1 + tf:.6f} s; all {brows.size} rows "
        "bit-exact")
    (vals, counts), t = clocked(lambda: ex.groupby_where(group_col, p2))
    d = ex._dictionary(group_col)
    codes, tc = host_clock(lambda: table[group_col].codes())
    want, tb = host_clock(
        lambda: np.bincount(codes[h2], minlength=d.cardinality))
    if not (np.array_equal(vals, d.values) and np.array_equal(counts, want)):
        fail(f"groupby_where({group_col}, P2) differs from the host bincount")
    log(f"groupby_where({group_col}, P2): {dict(zip(vals.tolist(), counts.tolist()))} "
        f"in {t:.6f} s; host mask + codes + bincount {th2 + tc + tb:.6f} s")
    mean, t = clocked(lambda: ex.agg_where(p1, agg_col, "mean"))
    da = ex._dictionary(agg_col)
    acodes, tc = host_clock(lambda: table[agg_col].codes())
    ca, tb = host_clock(
        lambda: np.bincount(acodes[h1], minlength=da.cardinality))
    want_mean = float(np.dot(da.values.astype(np.float64),
                             ca.astype(np.float64))) / float(ca.sum())
    if mean != want_mean:
        fail(f"agg_where(P1, {agg_col}, mean) = {mean!r}, host {want_mean!r}")
    log(f"agg_where(P1, {agg_col}, mean): {mean!r} in {t:.6f} s; host mask "
        f"+ codes + bincount {th1 + tc + tb:.6f} s")

    reqs = list(plain_reqs)
    for at in (len(reqs) * 3 // 4, len(reqs) // 4):
        reqs.insert(at, p1)
    with FeatureService(plan, **svc_kw) as svc:
        wall, served = drive_service(svc, reqs, window=16, sample_every=1)
        st = svc.throughput_stats(wall)
        lat = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = svc.result(svc.submit(where=p1), timeout=120)
            lat.append(time.perf_counter() - t0)
            served.append((p1, got))
        filtered = svc.stats["filtered_requests"]
    if filtered != 5:
        fail(f"service counted {filtered} filtered requests, not 5")
    checked = 0
    for r, got in served:
        want = feats_h if r is p1 else plan.host_features(r)
        if got.shape != want.shape or not np.array_equal(got, want):
            fail("served features differ from host_features")
        checked += got.shape[0]
    log(f"service, {len(plain_reqs)} plain requests + 2 x submit(where=P1): "
        f"{st['requests']} requests, {st['rows']} rows in {wall:.6f} s = "
        f"{st['rows_per_s']:.1f} rows/s, {st['launches']} launches; then "
        f"submit(where=P1) -> result alone: median "
        f"{statistics.median(lat) * 1e3:.4f} ms over 3 ({rows1.size} rows); "
        f"host mask + flatnonzero + host_features {th1 + tr1 + tf:.6f} s; "
        f"{checked} served rows bit-exact")


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
    from repro_torch.columnar import query as Q
    from repro_torch.core import FeatureExecutor, FeaturePlan, FeatureSet
    from repro_torch.kernels import build
    from repro_torch.kernels import edge_cases as ec
    from repro_torch.kernels.adv_gather import ops, ref
    from repro_torch.kernels.hist import ops as hist_ops, ref as hist_ref
    from repro_torch.kernels.predicate_scan import ops as scan_ops
    from repro_torch.kernels.predicate_scan import ref as scan_ref
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

    # the pushdown path's predicates, over the load-order dictionaries
    p1 = Q.eq("state", 7) & Q.between("age", 30, 45)
    p2 = Q.isin("device", [1, 3]) | Q.ge("income", 240000)
    log("pushdown predicates:")
    compiled_kinds(ex_p, {"P1": p1, "P2": p2})

    # -- 2. kernels vs plain ----------------------------------------------------
    log("kernels vs plain versions (bit for bit):")
    errs = gather_edge_cases(ec, ops, ref, dev,
                             np.random.default_rng(args.seed + 1))
    errs.update(pushdown_edge_cases(ec, scan_ops, scan_ref, hist_ops,
                                    hist_ref, dev,
                                    np.random.default_rng(args.seed + 4)))
    log(f"  edge cases equal: {sorted(errs)}")
    coalesce, bucket, range_batch = 4, 512, 4096
    kernels = main_shape_kernels(ops, ref, ex_p, plan_p, plan_i, n_rows,
                                 np.random.default_rng(args.seed + 2),
                                 coalesce * bucket, range_batch, bucket)
    kernels.update(pushdown_shape_kernels(scan_ops, scan_ref, hist_ops,
                                          hist_ref, ex_p, plan_p, n_rows, p1,
                                          p2, "device"))

    # -- 3. serving path ---------------------------------------------------------
    req_rng = np.random.default_rng(args.seed + 3)
    sizes = (128, 256, 512)
    packed_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                   for _ in range(4096)]
    int32_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                  for _ in range(512)]
    pushdown_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                     for _ in range(256)]
    torch.cuda.reset_peak_memory_stats()
    for counter in (ops, scan_ops, hist_ops):
        counter.reset_launches()

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
    log(f"kernels launched on the serving path: {launches}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the serving path: {idle}")

    # -- 4. pushdown path ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    for counter in (ops, scan_ops, hist_ops):
        counter.reset_launches()
    pushdown_path(Q, FeatureService, ex_p, plan_p, table, p1, p2, "device",
                  "income", dict(prefetch=2, buckets=(bucket,),
                                 coalesce=coalesce), pushdown_reqs)
    pushed = {**scan_ops.LAUNCHES, **hist_ops.LAUNCHES}
    log(f"kernels launched on the pushdown path: "
        f"{dict(**pushed, **ops.LAUNCHES)}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in pushed.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the pushdown path: {idle}")
    launches.update(pushed)

    # -- 5. report ------------------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max(k["max_abs_err"], errs[name]), "ms": k["ms"],
         "cold_ms": k["cold_ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": "bytes", "library_ms": None}
        for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
