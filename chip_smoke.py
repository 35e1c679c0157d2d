#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed S] [--rows-log2 25] [--train-steps 500]
                          [--parity-steps 200]

Run from the root of a checkout; it builds the CUDA kernels from the
checkout's sources (into build/torch_ext/) and needs one card. Phases:

1. setup — the card's name and power limit, versions, the kernels' build
   time, and the host build of the serving table: the columns and features
   of ``benchmarks/bench_featurize.py`` (age/state/income/device; out_dim
   58; device widths 8/8/8/2) at 2**25 rows, a user table a feature store
   serves, made from ``--seed``; then the train path's int32 plan over the
   same table with ``benchmarks/bench_pipeline.py``'s FeatureSet (out_dim
   4) and its label rule (noise from ``--seed``); and the Table 6 column
   of ``benchmarks/bench_featurize.py`` (``rng.integers(0, 999, N)``, K =
   999, 10 bits stored at device width 16) at the same 2**25 rows.
2. kernels vs plain — each of the ten CUDA kernels (four ADV gathers, the
   predicate scan, the masked counts, the one-hot wide layer and its
   gradient, the bit-unpack and the counts) against its plain PyTorch
   version on the card, at the shapes the main paths give it and on an
   edge-case set (widths 1-32, codes past every table, rows past the
   stream, n off every multiple of 32, empty and full selections, LUT
   clamps, k = 1, codes >= k, k past the shared-memory counters; for the
   scan column word offsets off every multiple of 4 and n in {1, 15, 16,
   17, 127, 129, 4097, 8193}; for the packed-rows gather out_dims 1, 31,
   33, 58 and 200 at 1, 7, 33 and 5,000 rows; for the int32 gather out_dims
   1, 4, 17, 31, 33, 58 and 200 at 1, 7, 33, 1,024 and 5,000 rows, C = 1
   to 9 and a K = 1 table; for the wide layer C in {0, 1, 8}, N in {0, 1, 33,
   1024}, K in {1, 4, 600, 65537}, F in {1, 129}, codes -1, K, 2**31 - 1,
   -2**31, bf16, and (2, 200,000, 1,000, 64), (2, 8,192, 50, 1) and
   (3, 20,000, 3, 2), where the gradient takes its grouped route; for the
   wide forward F in {1, 2, 3, 4, 8, 128, 129}, C in {0, 1, 2, 8, 33}, N
   in {0, 1, 33, 1024, 1025}, K in {1, 50, 600}, w also as a view 4 bytes
   into a larger tensor, and F 1,024 and 1,030 (rows taken in passes); for
   the masked counts k around 2**db and the
   per-warp bins' 4,096, one code in every row, word offsets off a
   multiple of 4, a mask view one byte in, n around a word; for the
   Table 6 kernels ``edge_cases``' bit-unpack, counts and single-table
   gather sets, the gather also at F in {1, 3, 16, 999} with n in {1, 3,
   5, 4097} and on views not 16-byte aligned). Bit for bit;
   the wide gradient against its plain version run on CPU copies of the
   inputs (``index_add_`` on the card adds with atomics, in no fixed
   order), and bit-equal across two launches. Median
   times of both, the kernels' both back to back and after an L2 flush,
   and where one PyTorch call computes the same function, that call's
   (``embedding_bag`` and its backward for the wide layer, also at the JAX
   sweep's largest shape (2, 256, 600, 128); ``bincount`` for the counts;
   ``index_select`` for the single-table gather). The masked counts are
   timed at both pushdown calls' shapes (groupby_where's in the report).
3. serving path — with every launch count set to 0 first: a FeatureService
   over the packed plan serves 4,096 requests of 128/256/512 uniform random
   rows; FeatureExecutor.batches(4096) serves 64 block-shuffled range
   batches; a FeatureService over the int32 plan serves 512 requests.
   Sampled results (>= 10,000 rows each) must equal the plan's numpy
   reference ``host_features`` bit for bit, and every gather kernel must
   have launched.
3b. front door — launch counts set to 0 again; the workload of
   ``bench_featurize.py``'s ``_frontend_serve_comparison`` on the same
   packed table (one shard; the bench has 128,000 rows): a
   ``FeatureFrontend`` with its three request classes (interactive
   priority 3, coalesce 1; batch priority 2, coalesce 8, linger 1 ms;
   background priority 1, aging 0.05 s, window 16 + 16) takes a
   saturating burst of 360 batch, 120 interactive and 8 background
   64-row Zipf(1.2) blocks; a classless service of the same shape takes
   the same mix as the FIFO control. One warm-up each, then five timed
   runs each, in turns: per-class p50/p99, the FIFO p99, rows/s,
   launches and the kernel's share of the wall. Then the bench's
   admission probe (paused, 64 background submits: some must be
   ``Overloaded``, every admitted one must resolve), three
   ``submit(where=P1, klass="batch")`` among interactive requests, and a
   chaos run (every 5th batch launch fails, every 7th launch stalls 2
   ms; ``FaultPolicy(max_retries=3)``): availability over admitted work
   1.0 and ``retries == faults_injected > 0``. Every run holds every
   second result (>= 10,000 rows) against ``host_features`` bit for bit,
   P1's results whole against the host mask's rows; any failed ticket
   fails the phase (naming a cause that is not an injected fault), as
   does a retry in a fault-free run. Last, one burst through a front door
   over the int32 plan. The packed rows gather, the int32 gather and the
   scan must have launched.
4. pushdown path — launch counts set to 0 again; on the same packed plan
   and executor: count_where, filtered_rows, batch_where, groupby_where and
   agg_where of two predicates (AND and OR; range and LUT terms), and a
   FeatureService serving submit(where=...) among 256 plain requests. Each
   result must equal the numpy host reference over the whole table
   (``query.predicate_mask_host``, ``np.bincount`` over the host codes,
   ``host_features``), whose time is printed beside the card's; the scan
   and the masked counts must have launched.
5. train path (paper Fig 1/2) — launch counts set to 0 again;
   ``bench_pipeline.py`` at full width on the same table: Wide&Deep
   (wide ``state``/``device``, embedded ``state``, hidden (32, 16)), lr
   0.1, batch 1,024. Its ADV and traditional (decode, CSV, parse, ship
   f32) loops, 8 steps each, with walls and host->device bytes; 500 ADV
   steps (steps/s, rows/s, the kernels' share of the wall); the first 200
   of them again on the CPU through the plain versions, each from the
   card's parameters before it and on its batch: losses within
   1e-5 x max(1, |loss|) and parameters after it within allclose(rtol=1e-4,
   atol=1e-6), every step; a step that fails on its whole batch is stepped
   again on both devices without the rows where the card's and the CPU's
   ReLU branches differ, and must then hold at the same tolerances (a
   pre-activation within rounding of zero makes the gradient jump by the
   whole back-propagated term). A CPU run free from the same initial
   parameters is printed beside it, not gated, with the CPU's own split
   from a one-rounding nudge (ReLU kinks part float32 trajectories). The
   int32 gather, the wide layer and its gradient must have launched.
6. analytics cycle (paper §7) — ``examples/analytics_cycle.py`` through
   the port on the card at its own sizes and seeds; its two checks (round 2
   within 1.2x of round 1, purity > 0.75) must hold. Its models have no
   wide columns, so no kernel launches, which is checked.
7. Table 6 on the card (paper Table 6, §6.1-6.3) — launch counts set to 0
   again; ``bench_featurize.py``'s device featurization path at the
   column's full 2**25 rows: the ten-transform catalog built on the host;
   the column's device words shipped and bit-unpacked on the card (equal
   to the host codes); their counts (equal to ``Dictionary.counts``, and
   ``columnar.stats``' dictionary statistics equal to its scans); the
   ``zscore`` ADV gathered over the whole column; each of the ten ADVs
   gathered over a 65,536-row batch (the bench's full-mode N). Every
   gathered row must equal ``AugmentedDictionary.featurize`` bit for bit,
   and the three kernels must have launched.
8. report — one JSON line per the kernel table, the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. Without CUDA, or
without the package beside this script, it exits nonzero at once.
"""
from __future__ import annotations

import argparse
import io
import itertools
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
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 50_000_000           # ~25 ms at 2 GHz: covers 50 launches
COLD_SPIN_CYCLES = 2_000_000       # ~1 ms: covers one launch and a flush
L2_FLUSH_BYTES = 128 << 20         # written before each cold launch
ADV_SOURCE = "src/repro_torch/kernels/adv_gather/adv_gather.cu"
WIDE_SOURCE = "src/repro_torch/kernels/onehot_wide/onehot_wide.cu"
HIST_SOURCE = "src/repro_torch/kernels/hist/hist.cu"
SOURCES = {"adv_gather_packed_rows": ADV_SOURCE,
           "adv_gather_packed": ADV_SOURCE,
           "gather_fused_parts": ADV_SOURCE,
           "predicate_scan":
           "src/repro_torch/kernels/predicate_scan/predicate_scan.cu",
           "masked_counts": HIST_SOURCE,
           "onehot_wide": WIDE_SOURCE, "onehot_wide_backward": WIDE_SOURCE,
           "bitunpack": "src/repro_torch/kernels/bitunpack/bitunpack.cu",
           "hist": HIST_SOURCE, "adv_gather": ADV_SOURCE}
REPLACES = {"adv_gather_packed_rows": "src/repro/kernels/adv_gather/kernel.py:111",
            "adv_gather_packed": "src/repro/kernels/adv_gather/kernel.py:69",
            "gather_fused_parts": "src/repro/kernels/adv_gather/kernel.py:41",
            "predicate_scan": "src/repro/kernels/predicate_scan/kernel.py:37",
            "masked_counts": "src/repro/kernels/hist/kernel.py:53",
            "onehot_wide": "src/repro/kernels/onehot_wide/kernel.py:20",
            # no TPU kernel: JAX differentiates the jnp version
            "onehot_wide_backward": "src/repro/kernels/onehot_wide/ref.py:6",
            "bitunpack": "src/repro/kernels/bitunpack/kernel.py:33",
            "hist": "src/repro/kernels/hist/kernel.py:19",
            "adv_gather": "src/repro/kernels/adv_gather/kernel.py:23"}
# paper Table 6's column (benchmarks/bench_featurize.py:29, 844-846)
TABLE6_K = 999


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


def bench_labels(raw: dict, rng: np.random.Generator) -> np.ndarray:
    """``benchmarks/bench_pipeline._dataset``'s label rule over the table's
    columns, with its noise drawn from ``rng``."""
    return ((raw["age"] > 40).astype(float) * 0.5 +
            (raw["income"] > 100_000).astype(float) * 0.8 +
            (raw["state"] % 4 == 0).astype(float) * 0.3 +
            rng.standard_normal(raw["age"].size) * 0.3 > 0.8
            ).astype(np.float32)


def bench_features(fs_cls):
    """``benchmarks/bench_pipeline.py``'s FeatureSet (out_dim 4)."""
    return (fs_cls().add("age", "zscore")
            .add("age", "bucketize", boundaries=(30.0, 45.0, 65.0))
            .add("income", "minmax").add("income", "log"))


def table6_column(Dictionary, Column, rng: np.random.Generator, n: int):
    """``bench_featurize.run``'s column: ``rng.integers(0, 999, n)``,
    dictionary-encoded in load order; returns (dictionary, codes, Column),
    the Column's IMCUs packed at 10 bits and its device words at 16."""
    d, codes = Dictionary.from_data(rng.integers(0, TABLE6_K, n))
    col = Column(d, codes)
    col.device_words()                   # repacked once, cached per IMCU
    return d, codes, col


def table6_catalog():
    """``bench_featurize.run``'s ten transforms and their parameters
    (``bench_featurize.py:850-862``)."""
    return [("float", {}), ("onehot", {"max_cardinality": 4096}),
            ("minmax", {}), ("mean_norm", {}), ("zscore", {}),
            ("binarize", {"threshold": 500.0}), ("quantile", {"q": 4}),
            ("hash_bucket", {"n_buckets": 32}),
            ("bucketize", {"boundaries": np.linspace(0, TABLE6_K, 7)[1:-1]}),
            ("embedding", {"dim": 16})]


# -- phase 2 ------------------------------------------------------------------


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Fail unless ``got`` equals ``want`` element for element, compared on
    ``got``'s device (a CPU ``want`` is copied there); the largest
    difference is then 0.0."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype:
        fail(f"{name}: kernel gives {got.dtype}, its plain version "
             f"{want.dtype}")
    if got.shape != want.shape or not torch.equal(got, want.to(got.device)):
        fail(f"{name}: kernel differs from its plain version (shapes "
             f"{tuple(got.shape)} vs {tuple(want.shape)}, {got.dtype})")
    return 0.0


def gradient_check(wide_ops, wide_ref, codes: torch.Tensor, g: torch.Tensor,
                   k: int):
    """A check for the wide gradient: bit for bit against its plain version
    run on CPU copies of the inputs (the order the kernel keeps; on the
    card ``index_add_`` adds with atomics, in no fixed order), and bit-equal
    to a second launch on the same inputs."""
    want = wide_ref.onehot_wide_backward_ref(codes.cpu(), g.cpu(), k)

    def check(name: str, got: torch.Tensor, _plain) -> float:
        err = check_equal(f"{name} (vs the CPU)", got, want)
        check_equal(f"{name} (a second launch vs the first)",
                    wide_ops.onehot_wide_backward(codes, g, k), got)
        return err
    return check


def gather_edge_cases(ec, ops, ref, dev, rng) -> dict[str, float]:
    """Widths 1-32 mixed across columns, random words (codes past every
    table, 32-bit fields past 2**31), rows at word boundaries and past the
    stream, negative and oversized int32 codes; for the packed rows also
    ``ec.packed_rows_cases`` (out_dims 1 to 200, 1 to 5,000 rows), for the
    ranges ``ec.packed_range_cases`` (the same plans, 1 to 17 ranges of 32
    to 4,096 rows, starts duplicated, overlapping and past the stream), for
    the int32 gather ``ec.multi_cases`` (out_dims 1 to 200, C = 1 to 9, a
    K = 1 table, 1 to 5,000 rows)."""
    cards, dims, cap = (2, 3, 11, 200, 3000, 1000), (1, 3, 2, 5, 2, 1), 4096
    tables = [rng.standard_normal((k, f)).astype(np.float32)
              for k, f in zip(cards, dims)]
    flat, wmeta, _ = ec.random_stream(rng, cap, dev)
    fused = ops.fuse_tables(tables, dev)
    rows = np.concatenate([[0, 1, 15, 16, 31, 32, 33, cap - 1, cap,
                            10 ** 9], rng.integers(0, cap, 20000)])
    rows_err = 0.0
    for flat_c, wmeta_c, fused_c, rows_c in ec.packed_rows_cases(rng, dev):
        rows_err = max(rows_err, check_equal(
            f"adv_gather_packed_rows edge set out_dim {fused_c.out_dim} "
            f"rows {rows_c.numel()}",
            ops.adv_gather_packed_rows(flat_c, wmeta_c, fused_c, rows_c),
            ref.adv_gather_packed_rows_ref(flat_c, wmeta_c, fused_c,
                                           rows_c)))
    range_err = 0.0
    for flat_c, wmeta_c, fused_c, starts_c, batch_c in ec.packed_range_cases(
            rng, dev):
        range_err = max(range_err, check_equal(
            f"adv_gather_packed edge set out_dim {fused_c.out_dim} "
            f"{starts_c.numel()} x {batch_c} rows",
            ops.adv_gather_packed(flat_c, wmeta_c, fused_c, starts_c,
                                  batch_c),
            ref.adv_gather_packed_ref(flat_c, wmeta_c, fused_c, starts_c,
                                      batch_c)))
    multi_err = 0.0
    for fused_c, codes_c in ec.multi_cases(rng, dev):
        multi_err = max(multi_err, check_equal(
            f"gather_fused_parts edge set out_dim {fused_c.out_dim} "
            f"codes {tuple(codes_c.shape)}",
            ops.gather_fused_parts(fused_c, codes_c),
            ref.gather_fused_parts_ref(fused_c, codes_c)))
    rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
    starts = torch.tensor([0, 32, 1024, cap - 512], dtype=torch.int32,
                          device=dev)
    codes = torch.from_numpy(np.stack(
        [rng.integers(-5, k + 9, 20000) for k in cards]).astype(np.int32)
    ).to(dev)
    return {
        "adv_gather_packed_rows": max(rows_err, check_equal(
            "adv_gather_packed_rows edge cases",
            ops.adv_gather_packed_rows(flat, wmeta, fused, rows),
            ref.adv_gather_packed_rows_ref(flat, wmeta, fused, rows))),
        "adv_gather_packed": max(range_err, check_equal(
            "adv_gather_packed edge cases",
            ops.adv_gather_packed(flat, wmeta, fused, starts, 512),
            ref.adv_gather_packed_ref(flat, wmeta, fused, starts, 512))),
        "gather_fused_parts": max(multi_err, check_equal(
            "gather_fused_parts edge cases",
            ops.gather_fused_parts(fused, codes),
            ref.gather_fused_parts_ref(fused, codes))),
    }


def pushdown_edge_cases(ec, scan_ops, scan_ref, hist_ops, hist_ref, dev,
                        rng) -> dict[str, float]:
    """The scan: ``ec.scan_term_sets`` (both kinds at widths 1-32 over
    random words, two terms on one column, LUT clamps, empty and full
    selections) under AND and OR, n off every multiple of 4 and 32 against
    a longer stream (the count covers [0, n) only); ``ec.scan_layout_cases``
    (word offsets off every multiple of 4, bounds below 0, past 2**db and
    empty after the clamp, n around a 16-row group and one row past a
    block's step) under AND and OR. The masked counts:
    ``ec.masked_counts_cases`` (every width, k = 1, codes >= k, all-false /
    all-true / random masks, k at the shared-memory limit and past it) and
    ``ec.masked_counts_word_cases`` (k around 2**db and the per-warp bins'
    limit, one code in every row, unaligned masks and word offsets, n
    around a word)."""
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
    for i, (flat_l, wmeta_l, terms) in enumerate(ec.scan_layout_cases(rng,
                                                                      dev)):
        packed = scan_ops.pack_terms(terms, ec.DBS, dev)
        for combine in ("and", "or"):
            for n in ec.SCAN_LAYOUT_NS:
                mask, count = scan_ops.predicate_scan(flat_l, wmeta_l, packed,
                                                      n, combine)
                want, want_count = scan_ref.predicate_scan_ref(
                    flat_l, wmeta_l, packed, n, combine)
                name = f"predicate_scan layout case {i} {combine} n={n}"
                err["predicate_scan"] = max(err["predicate_scan"],
                                            check_equal(name, mask, want))
                if int(count) != int(want_count):
                    fail(f"{name}: count {int(count)} vs {int(want_count)}")
    cases, masks = ec.masked_counts_cases(rng, cap, dev)
    for words, off, db, k in cases:
        for j, mask in enumerate(masks):
            for n in (4001, cap):
                err["masked_counts"] = max(err["masked_counts"], check_equal(
                    f"masked_counts edge set db={db} k={k} mask {j} n={n}",
                    hist_ops.masked_counts(words, off, db, mask, k, n),
                    hist_ref.masked_counts_ref(words, off, db, mask, k, n)))
    for words, off, db, mask, k, n in ec.masked_counts_word_cases(rng, dev):
        err["masked_counts"] = max(err["masked_counts"], check_equal(
            f"masked_counts word-major case db={db} k={k} off={off} n={n} "
            f"mask at {mask.data_ptr() % 16} mod 16",
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
    # the tables and the addressing every gather reads: a jmeta row an
    # output column; the packed ones also a wmeta row a column, the rows
    # gather each table's last row (4 B a column) for its clamp
    tables_bytes = fused.nbytes + 4 * fused.jmeta.numel()
    wmeta_bytes = 4 * wmeta.numel()
    out = {}

    rows_np = rng.integers(0, n_rows, rows_n).astype(np.int32)
    rows = torch.from_numpy(rows_np).to(dev)
    out["adv_gather_packed_rows"] = dict(
        call=lambda: ops.adv_gather_packed_rows(flat, wmeta, fused, rows),
        plain=lambda: ref.adv_gather_packed_rows_ref(flat, wmeta, fused,
                                                     rows),
        bytes=4 * rows_n + 4 * words_touched(rows_np, wmeta_np)
        + tables_bytes + wmeta_bytes + 4 * fused.n_tables
        + 4 * rows_n * fused.out_dim,
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
        + wmeta_bytes + 4 * range_batch * fused.out_dim,
        shape=f"1 range x {range_batch} rows")

    fused_i = plan_i.fused_tables()
    codes = torch.from_numpy(plan_i.host_codes(
        rng.integers(0, n_rows, codes_n))).to(dev)
    out["gather_fused_parts"] = dict(
        call=lambda: ops.gather_fused_parts(fused_i, codes),
        plain=lambda: ref.gather_fused_parts_ref(fused_i, codes),
        bytes=4 * codes.numel() + fused_i.nbytes + 4 * fused_i.jmeta.numel()
        + 4 * codes_n * fused_i.out_dim,
        shape=f"codes {tuple(codes.shape)} int32")

    measure(out, iters=50, plain_iters=5)
    return out


def syncs(fn) -> bool:
    """Whether ``fn`` synchronises with the host (CUDA's sync debug mode
    raises on it): such a call cannot be queued behind a spin kernel."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)


def measure(kernels: dict, iters: int, plain_iters: int) -> None:
    """Check each kernel against its plain version, then time both, and
    the library call where an entry names one (``library``), and derive the
    bound. ``ms`` times launches back to back, where inputs that fit in L2
    stay there between launches; ``cold_ms`` times single launches after an
    L2 flush. An entry may name its own ``check`` (default bit for bit) and
    its float32 ``ops``: the bound is the larger of bytes over the HBM rate
    and operations over the float32 rate."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for name, k in kernels.items():
        got, want = k["call"](), k["plain"]()
        if isinstance(got, tuple):       # the scan's (mask, count)
            if int(got[1]) != int(want[1]):
                fail(f"{name} at the main path's shape: count "
                     f"{int(got[1])} vs {int(want[1])}")
            got, want = got[0], want[0]
        k["max_abs_err"] = k.get("check", check_equal)(
            f"{name} at the main path's shapes", got, want)
        k["ms"] = time_ms(k["call"], iters=iters, reps=15, queue_ahead=True)
        k["cold_ms"] = time_cold_ms(k["call"], flush, launches=iters)
        k["plain_ms"] = time_ms(k["plain"], iters=plain_iters, reps=7,
                                queue_ahead=False)
        lib = ""
        k["library_ms"] = None
        if "library" in k:
            queued = not syncs(k["library"])
            k["library_ms"] = time_ms(k["library"], iters=iters, reps=15,
                                      queue_ahead=queued)
            lib = (f", library {k['library_ms']:.6f} ms"
                   f"{'' if queued else ' (synchronises: timed as called)'}")
        byte_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = k.get("ops", 0) / FP32_OPS_PER_S * 1e3
        k["bound_ms"] = max(byte_ms, op_ms)
        k["bound_by"] = "bytes" if byte_ms >= op_ms else "operations"
        log(f"  {name} [{k['shape']}]: kernel {k['ms']:.6f} ms back to "
            f"back, {k['cold_ms']:.6f} ms after an L2 flush, plain "
            f"{k['plain_ms']:.6f} ms{lib}, bound {k['bound_ms']:.6f} ms "
            f"({k['bytes']} B at 3.35 TB/s, {k.get('ops', 0)} float32 ops "
            f"at 67 TFLOP/s; {k['bound_by']})")


def pushdown_shape_kernels(scan_ops, scan_ref, hist_ops, hist_ref, ex_p,
                           plan_p, n_rows, p_scan, p_mask, group_col: str,
                           agg_col: str) -> dict[str, dict]:
    """Both pushdown kernels at the pushdown path's shapes: the scan of
    ``p_scan`` over the whole resident table, and the masked counts of
    ``group_col`` under ``p_mask``'s mask (the groupby_where call). The
    masked counts are also timed at the agg_where call, ``agg_col`` under
    ``p_scan``'s mask, and logged (the kernels line keeps the
    groupby_where shape). The scan's bytes: every word of each column a
    term reads, one mask byte per row, the term table and LUTs, the count.
    The counts' bytes: the words holding at least one selected row, one
    mask byte per row, 4k bytes out."""
    flat, wmeta = ex_p._flat_words, ex_p._wmeta
    dbs = plan_p.device_bits
    _, comb1, packed1 = ex_p._compiled_pred(p_scan)
    _, comb2, packed2 = ex_p._compiled_pred(p_mask)
    mask1, _ = scan_ops.predicate_scan(flat, wmeta, packed1, n_rows, comb1)
    mask2, _ = scan_ops.predicate_scan(flat, wmeta, packed2, n_rows, comb2)

    def counts_entry(col: str, mask: torch.Tensor, call: str) -> dict:
        ci = plan_p.columns.index(col)
        off, db = ex_p._word_offs[ci], dbs[ci]
        k = ex_p._dictionary(col).cardinality
        s = 32 // db
        padded = torch.nn.functional.pad(mask.to(torch.uint8),
                                         (0, -n_rows % s))
        words_needed = int(padded.view(-1, s).any(1).sum())
        return dict(
            call=lambda: hist_ops.masked_counts(flat, off, db, mask, k,
                                                n_rows),
            plain=lambda: hist_ref.masked_counts_ref(flat, off, db, mask, k,
                                                     n_rows),
            bytes=4 * words_needed + n_rows + 4 * k,
            shape=f"{call}: {col} ({db}-bit, k={k}) x {n_rows} rows, "
            f"{int(mask.sum())} selected")

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
    out["masked_counts"] = counts_entry(group_col, mask2, "groupby_where")
    measure(out, iters=20, plain_iters=2)
    measure({"masked_counts": counts_entry(agg_col, mask1, "agg_where")},
            iters=20, plain_iters=2)
    return out


def wide_edge_cases(ec, wide_ops, wide_ref, dev, rng) -> dict[str, float]:
    """``ec.onehot_wide_cases``: C in {0, 1, 8}, N in {0, 1, 33, 1024},
    K in {1, 4, 600, 65537}, F in {1, 129}, codes -1, K, 2**31 - 1 and
    -2**31 among them, and ``ec.ONEHOT_GROUPED_SHAPES``, where the gradient
    takes its grouped route; ``ec.onehot_wide_forward_cases`` (F from 1 to
    129, C to 33, N to 1,025, w also as an unaligned view; F 1,024 and
    1,030 at ``ec.WIDE_FWD_PASSES``). Forward bit for
    bit in float32 and bfloat16; the gradient bit for bit against the CPU
    and across two launches."""
    err = {"onehot_wide": 0.0, "onehot_wide_backward": 0.0}
    for codes, w, g in itertools.chain(ec.onehot_wide_cases(rng, dev),
                                       ec.onehot_wide_grouped_cases(rng,
                                                                    dev)):
        k = w.shape[1]
        name = f"(C, N, K, F) = {tuple(codes.shape) + tuple(w.shape[1:])}"
        err["onehot_wide"] = max(err["onehot_wide"], check_equal(
            f"onehot_wide edge set {name}", wide_ops.onehot_wide(codes, w),
            wide_ref.onehot_wide_ref(codes, w)))
        w16 = w.to(torch.bfloat16)
        check_equal(f"onehot_wide bf16 edge set {name}",
                    wide_ops.onehot_wide(codes, w16),
                    wide_ref.onehot_wide_ref(codes, w16))
        check = gradient_check(wide_ops, wide_ref, codes, g, k)
        err["onehot_wide_backward"] = max(err["onehot_wide_backward"], check(
            f"onehot_wide_backward edge set {name}",
            wide_ops.onehot_wide_backward(codes, g, k), None))
    for codes, w in itertools.chain(
            ec.onehot_wide_forward_cases(rng, dev),
            ec.onehot_wide_forward_cases(rng, dev, **ec.WIDE_FWD_PASSES)):
        err["onehot_wide"] = max(err["onehot_wide"], check_equal(
            f"onehot_wide forward case (C, N, K, F) = "
            f"{tuple(codes.shape) + tuple(w.shape[1:])} {w.dtype} at "
            f"{w.data_ptr() % 16} mod 16", wide_ops.onehot_wide(codes, w),
            wide_ref.onehot_wide_ref(codes, w)))
    return err


def wide_entries(wide_ops, wide_ref, codes: torch.Tensor, w: torch.Tensor,
                 g: torch.Tensor, label: str) -> dict[str, dict]:
    """The wide layer and its gradient on (codes, w, g), each beside the one
    PyTorch call that computes the same function: ``embedding_bag`` (sum,
    zero weight on out-of-range codes) over W as a (C*K, F) table, and its
    backward. Bytes: forward, the codes, each (c, code) row of W the codes
    need, the output; backward, the codes, g and dW (its zero entries are
    part of the output). Operations: one float32 add per (c, n, f). The
    gradient is held bit for bit to the CPU and across two launches."""
    import torch.nn.functional as F
    c, n = codes.shape
    _, k, f = w.shape
    valid = (codes >= 0) & (codes < k)
    flat_rows = torch.where(valid, codes, 0).long() + \
        k * torch.arange(c, device=codes.device)[:, None]
    rows_needed = int(torch.unique(flat_rows[valid]).numel())
    idx = flat_rows.t().contiguous()                      # (N, C)
    weights = valid.t().contiguous().to(w.dtype)
    table = w.view(c * k, f)
    lib_w = table.detach().clone().requires_grad_(True)
    lib_out = F.embedding_bag(idx, lib_w, mode="sum",
                              per_sample_weights=weights)
    want = wide_ref.onehot_wide_ref(codes, w)
    if not torch.allclose(F.embedding_bag(idx, table, mode="sum",
                                          per_sample_weights=weights),
                          want, rtol=1e-5, atol=1e-5):
        fail(f"embedding_bag does not compute onehot_wide at {label}")
    shape = f"(C, N, K, F) = ({c}, {n}, {k}, {f}), {label}"
    return {
        "onehot_wide": dict(
            call=lambda: wide_ops.onehot_wide(codes, w),
            plain=lambda: wide_ref.onehot_wide_ref(codes, w),
            library=lambda: F.embedding_bag(idx, table, mode="sum",
                                            per_sample_weights=weights),
            bytes=4 * c * n + (rows_needed + n) * f * w.element_size(),
            ops=c * n * f, shape=shape),
        "onehot_wide_backward": dict(
            call=lambda: wide_ops.onehot_wide_backward(codes, g, k),
            plain=lambda: wide_ref.onehot_wide_backward_ref(codes, g, k),
            check=gradient_check(wide_ops, wide_ref, codes, g, k),
            library=lambda: torch.autograd.grad(lib_out, lib_w, g,
                                                retain_graph=True)[0],
            bytes=4 * c * n + 4 * n * f + 4 * c * k * f,
            ops=c * n * f, shape=shape),
    }


def train_shape_kernels(wide_ops, wide_ref, adv_ops, adv_ref, pipe,
                        wide_codes, rng, batch: int, dev) -> dict[str, dict]:
    """The three kernels of the Fig 2 train step at its shapes: the deep
    features' int32 gather of ``batch`` rows, the wide layer over the
    ``state`` and ``device`` codes of the same rows (W (2, 50, 1)), and the
    gradient of it."""
    idx = rng.integers(0, pipe.plan.n_rows, batch)
    fused = pipe.plan.fused_tables()
    codes = torch.from_numpy(pipe.plan.host_codes(idx)).to(dev)
    wide = torch.from_numpy(np.stack([wide_codes[c][idx] for c in
                                      ("state", "device")])).to(dev)
    w = torch.from_numpy(rng.standard_normal((2, 50, 1),
                                             dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((batch, 1),
                                             dtype=np.float32)).to(dev)
    out = {"gather_fused_parts": dict(
        call=lambda: adv_ops.gather_fused_parts(fused, codes),
        plain=lambda: adv_ref.gather_fused_parts_ref(fused, codes),
        bytes=4 * codes.numel() + fused.nbytes + 4 * fused.jmeta.numel()
        + 4 * batch * fused.out_dim,
        shape=f"codes {tuple(codes.shape)} int32, the train path's deep "
        "features")}
    out.update(wide_entries(wide_ops, wide_ref, wide, w, g,
                            "the train path's wide codes"))
    measure(out, iters=50, plain_iters=5)
    return out


def sweep_shape_kernels(wide_ops, wide_ref, rng, dev) -> dict[str, dict]:
    """The wide layer and its gradient at the JAX sweep's largest shape,
    (C, N, K, F) = (2, 256, 600, 128), random in-range codes."""
    codes = torch.from_numpy(rng.integers(0, 600, (2, 256))
                             .astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((2, 600, 128),
                                             dtype=np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((256, 128),
                                             dtype=np.float32)).to(dev)
    out = wide_entries(wide_ops, wide_ref, codes, w, g, "the JAX sweep's "
                       "largest shape")
    measure(out, iters=50, plain_iters=5)
    return out


def table6_edge_cases(ec, unpack_ops, unpack_ref, hist_ops, hist_ref,
                      adv_ops, adv_ref, dev, rng) -> dict[str, float]:
    """``ec.bitunpack_cases`` (every width, n = 0 and off every multiple of
    32 / db, words past the codes and codes past the words, fields past
    2**31), ``ec.hist_cases`` (k in {1, 999, 58,112, 58,113, 100,000},
    codes < 0 and >= k, an unaligned view, 2-D codes, no codes) and
    ``ec.adv_gather_cases`` (K in {1, 999, 65,536, 65,537, 131,072} x F in
    {1, 16, 128, 999}, float32 and bfloat16, codes past both edges and the
    int32 ends, 2-D codes, no codes) and ``ec.adv_gather_shape_cases`` (F
    in {1, 3, 16, 999}, n in {1, 3, 5, 4097}, views not 16-byte aligned):
    bit for bit."""
    err = {"bitunpack": 0.0, "hist": 0.0, "adv_gather": 0.0}
    for words, db, n in ec.bitunpack_cases(rng, dev):
        err["bitunpack"] = max(err["bitunpack"], check_equal(
            f"bitunpack edge set db={db} n={n}",
            unpack_ops.bitunpack(words, db, n),
            unpack_ref.bitunpack_ref(words, db, n)))
    for codes, k in ec.hist_cases(rng, dev):
        err["hist"] = max(err["hist"], check_equal(
            f"hist edge set k={k} codes {tuple(codes.shape)}",
            hist_ops.hist(codes, k), hist_ref.hist_ref(codes, k)))
    for table, codes in ec.adv_gather_cases(rng, dev):
        err["adv_gather"] = max(err["adv_gather"], check_equal(
            f"adv_gather edge set table {tuple(table.shape)} {table.dtype} "
            f"codes {tuple(codes.shape)}", adv_ops.adv_gather(table, codes),
            adv_ref.adv_gather_ref(codes, table)))
    for table, codes in ec.adv_gather_shape_cases(rng, dev):
        err["adv_gather"] = max(err["adv_gather"], check_equal(
            f"adv_gather edge set table {tuple(table.shape)} {table.dtype} "
            f"codes ({codes.numel()},) at byte offset "
            f"{codes.data_ptr() % 16}", adv_ops.adv_gather(table, codes),
            adv_ref.adv_gather_ref(codes, table)))
    return err


def table6_shape_kernels(unpack_ops, unpack_ref, hist_ops, hist_ref,
                         adv_ops, adv_ref, words, db, codes, k,
                         table) -> dict[str, dict]:
    """The three kernels of the Table 6 path at its shapes: the column's
    words (``db``-bit) unpacked to its n codes; the counts of those codes;
    the ``zscore`` ADV (k, 1) gathered over all of them. Bytes: the words
    the codes need and the codes out; the codes and 4k bytes out; the codes,
    the table rows they need and the features out. The library calls:
    ``bincount`` and ``index_select`` (every code is in range here)."""
    n = codes.numel()
    s = 32 // db
    f = table.shape[1]
    rows_needed = int(torch.unique(codes).numel())
    if not torch.equal(torch.bincount(codes, minlength=k).int(),
                       hist_ref.hist_ref(codes, k)):
        fail("bincount does not compute hist on the Table 6 column")
    if not torch.equal(torch.index_select(table, 0, codes),
                       adv_ref.adv_gather_ref(codes, table)):
        fail("index_select does not compute adv_gather on the Table 6 column")
    out = {
        "bitunpack": dict(
            call=lambda: unpack_ops.bitunpack(words, db, n),
            plain=lambda: unpack_ref.bitunpack_ref(words, db, n),
            bytes=4 * -(-n // s) + 4 * n,
            shape=f"{words.numel()} words at {db} bits -> {n} int32 codes"),
        "hist": dict(
            call=lambda: hist_ops.hist(codes, k),
            plain=lambda: hist_ref.hist_ref(codes, k),
            library=lambda: torch.bincount(codes, minlength=k),
            bytes=4 * n + 4 * k,
            shape=f"{n} int32 codes, k = {k}"),
        "adv_gather": dict(
            call=lambda: adv_ops.adv_gather(table, codes),
            plain=lambda: adv_ref.adv_gather_ref(codes, table),
            library=lambda: torch.index_select(table, 0, codes),
            bytes=4 * n + rows_needed * f * table.element_size()
            + n * f * table.element_size(),
            shape=f"zscore ({k}, {f}) {table.dtype} by {n} int32 codes"),
    }
    measure(out, iters=50, plain_iters=5)
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


def check_sample(name: str, plan, sampled, least: int = 10_000) -> int:
    rows = sum(r.size for r, _ in sampled)
    if rows < least:
        fail(f"{name}: only {rows} rows sampled")
    for r, got in sampled:
        if got.shape != (r.size, plan.out_dim) or \
                not np.array_equal(got, plan.host_features(r)):
            fail(f"{name}: served features differ from host_features")
    return rows


# -- phase 3b -----------------------------------------------------------------

FRONT_RSZ = 64      # bench_featurize.py:_frontend_serve_comparison's rsz


def front_door_classes(RequestClass) -> tuple:
    """The bench's class mix (bench_featurize.py:765-774)."""
    return (RequestClass("interactive", priority=3, coalesce=1,
                         linger_us=0.0, max_inflight=512, queue_depth=512),
            RequestClass("batch", priority=2, coalesce=8, linger_us=1000.0,
                         max_inflight=1024, queue_depth=1024),
            RequestClass("background", priority=1, aging_s=0.05,
                         max_inflight=16, queue_depth=16))


def front_door_requests(rng: np.random.Generator, n_rows: int):
    """The bench's Zipf(1.2) 64-row 'user blocks' on 32-row boundaries:
    360 batch, 120 interactive and 8 background requests."""
    blocks = (n_rows - FRONT_RSZ) // 32

    def zipf(count):
        ranks = np.minimum(rng.zipf(1.2, count), blocks) - 1
        return [np.arange(s, s + FRONT_RSZ) for s in ranks * 32]
    return zipf(360), zipf(120), zipf(8)


def front_door_burst(fe, reqs_batch, reqs_inter, reqs_bg):
    """The bench's saturating burst through the front door (interactive
    one per three batch, background every len(batch) // 8), then collect.
    Returns the wall and each request's (rows, outcome)."""
    n_inter, n_bg = len(reqs_inter), len(reqs_bg)
    bg_step = len(reqs_batch) // n_bg
    sent, k = [], 0
    t0 = time.perf_counter()
    for i, r in enumerate(reqs_batch):
        sent.append((r, fe.submit(r, klass="batch", tenant="analytics")))
        if i % 3 == 0 and k < n_inter:
            sent.append((reqs_inter[k], fe.submit(
                reqs_inter[k], klass="interactive", tenant="app")))
            k += 1
        if i % bg_step == 0 and i // bg_step < n_bg:
            r_bg = reqs_bg[i // bg_step]
            sent.append((r_bg, fe.submit(r_bg, klass="background",
                                         tenant="scavenger")))
    for r in reqs_inter[k:]:
        sent.append((r, fe.submit(r, klass="interactive", tenant="app")))
    out = fe.collect(timeout=120)
    return time.perf_counter() - t0, [(r, out[t]) for r, t in sent]


def fifo_burst(svc, reqs_batch, reqs_inter):
    """The bench's FIFO control: the same mix classless through a service
    of the same shape, then collect."""
    sent = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs_batch):
        sent.append((r, svc.submit(r)))
        if i % 3 == 0:
            r_in = reqs_inter[i // 3 % len(reqs_inter)]
            sent.append((r_in, svc.submit(r_in)))
    out = svc.collect(timeout=120)
    return time.perf_counter() - t0, [(r, out[t]) for r, t in sent]


def check_outcomes(name: str, plan, outcomes, every: int, InjectedFault,
                   least: int = 10_000) -> int:
    """Fail on any ticket that resolved to an error (naming its cause: an
    error not injected is a real fault, never to be served), then hold
    every ``every``-th result against ``host_features`` bit for bit;
    returns the rows checked (``least`` required)."""
    for _, got in outcomes:
        if isinstance(got, Exception):
            cause = got.__cause__
            real = "" if isinstance(cause, InjectedFault) else \
                " (not an injected fault)"
            fail(f"{name}: a ticket failed: {got!r}, cause {cause!r}{real}")
    return check_sample(name, plan, outcomes[::every], least)


def front_door_path(S, ops, scan_ops, ex_p, plan, plan_i, p1, rows_p1, rng,
                    counters):
    """Phase 3b: bench_featurize.py's front-door workload on the resident
    serving table, the FIFO control beside it, the admission probe, P1
    through the front door, a chaos pass, and one burst over the int32
    plan. Returns the launches."""
    n_rows = plan.n_rows
    reqs_batch, reqs_inter, reqs_bg = front_door_requests(rng, n_rows)
    n_req = len(reqs_batch) + len(reqs_inter) + len(reqs_bg)
    svc_kw = dict(buckets=(FRONT_RSZ,), coalesce=8, linger_us=1000.0)
    # the kernel at this path's launch: 8 x 64 rows
    fused = plan.fused_tables()
    launch_rows = torch.from_numpy(rng.integers(
        0, n_rows, 8 * FRONT_RSZ).astype(np.int32)).to(plan.device)
    k_ms = time_ms(lambda: ops.adv_gather_packed_rows(
        ex_p._flat_words, ex_p._wmeta, fused, launch_rows),
        iters=50, reps=15, queue_ahead=True)
    for counter in counters:
        counter.reset_launches()

    fe = S.FeatureFrontend.for_plan(
        plan, classes=front_door_classes(S.RequestClass), **svc_kw)
    svc = fe.service
    fifo = S.FeatureService(plan, **svc_kw)
    checked = []
    for run in (lambda: fifo_burst(fifo, reqs_batch, reqs_inter),
                lambda: front_door_burst(fe, reqs_batch, reqs_inter,
                                         reqs_bg)):
        _, outcomes = run()                             # warm-up
        checked.append(check_outcomes("front door warm-up", plan, outcomes,
                                      2, S.InjectedFault))
    svc.reset_latency_window()
    fifo.reset_latency_window()
    launches0 = svc.stats["launches"]
    walls = {"fifo": [], "front": []}
    for _ in range(5):
        for key, run in (("fifo", lambda: fifo_burst(fifo, reqs_batch,
                                                     reqs_inter)),
                         ("front", lambda: front_door_burst(
                             fe, reqs_batch, reqs_inter, reqs_bg))):
            wall, outcomes = run()
            walls[key].append(wall)
            checked.append(check_outcomes(f"{key} run", plan, outcomes, 2,
                                          S.InjectedFault))
    fe_launches = svc.stats["launches"] - launches0
    p = {k: (svc.latency_percentile(50, k), svc.latency_percentile(99, k))
         for k in ("interactive", "batch", "background")}
    fifo_p99 = fifo.latency_percentile(99)
    cs = svc.class_stats()
    for name, (p50, p99) in p.items():
        log(f"  {name}: p50 {p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms over "
            f"{cs[name]['samples']} tickets")
    wall_fe = statistics.median(walls["front"])
    wall_fifo = statistics.median(walls["fifo"])
    rows_fe = n_req * FRONT_RSZ
    rows_fifo = (len(reqs_batch) + -(-len(reqs_batch) // 3)) * FRONT_RSZ
    log(f"  p99 interactive / batch {p['interactive'][1] / p['batch'][1]:.4f}"
        f"; FIFO control p99 {fifo_p99 * 1e3:.4f} ms (p99 interactive / "
        f"FIFO {p['interactive'][1] / fifo_p99:.4f})")
    log(f"  front door: {n_req} requests a run, median wall "
        f"{wall_fe:.6f} s of {[round(w, 6) for w in walls['front']]} = "
        f"{rows_fe / wall_fe:.1f} rows/s, {fe_launches} launches in 5 "
        f"runs; {k_ms:.6f} ms a launch of the kernel at 8 x 64 rows, "
        f"{fe_launches * k_ms / (sum(walls['front']) * 1e3):.6f} of the "
        "wall in the kernel")
    log(f"  FIFO control: {rows_fifo // FRONT_RSZ} requests a run, median "
        f"wall {wall_fifo:.6f} s of {[round(w, 6) for w in walls['fifo']]} "
        f"= {rows_fifo / wall_fifo:.1f} rows/s, "
        f"{fifo.stats['launches']} launches in 6 runs")
    fifo.shutdown()
    # admission probe (the bench's): hold the pump, overflow background
    svc.pause()
    overloaded, admitted, hint = 0, [], 0.0
    for _ in range(64):
        try:
            admitted.append(fe.submit(reqs_bg[0], klass="background",
                                      tenant="scavenger"))
        except S.Overloaded as e:
            overloaded += 1
            hint = e.retry_after_s
    svc.resume()
    out = fe.collect(timeout=120)
    probe = [(reqs_bg[0], out[t]) for t in admitted]
    check_outcomes("admission probe", plan, probe, 1, S.InjectedFault,
                   least=1)
    if overloaded < 1:
        fail("the admission probe raised no Overloaded")
    # P1 through the front door, among interactive requests
    sent = []
    for i, r in enumerate(reqs_inter[:6]):
        sent.append((r, fe.submit(r, klass="interactive")))
        if i % 2:
            sent.append((rows_p1, fe.submit(where=p1, klass="batch")))
    out = fe.collect(timeout=120)
    filtered = [(r, out[t]) for r, t in sent]
    checked.append(check_outcomes("front door where=P1", plan, filtered, 1,
                                  S.InjectedFault))
    st = fe.stats()
    fe.shutdown()
    bg_done = cs["background"]["samples"]
    log(f"  availability_admitted {st['availability_admitted']}, "
        f"background completed {bg_done} in the 5 timed runs, {overloaded} "
        f"of 64 "
        f"probe submits Overloaded (retry after {hint * 1e3:.4f} ms), "
        f"{len(admitted)} admitted and resolved; 3 x submit(where=P1, "
        f"klass='batch') of {rows_p1.size} rows; failed_tickets "
        f"{svc.stats['failed_tickets']}, retries {svc.stats['retries']}")
    if st["availability_admitted"] != 1.0 or svc.stats["failed_tickets"] \
            or svc.stats["retries"]:
        fail("the fault-free front door failed or retried a ticket")
    if bg_done < 5 * len(reqs_bg):
        fail(f"background completed {bg_done} of {5 * len(reqs_bg)}")

    # chaos: every 5th batch launch fails, every 7th other launch stalls
    inj = (S.FaultInjector().fail_launches(1 << 30, every=5, klass="batch")
           .stall_launches(0.002, 1 << 30, every=7))
    fe = S.FeatureFrontend.for_plan(
        plan, classes=front_door_classes(S.RequestClass),
        faults=inj, fault_policy=S.FaultPolicy(max_retries=3), **svc_kw)
    wall, outcomes = front_door_burst(fe, reqs_batch, reqs_inter, reqs_bg)
    checked.append(check_outcomes("chaos run", plan, outcomes, 2,
                                  S.InjectedFault))
    st, cst = fe.stats(), dict(fe.service.stats)
    fe.shutdown()
    log(f"  chaos: {inj.faults_injected} injected faults, "
        f"{inj.stalls_injected} stalls of 2 ms, retries {cst['retries']}, "
        f"failed_tickets {cst['failed_tickets']}, availability_admitted "
        f"{st['availability_admitted']}, wall {wall:.6f} s; "
        f"{min(checked)}-{max(checked)} sampled rows a run bit-exact")
    if st["availability_admitted"] != 1.0 or cst["failed_tickets"] \
            or not 0 < cst["retries"] == inj.faults_injected \
            or not inj.stalls_injected:
        fail("the chaos run did not retry every injected fault into a "
             "served result")
    # the same burst over the int32 plan (singleton launches)
    fe = S.FeatureFrontend.for_plan(
        plan_i, classes=front_door_classes(S.RequestClass), **svc_kw)
    wall, outcomes = front_door_burst(fe, reqs_batch, reqs_inter, reqs_bg)
    checked = check_outcomes("int32 front door", plan_i, outcomes, 2,
                             S.InjectedFault)
    st, ist = fe.stats(), dict(fe.service.stats)
    fe.shutdown()
    log(f"  int32 plan: {ist['launches']} launches, wall {wall:.6f} s = "
        f"{n_req * FRONT_RSZ / wall:.1f} rows/s, availability_admitted "
        f"{st['availability_admitted']}, retries {ist['retries']}; "
        f"{checked} sampled rows bit-exact")
    if st["availability_admitted"] != 1.0 or ist["retries"]:
        fail("the int32 front door failed or retried a ticket")
    launched = {k: c.LAUNCHES[k] for k, c in (
        ("adv_gather_packed_rows", ops), ("gather_fused_parts", ops),
        ("predicate_scan", scan_ops))}
    log(f"kernels launched on the front door path: "
        f"{ {k: v for c in counters for k, v in c.LAUNCHES.items()} }")
    idle = [k for k, v in launched.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the front door path: {idle}")
    return launched


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
                  agg_col, svc_kw, plain_reqs, host_p1) -> None:
    """Every pushdown entry point on the resident table, each result held
    against the numpy host reference over the whole table; card and host
    times side by side (card: median of 3 calls, each synchronised).
    ``host_p1`` is P1's host mask and its time, taken once in phase 3b."""
    n = plan.n_rows
    h1, th1 = host_p1
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


# -- phase 5 ------------------------------------------------------------------


def traditional_features(table, idx: np.ndarray):
    """``bench_pipeline.py``'s traditional path for one batch (paper Fig 1):
    decode the columns to row values, write the rows as CSV text, parse it
    back, recompute the transforms over the decoded columns, and return the
    (deep, wide, embed) host arrays to ship."""
    rows = {c: table[c].decode()[idx] for c in
            ("age", "income", "state", "device")}
    buf = io.StringIO()
    for j in range(idx.size):                       # CSV materialization
        buf.write(f"{rows['age'][j]},{rows['income'][j]},"
                  f"{rows['state'][j]},{rows['device'][j]}\n")
    buf.seek(0)
    parsed = np.loadtxt(buf, delimiter=",", dtype=np.float64)
    age, income = parsed[:, 0], parsed[:, 1]
    a_all = table["age"].decode().astype(np.float64)
    i_all = table["income"].decode().astype(np.float64)
    deep = np.stack([
        (age - a_all.mean()) / a_all.std(),
        np.searchsorted([30., 45., 65.], age, side="right"),
        (income - i_all.min()) / (i_all.max() - i_all.min()),
        np.log1p(income),
    ], axis=1).astype(np.float32)
    wide = np.stack([parsed[:, 2], parsed[:, 3]]).astype(np.int32)
    return deep, wide, parsed[:, 2].astype(np.int32)


def train_path(wd, to_device, adv_ops, wide_ops, pipe, table, wide_codes, y,
               seed, dev, train_kernels, batch=1024, steps=500, drift_steps=200,
               loop_steps=8):
    """Paper Fig 1/2 on the 2**25-row table: ``bench_pipeline.py``'s ADV and
    traditional loops (``loop_steps`` each, walls and host->device bytes),
    then ``steps`` ADV steps (steps/s, rows/s, the kernels' share of the
    wall). Returns :func:`drift_check` over the first ``drift_steps`` steps,
    to be called once the path's launch counts are read: its re-stepped
    batches launch kernels to compare, not to train."""
    cfg = wd.WideDeepConfig(wide_cards=(50, 4), deep_dim=pipe.out_dim,
                            embed_cols=((50, 8),), hidden=(32, 16))
    params0 = wd.init_widedeep(cfg, torch.Generator().manual_seed(seed), dev)
    step = wd.make_widedeep_train_step(cfg, lr=0.1)
    n_rows = pipe.plan.n_rows
    rng = np.random.default_rng(seed)

    def adv_batch(idx):
        wide = np.stack([wide_codes["state"][idx], wide_codes["device"][idx]])
        emb, labels = wide_codes["state"][idx], y[idx]
        sent = pipe.bytes_moved_adv(idx.size) + wide.nbytes + emb.nbytes \
            + labels.nbytes
        return (to_device(wide, dev), pipe.batch(idx), to_device(labels, dev),
                [to_device(emb, dev)]), sent

    # one step first, discarded: the first cuBLAS and allocator calls are
    # set-up, not a loop's time
    step(params0, *adv_batch(rng.integers(0, n_rows, batch))[0])
    # the bench's two loops, from the same parameters
    walls, sent, losses = {}, {}, {}
    for path in ("adv", "traditional"):
        p, nbytes = params0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(loop_steps):
            idx = rng.integers(0, n_rows, batch)
            if path == "adv":
                args, b = adv_batch(idx)
            else:
                deep, wide, emb = traditional_features(table, idx)
                labels = y[idx]
                b = deep.nbytes + wide.nbytes + emb.nbytes + labels.nbytes
                args = (to_device(wide, dev), to_device(deep, dev),
                        to_device(labels, dev), [to_device(emb, dev)])
            p, loss = step(p, *args)
            nbytes += b
        losses[path] = float(loss)
        walls[path] = time.perf_counter() - t0
        sent[path] = nbytes
    log(f"Fig 2 ADV loop: {loop_steps} steps x {batch} rows in "
        f"{walls['adv']:.6f} s, {sent['adv']} B host->device, last loss "
        f"{losses['adv']:.6f}")
    log(f"Fig 1 traditional loop (decode, CSV, parse, ship f32): "
        f"{loop_steps} steps in {walls['traditional']:.6f} s, "
        f"{sent['traditional']} B host->device, last loss "
        f"{losses['traditional']:.6f}")
    log(f"  traditional / ADV: wall {walls['traditional'] / walls['adv']:.6f}"
        f"x, bytes {sent['traditional'] / sent['adv']:.6f}x")

    # the long run, keeping the first drift_steps batches and the card's
    # parameters before each of them (and after the last) for the CPU
    kept, trajectory, card_losses = [], [params0], []
    before = {**adv_ops.LAUNCHES, **wide_ops.LAUNCHES}
    p = params0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        idx = rng.integers(0, n_rows, batch)
        args, _ = adv_batch(idx)
        p, loss = step(p, *args)
        card_losses.append(loss)
        if i < drift_steps:
            kept.append(idx)
            trajectory.append(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    card_losses = torch.stack(card_losses).tolist()
    after = {**adv_ops.LAUNCHES, **wide_ops.LAUNCHES}
    share = sum((after[name] - before[name]) * train_kernels[name]["ms"]
                for name in ("gather_fused_parts", "onehot_wide",
                             "onehot_wide_backward")) / (wall * 1e3)
    if not all(np.isfinite(card_losses)):
        fail("the train path's loss is not finite")
    log(f"Fig 2 ADV training: {steps} steps x {batch} rows in {wall:.6f} s "
        f"= {steps / wall:.6f} steps/s, {steps * batch / wall:.1f} rows/s; "
        f"loss {card_losses[0]:.6f} -> {np.mean(card_losses[-20:]):.6f} "
        f"(mean of the last 20), largest change from one step to the next "
        f"{np.abs(np.diff(card_losses)).max():.6f}; {share:.6f} of the wall "
        f"in the three kernels (launches x their ms at these shapes)")
    return lambda: drift_check(wd, adv_ops, pipe, wide_codes, y, step,
                               adv_batch, kept, trajectory, card_losses)


def drift_check(wd, adv_ops, pipe, wide_codes, y, step, adv_batch, kept,
                trajectory, card_losses) -> None:
    """The card's first steps again on the CPU through the plain versions.

    Gated, step by step: from the card's parameters before step i, the
    CPU's step on the same batch gives a loss within 1e-5 x max(1, |loss|)
    of the card's and parameters within allclose(rtol=1e-4, atol=1e-6) of
    the card's after step i, for every step up to and including the last.
    Where a hidden unit's pre-activation lies within rounding of zero, the
    card and the CPU can take different ReLU branches on that row: its
    gradient then differs by the whole back-propagated term, which no
    tolerance bounds. So a step that fails on its whole batch is stepped
    again, on the card and on the CPU from the same parameters, on the
    batch without the rows where the two devices' branches differ (read
    from both devices' pre-activations, not from a threshold), and must
    then hold at the same tolerances; a step that fails with no such row,
    or fails again without them, fails the run. Each such step is printed
    with its rows and their largest |pre-activation|.
    Printed, not gated: the CPU run free from the same initial parameters
    (no re-synchronisation), beside the CPU's own run from initial
    parameters scaled by (1 + 2**-23), about one rounding: SGD through
    ReLUs splits trajectories wherever a pre-activation changes sign, so
    any two float32 orders part by far more than 1e-5 within some hundred
    steps of this training."""
    fused_cpu = adv_ops.fuse_tables([c.fused_host for c in pipe.plan.plans],
                                    "cpu")

    from torch.utils import _pytree as pytree

    def cpu(p, scale=1.0):
        return wd.params_from_reference(pytree.tree_map(
            lambda a: a * np.float32(scale), wd.params_to_numpy(p)), "cpu")

    def cpu_args(idx):
        return (torch.from_numpy(np.stack([wide_codes["state"][idx],
                                           wide_codes["device"][idx]])),
                adv_ops.gather_fused_parts(
                    fused_cpu, torch.from_numpy(pipe.plan.host_codes(idx))),
                torch.from_numpy(y[idx]),
                [torch.from_numpy(wide_codes["state"][idx])])

    def pre_activations(p, args):
        # forward_widedeep's MLP up to its last hidden layer, op for op
        _, h, _, embed_codes = args
        h = torch.cat([h] + [tab[c] for tab, c in zip(p["embeds"],
                                                        embed_codes)], dim=-1)
        out = []
        for layer in p["mlp"][:-1]:
            h = torch.matmul(h, layer["w"]) + layer["b"]
            out.append(h.cpu())
            h = torch.relu(h)
        return out

    def split_rows(p, card_args, p_cpu, args):
        # rows where the card and the CPU take different ReLU branches, and
        # the largest |pre-activation| (the CPU's) at a unit that splits
        rows, largest = torch.zeros(len(args[2]), dtype=torch.bool), 0.0
        for a, b in zip(pre_activations(p, card_args),
                        pre_activations(p_cpu, args)):
            split = (a > 0) != (b > 0)
            rows |= split.any(dim=1)
            if split.any():
                largest = max(largest, float(b[split].abs().max()))
        return rows.numpy(), largest

    def differences(i, card_loss, card_p, loss, p_next):
        # the gate's failures for one step, and its largest differences
        msgs = []
        d = abs(card_loss - float(loss))
        if d > 1e-5 * max(1.0, abs(float(loss))):
            msgs.append(f"train parity: step {i} from the card's parameters: "
                        f"loss {card_loss!r} on the card vs {float(loss)!r} "
                        "on the CPU")
        got, _ = pytree.tree_flatten_with_path(wd.params_to_numpy(card_p))
        worst_p = 0.0
        for (path, a), b in zip(got, pytree.tree_leaves(
                wd.params_to_numpy(p_next))):
            worst_p = max(worst_p, float(np.abs(a - b).max()))
            if not np.allclose(a, b, rtol=1e-4, atol=1e-6):
                msgs.append(f"train parity: parameter {pytree.keystr(path)} "
                            f"after step {i} differs from the CPU's step by "
                            f"{np.abs(a - b).max()!r}")
        return msgs, d, worst_p

    free, nudged = cpu(trajectory[0]), cpu(trajectory[0], 1 + 2 ** -23)
    worst = param_worst = 0.0
    free_worst = (0.0, 0)
    nudged_worst = (0.0, 0)
    restepped = []
    t0 = time.perf_counter()
    for i, idx in enumerate(kept):
        args = cpu_args(idx)
        p_next, loss = step(cpu(trajectory[i]), *args)
        msgs, d, d_p = differences(i, card_losses[i], trajectory[i + 1], loss,
                                   p_next)
        if msgs:
            first, whole = msgs[0], d_p
            keep = np.ones(idx.size, dtype=bool)
            largest = 0.0
            for _ in range(3):
                sub = idx[keep]
                card_args = adv_batch(sub)[0]
                rows, h = split_rows(trajectory[i], card_args,
                                     cpu(trajectory[i]), cpu_args(sub))
                if not rows.any():
                    break
                largest = max(largest, h)
                keep[np.flatnonzero(keep)[rows]] = False
                sub = idx[keep]
                card_p, card_loss = step(trajectory[i], *adv_batch(sub)[0])
                p_next, loss = step(cpu(trajectory[i]), *cpu_args(sub))
                msgs, d, d_p = differences(i, float(card_loss), card_p, loss,
                                           p_next)
                if not msgs:
                    break
            if msgs:
                fail(f"{msgs[0]} (on the whole batch: {first}; rows where "
                     f"the two devices' ReLU branches differ left out: "
                     f"{int((~keep).sum())})")
            restepped.append((i, int((~keep).sum()), largest, whole))
        worst, param_worst = max(worst, d), max(param_worst, d_p)
        free, lf = step(free, *args)
        nudged, ln = step(nudged, *args)
        free_worst = max(free_worst, (abs(card_losses[i] - float(lf)), i))
        nudged_worst = max(nudged_worst, (abs(float(lf) - float(ln)), i))
    log(f"train parity vs the CPU's plain versions, {len(kept)} steps each "
        f"from the card's parameters ({time.perf_counter() - t0:.3f} s on "
        f"the CPU with the free runs): largest |loss difference| {worst!r} "
        f"(limit 1e-5 x max(1, |loss|)); largest parameter difference "
        f"{param_worst!r} (allclose rtol 1e-4, atol 1e-6)")
    log(f"  steps held without the rows where the card's and the CPU's ReLU "
        f"branches differ: {len(restepped)} of {len(kept)}" + "".join(
            f"; step {i}: {n} rows left out, largest |pre-activation| there "
            f"{h!r}, whole-batch parameter difference {w!r}"
            for i, n, h, w in restepped))
    log(f"  free runs from the same initial parameters, not gated: card vs "
        f"CPU largest |loss difference| {free_worst[0]!r} at step "
        f"{free_worst[1]}; CPU vs CPU from parameters x (1 + 2**-23) "
        f"{nudged_worst[0]!r} at step {nudged_worst[1]}")


# -- phase 6 ------------------------------------------------------------------


def cycle_phase(analytics_cycle, dev) -> None:
    """``examples/analytics_cycle.py`` through the port on the card, at
    the example's sizes and seeds; its two asserts must hold."""
    t0 = time.perf_counter()
    r = analytics_cycle(dev)
    wall = time.perf_counter() - t0
    log(f"analytics cycle (N = 30,000, K = 200, 4 latent groups, batch 512, "
        f"800 + 400 steps) in {wall:.3f} s")
    log(f"  round 1 (hash8 + per-code embedding): loss {r['l1'][0]:.6f} -> "
        f"{r['r1']:.6f}; wrote back {r['advs']}")
    log(f"  learned-bucket purity vs the decision grouping: "
        f"{r['purity']:.6f}")
    log(f"  round 2 (learned bucketization only): loss {r['l2'][0]:.6f} -> "
        f"{r['r2']:.6f}; round 2 / round 1 = {r['r2'] / r['r1']:.6f}")
    if not r["r2"] < 1.2 * r["r1"]:
        fail(f"analytics cycle: round 2 {r['r2']} not below 1.2 x round 1 "
             f"{r['r1']}")
    if not r["purity"] > 0.75:
        fail(f"analytics cycle: purity {r['purity']} not above 0.75")


# -- phase 7 ------------------------------------------------------------------


def table6_path(AugmentedDictionary, stats, to_device, unpack_ops, hist_ops,
                adv_ops, d, host_codes, col, dev, rng,
                batch: int = 65_536) -> None:
    """Paper Table 6 / §6.1-6.3 on the card, as ``bench_featurize.run``
    drives it: the catalog on the host, then the column's words unpacked,
    counted and featurized on the card; every result held against the host
    (card walls: median of 3 calls, each synchronised)."""
    n = col.n_rows
    aug, t = host_clock(lambda: table6_advs(AugmentedDictionary, d))
    log(f"catalog: {len(aug.advs) - 1} transforms + zscore on K = "
        f"{d.cardinality} entries in {t:.6f} s; feature widths "
        f"{ {name: adv.dim for name, adv in aug.advs.items()} }")

    (words, db), t = host_clock(col.device_words)
    if db != 16 or d.bits != 10:
        fail(f"Table 6 column packs {d.bits} bits at device width {db}, "
             "not 10 at 16")
    words_dev, ts = clocked(lambda: to_device(words.view(np.int32), dev), 1)
    codes, tu = clocked(lambda: unpack_ops.bitunpack(words_dev, db, n))
    if not np.array_equal(codes.cpu().numpy(), host_codes):
        fail("bitunpack of the column's device words differs from its codes")
    log(f"ship + bitunpack: {words.nbytes} B of {db}-bit words (host view "
        f"{t:.6f} s, shipped in {ts:.6f} s) -> {n} int32 codes in "
        f"{tu:.6f} s; all {n} equal the host codes")

    counts, tc = clocked(lambda: hist_ops.hist(codes, d.cardinality))
    if not np.array_equal(counts.cpu().numpy(), d.counts):
        fail("hist of the unpacked codes differs from Dictionary.counts")
    log(f"hist: {d.cardinality} counts of {n} codes in {tc:.6f} s; equal "
        "to Dictionary.counts")
    for op in ("sum", "mean", "std", "histogram", "minmax"):
        fast, tf = host_clock(
            lambda: getattr(stats, f"{op}_from_dictionary")(col))
        slow, tsc = host_clock(lambda: getattr(stats, f"{op}_scan")(col))
        if op == "histogram":
            same = dict(zip(fast[0].tolist(), fast[1].tolist())) == \
                dict(zip(slow[0].tolist(), slow[1].tolist()))
        elif op == "std":
            # two float64 summation orders: within rounding, not bit equal
            same = abs(fast - slow) <= 1e-12 * abs(slow)
        else:
            same = fast == slow
        if not same:
            fail(f"stats.{op}_from_dictionary differs from stats.{op}_scan")
        shown = "(values, counts)" if op == "histogram" else repr(fast)
        log(f"  stats.{op}: {shown} from the dictionary in {tf:.6f} s, "
            f"the scan in {tsc:.6f} s ({tsc / tf:.1f}x)")

    table = to_device(aug["zscore"].table, dev)
    feats, tg = clocked(lambda: adv_ops.adv_gather(table, codes))
    want, th = host_clock(lambda: aug.featurize("zscore", host_codes))
    if feats.shape != want.shape or \
            not np.array_equal(feats.cpu().numpy(), want):
        fail("adv_gather of zscore over the column differs from featurize")
    log(f"adv_gather zscore over the whole column: ({n}, 1) in {tg:.6f} s; "
        f"host featurize {th:.6f} s; all {n} rows bit-exact")

    batch = min(batch, n)
    start = int(rng.integers(0, n - batch + 1))
    batch_codes, host_batch = codes[start:start + batch], \
        host_codes[start:start + batch]
    for kind, _ in table6_catalog():
        name = f"b_{kind}"
        table = to_device(aug[name].table, dev)
        feats, tg = clocked(lambda: adv_ops.adv_gather(table, batch_codes))
        want, th = host_clock(lambda: aug.featurize(name, host_batch))
        if feats.shape != want.shape or \
                not np.array_equal(feats.cpu().numpy(), want):
            fail(f"adv_gather of {name} over the batch differs from "
                 "featurize")
        log(f"  {name}: ({batch}, {aug[name].dim}) from rows {start}.."
            f"{start + batch - 1} in {tg:.6f} s; host featurize {th:.6f} s; "
            f"all {batch} rows bit-exact")


def table6_advs(AugmentedDictionary, d):
    """The catalog's ten ADVs (``b_<kind>``) and ``zscore`` on ``d``."""
    aug = AugmentedDictionary(d)
    for kind, params in table6_catalog():
        aug.add(f"b_{kind}", kind, **params)
    aug.add("zscore", "zscore")
    return aug


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-log2", type=int, default=25)
    ap.add_argument("--train-steps", type=int, default=500,
                    help="ADV train steps of phase 5")
    ap.add_argument("--parity-steps", type=int, default=200,
                    help="of them, how many are held to the CPU's step")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.columnar import Column, Dictionary, Table
    from repro_torch.columnar import query as Q
    from repro_torch.columnar import stats
    from repro_torch.core import (AugmentedDictionary, FeatureExecutor,
                                  FeaturePipeline, FeaturePlan, FeatureSet)
    from repro_torch.core.cycle import analytics_cycle
    from repro_torch.core.pipeline import to_device
    from repro_torch.kernels import build
    from repro_torch.kernels import edge_cases as ec
    from repro_torch.kernels.adv_gather import ops, ref
    from repro_torch.kernels.bitunpack import ops as unpack_ops
    from repro_torch.kernels.bitunpack import ref as unpack_ref
    from repro_torch.kernels.hist import ops as hist_ops, ref as hist_ref
    from repro_torch.kernels.predicate_scan import ops as scan_ops
    from repro_torch.kernels.onehot_wide import ops as wide_ops
    from repro_torch.kernels.onehot_wide import ref as wide_ref
    from repro_torch.kernels.predicate_scan import ref as scan_ref
    from repro_torch.models import widedeep as wd
    from repro_torch import serve as S
    from repro_torch.serve import FeatureService
    counters = (ops, scan_ops, hist_ops, wide_ops, unpack_ops)

    # -- 1. setup ---------------------------------------------------------------
    phase_t0 = time.perf_counter()
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
    raw = serving_data(rng, n_rows)
    table = Table.from_data(raw)
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
    # the train path (paper Fig 2): bench_pipeline.py's labels and features
    # over the same table, its wide and embedded codes from the host codes
    t0 = time.perf_counter()
    y = bench_labels(raw, np.random.default_rng(args.seed + 5))
    del raw
    pipe = FeaturePipeline(table, bench_features(FeatureSet), device=dev)
    wide_codes = {c: table[c].codes() for c in ("state", "device")}
    torch.cuda.synchronize()
    log(f"train pipeline: int32 plan over columns {pipe.plan.columns}, "
        f"out_dim {pipe.out_dim}, {float(y.mean()):.6f} positive labels; "
        f"built in {time.perf_counter() - t0:.3f} s")
    if pipe.out_dim != 4:
        fail("train pipeline does not have the benchmark's out_dim of 4")

    # the pushdown path's predicates, over the load-order dictionaries
    p1 = Q.eq("state", 7) & Q.between("age", 30, 45)
    p2 = Q.isin("device", [1, 3]) | Q.ge("income", 240000)
    log("pushdown predicates:")
    compiled_kinds(ex_p, {"P1": p1, "P2": p2})

    # paper Table 6's column at the serving table's size
    t0 = time.perf_counter()
    d6, codes6, col6 = table6_column(Dictionary, Column,
                                     np.random.default_rng(args.seed + 9),
                                     n_rows)
    log(f"Table 6 column: {n_rows} rows, K = {d6.cardinality}, {d6.bits} "
        f"bits in {col6.n_imcus} IMCUs ({col6.packed_nbytes} B), device "
        f"width 16; built in {time.perf_counter() - t0:.3f} s")

    log(f"phase 1 (setup) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 2. kernels vs plain ----------------------------------------------------
    phase_t0 = time.perf_counter()
    log("kernels vs plain versions (bit for bit; the wide gradient against "
        "the CPU and across two launches):")
    errs = gather_edge_cases(ec, ops, ref, dev,
                             np.random.default_rng(args.seed + 1))
    errs.update(pushdown_edge_cases(ec, scan_ops, scan_ref, hist_ops,
                                    hist_ref, dev,
                                    np.random.default_rng(args.seed + 4)))
    errs.update(wide_edge_cases(ec, wide_ops, wide_ref, dev,
                                np.random.default_rng(args.seed + 6)))
    log(f"  edge cases hold: {sorted(errs)}")
    coalesce, bucket, range_batch = 4, 512, 4096
    kernels = main_shape_kernels(ops, ref, ex_p, plan_p, plan_i, n_rows,
                                 np.random.default_rng(args.seed + 2),
                                 coalesce * bucket, range_batch, bucket)
    kernels.update(pushdown_shape_kernels(scan_ops, scan_ref, hist_ops,
                                          hist_ref, ex_p, plan_p, n_rows, p1,
                                          p2, "device", "income"))
    train_kernels = train_shape_kernels(
        wide_ops, wide_ref, ops, ref, pipe, wide_codes,
        np.random.default_rng(args.seed + 7), 1024, dev)
    kernels.update({k: train_kernels[k]
                    for k in ("onehot_wide", "onehot_wide_backward")})
    sweep_shape_kernels(wide_ops, wide_ref,
                        np.random.default_rng(args.seed + 8), dev)
    errs.update(table6_edge_cases(ec, unpack_ops, unpack_ref, hist_ops,
                                  hist_ref, ops, ref, dev,
                                  np.random.default_rng(args.seed + 10)))
    words6, db6 = col6.device_words()
    kernels.update(table6_shape_kernels(
        unpack_ops, unpack_ref, hist_ops, hist_ref, ops, ref,
        to_device(words6.view(np.int32), dev), db6, to_device(codes6, dev),
        d6.cardinality,
        to_device(table6_advs(AugmentedDictionary, d6)["zscore"].table, dev)))
    log("  Table 6 edge cases hold: bitunpack, hist, adv_gather")
    log(f"phase 2 (kernels vs plain) wall: "
        f"{time.perf_counter() - phase_t0:.3f} s")

    # -- 3. serving path ---------------------------------------------------------
    phase_t0 = time.perf_counter()
    req_rng = np.random.default_rng(args.seed + 3)
    sizes = (128, 256, 512)
    packed_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                   for _ in range(4096)]
    int32_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                  for _ in range(512)]
    pushdown_reqs = [req_rng.integers(0, n_rows, int(req_rng.choice(sizes)))
                     for _ in range(256)]
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
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
    launches = {k: ops.LAUNCHES[k] for k in
                ("adv_gather_packed_rows", "adv_gather_packed",
                 "gather_fused_parts")}
    log(f"kernels launched on the serving path: {dict(ops.LAUNCHES)}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the serving path: {idle}")
    log(f"phase 3 (serving) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 3b. front door ------------------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    host_p1 = host_clock(lambda: Q.predicate_mask_host(table, p1))
    log(f"front door (bench_featurize.py's serve/feature_service_frontend "
        f"over this table, one shard; P1's host mask {host_p1[1]:.6f} s):")
    front = front_door_path(S, ops, scan_ops, ex_p, plan_p, plan_i, p1,
                            np.flatnonzero(host_p1[0]),
                            np.random.default_rng(args.seed + 12), counters)
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    log(f"phase 3b (front door) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 4. pushdown path ----------------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    pushdown_path(Q, FeatureService, ex_p, plan_p, table, p1, p2, "device",
                  "income", dict(prefetch=2, buckets=(bucket,),
                                 coalesce=coalesce), pushdown_reqs, host_p1)
    pushed = {**scan_ops.LAUNCHES,
              "masked_counts": hist_ops.LAUNCHES["masked_counts"]}
    log(f"kernels launched on the pushdown path: "
        f"{dict(**pushed, **ops.LAUNCHES)}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in pushed.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the pushdown path: {idle}")
    launches.update(pushed)
    for k, v in front.items():
        launches[k] += v
    log(f"phase 4 (pushdown) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 5. train path (paper Fig 1/2) ----------------------------------------------
    phase_t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the train path's parity needs full float32")
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    parity = train_path(wd, to_device, ops, wide_ops, pipe, table, wide_codes,
                        y, args.seed, dev, train_kernels,
                        steps=args.train_steps,
                        drift_steps=args.parity_steps)
    trained = {"gather_fused_parts": ops.LAUNCHES["gather_fused_parts"],
               **wide_ops.LAUNCHES}
    log(f"kernels launched on the train path: "
        f"{dict(**ops.LAUNCHES, **wide_ops.LAUNCHES)}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in trained.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the train path: {idle}")
    launches.update(wide_ops.LAUNCHES)
    parity()
    log(f"phase 5 (train path) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 6. analytics cycle (paper §7) ----------------------------------------------
    phase_t0 = time.perf_counter()
    for counter in counters:
        counter.reset_launches()
    cycle_phase(analytics_cycle, dev)
    cycled = {k: v for counter in counters
              for k, v in counter.LAUNCHES.items()}
    log(f"kernels launched on the analytics cycle: {cycled} (its models "
        "have no wide columns, C = 0: the wide term is zero without a "
        "launch, and its deep features are host ADV lookups)")
    if any(cycled.values()):
        fail("the analytics cycle launched a kernel it has no use for")
    log(f"phase 6 (analytics cycle) wall: "
        f"{time.perf_counter() - phase_t0:.3f} s")

    # -- 7. Table 6 on the card (paper Table 6, §6.1-6.3) ------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    table6_path(AugmentedDictionary, stats, to_device, unpack_ops, hist_ops,
                ops, d6, codes6, col6, dev,
                np.random.default_rng(args.seed + 11))
    table6 = {"bitunpack": unpack_ops.LAUNCHES["bitunpack"],
              "hist": hist_ops.LAUNCHES["hist"],
              "adv_gather": ops.LAUNCHES["adv_gather"]}
    log(f"kernels launched on the Table 6 path: "
        f"{ {k: v for c in counters for k, v in c.LAUNCHES.items()} }")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    idle = [k for k, v in table6.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the Table 6 path: {idle}")
    launches.update(table6)
    log(f"phase 7 (Table 6) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 8. report ------------------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max(k["max_abs_err"], errs[name]), "ms": k["ms"],
         "cold_ms": k["cold_ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
