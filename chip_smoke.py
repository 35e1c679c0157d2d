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
3c. sharded serving — launch counts set to 0 again; the serving table
   again in 4 IMCUs of 2**23 rows (``bench_featurize.py``'s n // 4; its
   dictionaries copied), served by ``FeatureService(sharded=True)``: 4
   shards on 4 streams of cuda:0, one copy of the ADV tables. A: the
   ``_sharded_serve_comparison`` mix (4,096 64-row blocks at word-aligned
   starts, buckets (64,), coalesce 8, linger 1 ms) against the unsharded
   packed service as control, one warm-up and three timed runs each in
   turns (rows/s, p50/p99, launches, the kernel's share of the wall,
   resident bytes). D: ``count_where`` of P1 and P2, ``filtered_rows``,
   ``groupby_where``, ``agg_where`` and ``submit(where=P1)`` on the sharded
   service, each equal to the unsharded executor's answer bit for bit. B:
   the ``_skewed_serve_comparison`` mix (800 Zipf(1.2) blocks, hot_factor
   2, max_replicas 3; three warm-up loops each followed by
   ``rebalance()``): the hot shard must gain a replica; launches per
   stream. E: one sharded burst over the int32 plan (host routing). C: an
   append of 2**20 rows to a service built with ``row_budget`` = 2**23,
   ``rebalance()`` splits the tail at 2**25, then requests across the new
   seam. Every second to eighth result (>= 10,000 rows a run) equals
   ``host_features`` bit for bit; any retry or failed ticket fails the
   phase. The packed rows gather, the int32 gather, the scan and the
   masked counts must have launched.
3d. fault tolerance and tiers — launch counts set to 0 again; a fresh
   packed plan over phase 3c's 4-IMCU table (four 27,262,976 B streams).
   H: shard 0 on two streams of cuda:0, the straggler EWMA warmed, one
   launch stalled 0.6 s (``FaultPolicy(hedge_min_s=0.02,
   hedge_factor=2.0)``, tests/test_chaos_serving.py:525): ``hedges``
   and ``hedge_wins`` >= 1, the ticket under 0.5 s, ``completed`` up by
   1; the ``hedge=False`` control waits the stall out; one ungated run
   with the stream the pump picks next asleep on the card; a sampled Zipf
   burst. L: 512 Zipf(1.2) 64-row blocks, ``kill_device(torch.device(
   "cuda"))`` after 128: availability 1.0, no failed ticket,
   ``devices_lost`` 1, ``host_gathers`` > 0, no word left on the card,
   no recovery without a survivor; the device revived in the injector
   and in DeviceHealth, the pump's rebuild arm recommits all four shards
   and launches resume. T: ``hbm_budget_bytes`` of two streams,
   ``cold_after=2``: tiers start hot, hot, warm, warm; serial hot and
   tier-miss latencies; Zipf traffic at shard 3 with the monitor on until
   a promotion displaces a colder shard, the budget held after every
   tick; a quiet warm shard aged to cold and served from its RLE runs; a
   demote/promote round trip that frees the stream's bytes on the card;
   P1 pushdown on the tiered service equal to the unsharded executor's.
   Every part holds >= 10,000 served rows against ``host_features`` bit
   for bit; the packed rows gather, the scan and the masked counts must
   have launched.
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
8. LM serving — launch counts set to 0 again (no hand-written kernel
   runs here: the LM's products, the MoE experts' batched ones too, are
   cuBLAS calls, as the reference's are XLA's einsums; the counts must
   stay 0), TF32 off. A: the five dense and vlm
   archs (glm4-9b, qwen2-7b, minicpm-2b, starcoder2-15b,
   llava-next-mistral-7b) at ``reduced()`` in float32, parameters from the
   port's seeded init on the CPU copied to the card: ``ServeEngine`` on
   the card against the same engine on the CPU, 3 requests of 6 tokens, 8
   new, greedy tokens equal; prefill and decode logits over those tokens
   within rtol 1e-4 / atol 1e-5; also glm4-9b with the int8 cache and at
   max_len 2,048 (the flash prefill). B: glm4-9b at full width and depth
   in bf16 (9,399,767,040 parameters, 18,799,534,080 B, drawn on the card
   from ``--seed``): 8 requests of 128-token prompts, 32 new tokens,
   max_len 160 (direct attention), then 4 requests of 1,024-token prompts,
   16 new tokens, max_len 2,048 (the flash prefill). Each batch is served
   by the engine, then replayed through prefill and decode (timed: prefill
   tokens/s, decode ms/step, each beside its bound) and held against
   ``lm.forward`` over the same tokens: every logit finite, max |serve -
   forward| within ``LM_LOGIT_TOL``, the greedy tokens equal the
   forward's argmax wherever its top-2 margin exceeds that tolerance;
   ``max_memory_allocated`` at least the weights' bytes; one decode
   step's launches from ``torch.profiler``. MoE: A adds reduced
   moonshot-v1-16b-a3b and llama4-maverick at max_len 24 and 2,048, their
   expert ids equal on the card and the CPU but for a decision whose CPU
   top-k margin is under 1e-5, at most 2 a run (``lm_parity.route_flips``;
   logits held before each sequence's first flip). Then, each model freed
   before the next, in bf16 drawn on the card from ``--seed``:
   moonshot-v1-16b-a3b at full width and depth (56,959,045,632 B) and
   llama4-maverick at full width over 2 of its 48 layers (one dense, one
   MoE; 37,111,777,280 B). M1, as configured (capacity factor 1.25): 8 x
   128-token prompts, 32 new, max_len 160; the replay's prefill and decode
   timed against their bounds (a decode step's bound reads only the
   distinct experts its tokens chose, from the routing trace; the read of
   every expert that products over all of them make is logged beside
   it), the dropped pairs a layer logged, the prefill's logits within
   ``LM_LOGIT_TOL`` of ``lm.forward`` over exactly the prompts. M2, the
   same weights at capacity factor E/k + 1 (nothing drops: moonshot 4 x
   1,024, 16 new, max_len 2,048; maverick 8 x 128 as M1): the served
   sequence replayed through the serve path with the forward's expert ids
   forced (``moe.routing_trace``, each position's ids to the call that
   reads it), within ``LM_LOGIT_TOL`` at every position and its argmax
   the forward's wherever the forward's top-2 margin exceeds it; the
   unforced replay's routing flips and greedy agreement logged, not
   gated. Audio: A adds reduced seamless-m4t-large-v2 at max_len 24 over
   frames from the ported loader (``repro_torch.data.token_batches``), 6
   frames and then 2,048 (the direct and the flash route of
   ``_bidir_attention``, in the encoder and in cross-attention), served
   through ``lm_parity.greedy`` (prefill with the frames, decode on the
   memory), and once through the engine on an empty memory. Then
   seamless-m4t-large-v2 at full width and depth (24 encoder + 24 decoder
   layers, 4,070,100,992 B of bf16 weights drawn from ``--seed``), fed by
   a ``TokenStore`` over ``synthetic_corpus(1,000,000, 256,206)`` (18
   bits, 32-bit device words): B1, 8 x 128 tokens over 128 frames, 32
   new; B2, 4 x 128 tokens over 2,048 frames, 16 new; each prefill held
   against ``lm.forward`` over exactly the prompts, each replay against
   the forward at every position, within ``LM_LOGIT_TOL`` and argmax
   equal past it; prefill and decode timed against their bounds.
   Recurrent: A adds reduced xlstm-1.3b (mLSTM and sLSTM blocks; its
   float32 atol 1e-4, ``lm_parity.ATOL_BY_ARCH``) and hymba-1.5b
   (attention beside SSD heads) at max_len 24 and 2,048. Then each of
   xlstm-1.3b (48 layers, 4,497,625,088 B in bf16) and hymba-1.5b (32
   layers, 3,448,838,400 B) at full width and depth, drawn on the card
   from ``--seed`` in bf16 and then in float32: R1, 8 x 128-token
   prompts, 32 new, max_len 160; R2, 4 x 1,024, 16 new, max_len 2,048.
   Each batch is served by the engine, replayed (prefill and decode timed
   against their bounds, one step's launches) and held against
   ``lm.forward``: the prefill over exactly the prompts, teacher forcing
   over the served sequence (padded to 2,048 past 1,024). float32: both
   within 0.01 and every clear argmax equal; bf16: within
   ``RECURRENT_BF16_TOL``, twice the reference's own gap on the CPU, the
   clear argmaxes that agree printed beside the reference's.
9. LM training — launch counts set to 0 again (as in phase 8, no
   hand-written kernel runs here; the counts must stay 0), TF32 off. A:
   ``train.parity.check_train_card_matches_cpu`` for every arch of
   ``configs.ARCH_IDS`` at ``reduced()`` in float32, B 2 x S 16: one
   ``train_loss`` step on the card against the CPU (loss within 1e-5 x
   max(1, loss), each gradient leaf within rtol 1e-4 / atol 1e-5 x its CPU
   std, xlstm 1e-3, maverick 3e-5, hymba 1e-4), then one ``apply_updates``
   of each optimizer from the CPU's gradients and state (rtol 1e-6 / atol
   1e-8, AdamW8 at most 8 int8 codes a leaf one apart); then reduced
   glm4-9b at S 2,048 with ``loss_chunk`` 1,024 and ``remat="layer"`` (the flash
   backward, ``chunked_ce`` and remat on the card). B: the flash backward at
   minicpm-2b's layer shape (qg 2 x 2,048 x 36 x 1 x 64, chunk 1,024,
   windows 0 and 1,024) against autograd of direct softmax attention, in
   float32 (max |d| <= 1e-4 x max |reference|) and in bf16 against float32
   direct attention over the same bf16 values (1e-2); each route's
   forward-plus-backward ms and peak memory. C: ``chunked_ce`` at the full
   vocabulary (tied head 2,304 x 122,880, B 2 x S 2,048, float32) against
   the unchunked loss: the loss, and the gradients of ``x_final`` and of
   the head within 1e-5 x max |reference|. D: minicpm-2b at full width and
   depth in bf16 (2,725,173,504 parameters, 5,450,347,008 B, drawn on the
   card from ``--seed``, ``remat="layer"``), batches from ``token_batches``
   over ``TokenStore(synthetic_corpus(2,000,000, 122,753))``: the first
   batch's loss in bf16 and with a float32 copy of the weights, within
   ``TRAIN_BF16_LOSS_TOL``; T1, the ``Trainer`` with AdamW, lr 3e-3, WSD,
   12 steps, warmup 2, B 2 x S 2,048 (the launcher's defaults for this
   arch): each step's loss, grad norm and lr, every one finite and the
   loss at step 11 below step 0's; the median step over steps 2-11 beside
   its bound (``lm_train_flops``) and the function's own
   (``lm_train_flops_causal``), host calls and device time of one more
   step, the optimizer's ms, peak memory; T2, the same model with AdamW8
   for 4 steps, its state's bytes beside AdamW's, peak memory.
10. dry-run and model sharding — launch counts set to 0 again (no
   hand-written kernel runs here; the counts must stay 0), TF32 off. A: a
   one-rank NCCL mesh, (1, 1) ("data", "model") on cuda:0: every arch at
   ``reduced()`` in float32, 2 AdamW steps of B 2 x S 16 through
   ``make_train_step(mesh=)`` against 2 meshless steps from the same
   init, the losses and every parameter bit for bit; then minicpm-2b at
   full width and depth in bf16 on T1's first batch, ``loss_and_grads``
   twice meshless and once on the mesh, the mesh's loss and each gradient
   leaf no further from the first meshless run than the second is; both
   steps' ms and host calls printed. B: ``launch.dryrun``'s trace of
   minicpm-2b's T1 step (2 x 2,048, AdamW, remat "layer") on that mesh
   against the same step run for real with its parameters and state
   resident: FLOPs equal to ``FlopCounterMode``'s count exactly, the
   predicted peak within [0.85, 1.15] of ``max_memory_allocated``. C:
   under a fake process group of 256 ranks on cuda:0, rank 0's share of
   glm4-9b ``train_4k`` on the (32, 8) production mesh run for real (its
   collectives move nothing; glm4-9b ``prefill_32k`` instead where the
   prediction passes 72 GB): FLOPs equal to the trace's exactly, peak
   within [0.85, 1.15] of the prediction, its ms beside the roofline's
   compute and memory terms (H100 published figures).
11. report — one JSON line per the kernel table, the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. Without CUDA, or
without the package beside this script, it exits nonzero at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import itertools
import json
import math
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


# -- phase 3c -----------------------------------------------------------------

SHARD_RSZ = 64      # bench_featurize.py:_sharded_serve_comparison's rsz
N_SHARDS = 4        # its n_shards: IMCUs of n // 4 rows (2**23 at 2**25)


def sharded_table(Column, Dictionary, Table, table, imcu_rows: int):
    """The serving table again, its IMCUs ``imcu_rows`` long: each column's
    codes under a copy of its dictionary, so appends to this table leave
    the other phases' table as it was."""
    cols = {}
    for name in table.names:
        d = table[name].dictionary
        cols[name] = Column(Dictionary(values=d.values.copy(),
                                       counts=d.counts.copy(), name=d.name,
                                       sorted_codes=d.sorted_codes),
                            table[name].codes(), imcu_rows=imcu_rows)
    return Table(cols)


def shard_streams(sx) -> set:
    """The CUDA streams the shards' primary executors launch on."""
    return {ex.stream.cuda_stream for ex in sx.executors}


def stream_counter(svc) -> dict:
    """Count each launch by the stream that made it (wraps ``_launch``)."""
    counts: dict = {}
    orig = svc._launch

    def counted(group, s, ex, stream):
        counts[(s, ex.stream_token)] = counts.get((s, ex.stream_token),
                                                  0) + 1
        return orig(group, s, ex, stream)
    svc._launch = counted
    return counts


def launch_counts(counters) -> dict:
    """Every kernel's launch count, by name, as the wrappers have it now."""
    return {k: v for c in counters for k, v in c.LAUNCHES.items()}


def burst(svc, reqs, every: int):
    """The bench's loop: submit every request, then drain; returns the
    wall and every ``every``-th (rows, features)."""
    t0 = time.perf_counter()
    tickets = [svc.submit(r) for r in reqs]
    out = svc.drain(timeout=120)
    wall = time.perf_counter() - t0
    if len(out) != len(tickets):
        fail(f"a burst resolved {len(out)} of {len(tickets)} tickets")
    return wall, [(reqs[i], out[t]) for i, t in enumerate(tickets)
                  if i % every == 0]


def check_clean(name: str, svc) -> None:
    """Fail on any retry or failed ticket of a fault-free run."""
    st = svc.stats
    if st["retries"] or st["failed_tickets"] or st["failovers"]:
        fail(f"{name}: the fault-free run retried or failed tickets "
             f"(retries {st['retries']}, failed {st['failed_tickets']})")


def sharded_path(S, ops, scan_ops, hist_ops, ex_p, plan_p, plan_s, plan_i,
                 p1, p2, rng, counters) -> dict:
    """Phase 3c: bench_featurize.py's sharded and skewed serve mixes on the
    serving table cut into 4 IMCU shards (4 streams of cuda:0) against the
    unsharded packed service, then sharded pushdown held against the
    unsharded executor, a sharded int32 burst, and a tail split after an
    append. Returns the launches."""
    n_rows = plan_s.n_rows
    svc_kw = dict(buckets=(SHARD_RSZ,), coalesce=8, linger_us=1000.0)
    # A. _sharded_serve_comparison: 64-row blocks at word-aligned starts
    starts = rng.integers(0, (n_rows - SHARD_RSZ) // 32, 4096) * 32
    reqs = [np.arange(s, s + SHARD_RSZ) for s in starts]
    svc = S.FeatureService(plan_s, sharded=True, **svc_kw)
    ctl = S.FeatureService(plan_p, **svc_kw)
    sx = svc._sharded_ex
    if svc.n_shards != N_SHARDS:
        fail(f"the sharded table has {svc.n_shards} shards, not "
             f"{N_SHARDS}")
    streams = shard_streams(sx)
    if len(streams) != N_SHARDS or \
            torch.cuda.default_stream().cuda_stream in streams:
        fail(f"the {N_SHARDS} shards launch on {len(streams)} streams of "
             "their own")
    # the kernel at this path's launch (8 x 64 shard-local rows), on the
    # default stream once the shard's put has landed
    ex0 = sx.executors[0]
    torch.cuda.synchronize()
    launch_rows = torch.from_numpy(rng.integers(
        0, ex0.plan.n_rows, 8 * SHARD_RSZ).astype(np.int32)).to(plan_s.device)
    k_ms = time_ms(lambda: ops.adv_gather_packed_rows(
        ex0._flat_words, ex0._wmeta, ex0._device_fused(), launch_rows),
        iters=50, reps=15, queue_ahead=True)
    # the unsharded executor's pushdown answers, which D holds the
    # sharded ones against (taken before the counts are set to 0)
    want = {"count_where(P1)": ex_p.count_where(p1),
            "count_where(P2)": ex_p.count_where(p2),
            "filtered_rows(P1)": ex_p.filtered_rows(p1),
            "groupby_where(device, P2)": ex_p.groupby_where("device", p2)[1],
            "agg_where(P1, income, mean)": ex_p.agg_where(p1, "income",
                                                          "mean")}
    rows_p1 = want["filtered_rows(P1)"]
    feats_p1 = ex_p.batch(rows_p1).cpu().numpy()
    for counter in counters:
        counter.reset_launches()
    # both services pay the per-stream count's wrapper on every launch; the
    # control's launches are taken out of the sharded path's counts
    per_stream, ctl_stream = stream_counter(svc), stream_counter(ctl)
    ctl_launched = dict.fromkeys(launch_counts(counters), 0)

    def control_burst():
        before = launch_counts(counters)
        out = burst(ctl, reqs, 8)
        for k, v in launch_counts(counters).items():
            ctl_launched[k] += v - before[k]
        return out

    runs = {"sharded": lambda: burst(svc, reqs, 8), "control": control_burst}
    checked, walls = [], {"sharded": [], "control": []}
    for key, s in (("sharded", svc), ("control", ctl)):
        checked.append(check_sample(f"{key} warm-up", plan_s,
                                    runs[key]()[1]))
        s.reset_latency_window()
    launches0 = {"sharded": svc.stats["launches"],
                 "control": ctl.stats["launches"]}
    for _ in range(3):
        for key in ("sharded", "control"):
            wall, sampled = runs[key]()
            walls[key].append(wall)
            checked.append(check_sample(f"{key} run", plan_s, sampled))
    rows = len(reqs) * SHARD_RSZ
    for key, s in (("sharded", svc), ("control", ctl)):
        check_clean(key, s)
        st = s.stats
        w = statistics.median(walls[key])
        n_l = st["launches"] - launches0[key]
        log(f"  {key}: {len(reqs)} requests of {SHARD_RSZ} rows a run, "
            f"median wall {w:.6f} s of {[round(x, 6) for x in walls[key]]} "
            f"= {rows / w:.1f} rows/s; p50 "
            f"{s.latency_percentile(50) * 1e3:.4f} ms, p99 "
            f"{s.latency_percentile(99) * 1e3:.4f} ms; {n_l} launches in 3 "
            f"runs, {n_l * k_ms / (sum(walls[key]) * 1e3):.6f} of the wall "
            f"in the kernel ({k_ms:.6f} ms a launch at 8 x 64 rows); "
            f"packed_ranges {st['packed_ranges']}, split_requests "
            f"{st['split_requests']}"
            + (f", shard_launches {st['shard_launches']}"
               if key == "sharded" else ""))
    ratio = statistics.median(walls["control"]) / \
        statistics.median(walls["sharded"])
    fused = {id(ex._device_fused()) for s in range(sx.n_shards)
             for ex in sx.stream_executors(s)}
    words = sx.device_bytes()
    log(f"  sharded / control rows/s {ratio:.4f}; resident on the card: "
        f"{ {str(d): b for d, b in words.items()} } B of words over "
        f"{sx.n_shards} shards (the control's stream "
        f"{ctl._executor.resident_bytes()} B), {len(fused)} copy of the ADV "
        f"tables ({plan_s.fused_tables().nbytes} B), {len(sx._caches)} "
        f"table cache; launches by (shard, stream): {per_stream}, the "
        f"control's {ctl_stream}; the control's kernel launches "
        f"{ {k: v for k, v in ctl_launched.items() if v} }, not counted "
        "below")
    if len(fused) != 1 or len(sx._caches) != 1:
        fail("the shards hold more than one copy of the ADV tables")
    if sum(words.values()) != sum(ex.stream_nbytes()
                                  for ex in sx.executors):
        fail("the shards' resident words are not one stream each")
    ctl.shutdown()
    # D. sharded pushdown against the unsharded executor, bit for bit
    got = {"count_where(P1)": svc.count_where(p1),
           "count_where(P2)": svc.count_where(p2),
           "filtered_rows(P1)": svc.filtered_rows(p1),
           "groupby_where(device, P2)": svc.groupby_where("device", p2)[1],
           "agg_where(P1, income, mean)": svc.agg_where(p1, "income",
                                                        "mean")}
    for k in want:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            fail(f"sharded {k} differs from the unsharded executor's")
    t0 = time.perf_counter()
    feats = svc.result(svc.submit(where=p1), timeout=120)
    t_where = time.perf_counter() - t0
    if not np.array_equal(feats, feats_p1):
        fail("sharded submit(where=P1) differs from the unsharded batch")
    log(f"  sharded pushdown: count_where P1 {got['count_where(P1)']}, P2 "
        f"{got['count_where(P2)']}, filtered_rows(P1) {rows_p1.size} rows, "
        f"groupby_where, agg_where and submit(where=P1) ({t_where:.6f} s) "
        "equal the unsharded executor's bit for bit")
    check_clean("sharded pushdown", svc)
    svc.shutdown()
    # B. _skewed_serve_comparison: Zipf(1.2) block ranks, hot shard 0; the
    #    same mix on a service with hedging off, run in turn with it, shows
    #    what an armed retire (event polls 0.2 ms apart) costs
    blocks = (n_rows - SHARD_RSZ) // 32
    ranks = np.minimum(rng.zipf(1.2, 800), blocks) - 1
    zreqs = [np.arange(s, s + SHARD_RSZ) for s in ranks * 32]
    hot_share = float(np.mean(ranks * 32 < n_rows // N_SHARDS))
    skews = {}
    for hedge in (True, False):
        skew = S.FeatureService(plan_s, sharded=True, hot_factor=2.0,
                                max_replicas=3,
                                fault_policy=S.FaultPolicy(hedge=hedge),
                                **svc_kw)
        per_stream = stream_counter(skew)
        for _ in range(3):              # the monitor converges on the skew
            checked.append(check_sample("skewed warm-up", plan_s,
                                        burst(skew, zreqs, 2)[1]))
            skew.rebalance()
        if skew.replicas[0] < 1:
            fail(f"the monitor did not replicate the hot shard: "
                 f"{skew.replicas}")
        per_stream.clear()
        skew.reset_latency_window()
        skews[hedge] = (skew, per_stream, [], dict(skew.stats))
    for _ in range(3):
        for hedge in (True, False):
            wall, sampled = burst(skews[hedge][0], zreqs, 2)
            skews[hedge][2].append(wall)
            checked.append(check_sample("skewed run", plan_s, sampled))
    for hedge in (True, False):
        skew, per_stream, walls_b, st0 = skews[hedge]
        check_clean("skewed", skew)
        w = statistics.median(walls_b)
        st = skew.stats
        log(f"  skewed{'' if hedge else ', hedge=False control'}: hot "
            f"share {hot_share:.4f}, replicas {skew.replicas}, "
            f"{len(zreqs)} requests a run, median wall {w:.6f} s of "
            f"{[round(x, 6) for x in walls_b]} = "
            f"{len(zreqs) * SHARD_RSZ / w:.1f} rows/s, p99 "
            f"{skew.latency_percentile(99) * 1e3:.4f} ms; hedges "
            f"{st['hedges'] - st0['hedges']}, hedge_wins "
            f"{st['hedge_wins'] - st0['hedge_wins']} in 3 runs; launches by "
            f"(shard, stream) in 3 runs: {per_stream}; shard_launches "
            f"{st['shard_launches']}, replicas_added {st['replicas_added']}")
        skew.shutdown()
    ratio_b = statistics.median(skews[False][2]) / \
        statistics.median(skews[True][2])
    log(f"  skewed hedged / hedge=False rows/s {ratio_b:.4f}")
    # E. one burst over the int32 plan, sharded (host routing, one pump)
    ireqs = [rng.integers(0, n_rows, SHARD_RSZ) for _ in range(512)]
    with S.FeatureService(plan_i, sharded=True, buckets=(SHARD_RSZ,)) as isvc:
        wall, sampled = burst(isvc, ireqs, 2)
        checked.append(check_sample("sharded int32", plan_i, sampled))
        check_clean("sharded int32", isvc)
        log(f"  sharded int32 plan: {len(plan_i.imcu_bounds())} host "
            f"partitions, {isvc.stats['launches']} launches, {wall:.6f} s")
    # C. an append of 2**20 rows, the tail split at the row budget, then
    #    requests across the new seam
    with S.FeatureService(plan_s, sharded=True,
                          row_budget=n_rows // N_SHARDS, **svc_kw) as tsvc:
        tsvc.result(tsvc.submit(np.arange(n_rows - 64, n_rows)),
                    timeout=120)
        add = min(1 << 20, n_rows // 4)
        plan_s.refresh({c: plan_s.table[c].dictionary.add_rows(
            plan_s.table[c].dictionary.values[rng.integers(
                0, plan_s.table[c].dictionary.cardinality, add)])
            for c in plan_s.columns})
        actions = tsvc.rebalance()
        if tsvc.stats["shard_splits"] != 1 or \
                actions["split"] != [(N_SHARDS - 1, N_SHARDS, n_rows)]:
            fail(f"the tail did not split once at {n_rows}: {actions}")
        seam = [np.arange(n_rows - 32 * k, n_rows + 32 * k)
                for k in range(1, 65)]
        seam += [rng.integers(n_rows - add, n_rows + add, 256)
                 for _ in range(64)]
        wall, sampled = burst(tsvc, seam, 1)
        checked.append(check_sample("tail split", plan_s, sampled))
        check_clean("tail split", tsvc)
        log(f"  tail split: refresh appended {add} rows, rebalance split "
            f"the tail at {n_rows} (shards {tsvc.shard_starts}), "
            f"{len(seam)} requests across the seam in {wall:.6f} s, "
            f"split_requests {tsvc.stats['split_requests']}")
    log(f"  {min(checked)}-{max(checked)} sampled rows a run bit-exact")
    path = {k: v - ctl_launched[k]
            for k, v in launch_counts(counters).items()}
    launched = {k: path[k] for k in ("adv_gather_packed_rows",
                                     "gather_fused_parts", "predicate_scan",
                                     "masked_counts")}
    log(f"kernels launched on the sharded path (the control's taken out): "
        f"{path}")
    idle = [k for k, v in launched.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the sharded path: {idle}")
    return launched


# -- phase 3d -----------------------------------------------------------------

HEDGE_STALL_S = 0.6             # tests/test_chaos_serving.py:544's stall
BUSY_CYCLES = 600_000_000       # ~0.3 s at 2 GHz: a primary stream kept busy


def zipf_blocks(rng: np.random.Generator, n: int, lo: int, hi: int):
    """``n`` 64-row blocks at word-aligned starts in [lo, hi), their ranks
    Zipf(1.2) from ``lo`` (bench_featurize.py's skewed mix)."""
    blocks = (hi - lo - SHARD_RSZ) // 32
    ranks = np.minimum(rng.zipf(1.2, n), blocks) - 1
    return [np.arange(s, s + SHARD_RSZ) for s in lo + ranks * 32]


def pcts(ms: list) -> str:
    return (f"p50 {np.percentile(ms, 50):.4f} ms, p99 "
            f"{np.percentile(ms, 99):.4f} ms")


def hedge_part(S, plan, rng) -> int:
    """Part H: shard 0 on two streams of cuda:0, the straggler detector
    warmed up, then one primary launch stalled 0.6 s: the duplicate on the
    other stream must resolve the ticket; the hedge=False control waits
    the stall out. Then one ungated run with the primary's stream truly
    busy, and a sampled Zipf burst. Returns the rows checked."""
    rows = np.arange(0, SHARD_RSZ)
    want = plan.host_features(rows)
    checked = 0
    for hedge in (True, False):
        inj = S.FaultInjector()
        pol = S.FaultPolicy(hedge=hedge, hedge_min_s=0.02, hedge_factor=2.0,
                            straggler_min_s=10.0, breaker_fails=100)
        with S.FeatureService(plan, sharded=True, buckets=(SHARD_RSZ,),
                              coalesce=1, faults=inj,
                              fault_policy=pol) as svc:
            svc.add_replica(0)
            for _ in range(10):         # the EWMA past the warmup
                if not np.array_equal(svc.result(svc.submit(rows),
                                                 timeout=120), want):
                    fail("hedging warm-up: features differ")
            c0 = svc.stats["completed"]
            inj.stall_launches(HEDGE_STALL_S, 1, shard=0)
            t0 = time.perf_counter()
            got = svc.result(svc.submit(rows), timeout=120)
            dt = time.perf_counter() - t0
            st = dict(svc.stats)
            if not np.array_equal(got, want):
                fail(f"hedge={hedge}: the stalled ticket's features differ")
            name = "hedged" if hedge else "hedge=False control"
            log(f"  H {name}: a {HEDGE_STALL_S} s stall on shard 0's next "
                f"launch, the ticket in {dt * 1e3:.3f} ms; hedges "
                f"{st['hedges']}, hedge_wins {st['hedge_wins']}, completed "
                f"+{st['completed'] - c0}")
            if not hedge:
                if dt < HEDGE_STALL_S or st["hedges"]:
                    fail("the hedge=False control did not wait the stall out")
                continue
            if st["hedges"] < 1 or st["hedge_wins"] < 1 or dt >= 0.5 or \
                    st["completed"] != c0 + 1 or st["failed_tickets"]:
                fail(f"the hedged ticket did not beat the stall: {dt:.3f} s, "
                     f"{st}")
            # ungated: the stream the pump picks next kept busy on the card
            streams = svc._sharded_ex.stream_executors(0)
            with svc._lock:
                busy = streams[(svc._stream_rr[0] + 1) % len(streams)]
            torch.cuda.synchronize()
            b0, b1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            with torch.cuda.stream(busy.stream):
                b0.record()
                torch.cuda._sleep(BUSY_CYCLES)
                b1.record()
            t0 = time.perf_counter()
            got = svc.result(svc.submit(rows), timeout=120)
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            if not np.array_equal(got, want):
                fail("the busy-stream ticket's features differ")
            gained = {k: svc.stats[k] - st[k] for k in ("hedges",
                                                        "hedge_wins")}
            log(f"  H busy primary (ungated): the picked stream asleep "
                f"{b0.elapsed_time(b1):.3f} ms on the card, the ticket in "
                f"{dt * 1e3:.3f} ms; gained {gained}")
            wall, sampled = burst(svc, zipf_blocks(rng, 160, 0, plan.n_rows),
                                  1)
            checked = check_sample("hedged burst", plan, sampled)
            if svc.stats["failed_tickets"]:
                fail("the hedged burst failed tickets")
            log(f"  H burst: 160 Zipf blocks in {wall:.6f} s, hedges "
                f"{svc.stats['hedges']}, {checked} rows bit-exact")
    return checked


def device_loss_part(S, plan, rng, dev) -> int:
    """Part L: 512 Zipf blocks, ``kill_device(torch.device("cuda"))`` after
    128 of them (the kill names ``cuda``, the streams ``cuda:0``). With no
    survivor every shard is served from the host; then the device is
    revived in the injector and in DeviceHealth and the pump's rebuild
    arm commits all four shards again. Returns the rows checked."""
    reqs = zipf_blocks(rng, 512, 0, plan.n_rows)
    inj = S.FaultInjector()
    pol = S.FaultPolicy(max_retries=8, backoff_s=0.001, breaker_fails=100)
    checked = 0
    with S.FeatureService(plan, sharded=True, buckets=(SHARD_RSZ,),
                          coalesce=8, linger_us=1000.0, faults=inj,
                          fault_policy=pol) as svc:
        hot_wall, sampled = burst(svc, reqs[:128], 1)
        checked += check_sample("before the loss", plan, sampled, 8192)
        inj.kill_device(torch.device("cuda"))
        host_wall, sampled = burst(svc, reqs[128:], 1)
        checked += check_sample("after the loss", plan, sampled)
        st = svc.throughput_stats(1.0)
        words = svc.device_bytes()
        log(f"  L: hot {128 * SHARD_RSZ / hot_wall:.1f} rows/s "
            f"({hot_wall:.6f} s), served from the host after the loss "
            f"{384 * SHARD_RSZ / host_wall:.1f} rows/s ({host_wall:.6f} s); "
            f"devices_lost {st['devices_lost']}, host_gathers "
            f"{st['host_gathers']}, recoveries {st['recoveries']}, "
            f"availability {st['availability']}, device_bytes {words}")
        if st["availability"] != 1.0 or st["failed_tickets"] or \
                st["devices_lost"] != 1 or not st["host_gathers"] or \
                words or st["recoveries"]:
            fail(f"device loss: {st}, device_bytes {words}")
        inj.revive_device("cuda")
        t0 = time.perf_counter()
        with svc._lock:
            svc._device_health.revive(dev)
            svc._work.notify_all()
        while svc.stats["recoveries"] < N_SHARDS and \
                time.perf_counter() - t0 < 60:
            time.sleep(0.001)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        launches0 = svc.stats["launches"]
        wall, sampled = burst(svc, zipf_blocks(rng, 128, 0, plan.n_rows), 1)
        checked += check_sample("after the rebuild", plan, sampled, 8192)
        st = dict(svc.stats)
        log(f"  L rebuild: recoveries {st['recoveries']} in {rebuild_s:.6f} "
            f"s (four {svc._sharded_ex.executors[0].stream_nbytes()} B puts);"
            f" then 128 blocks in {wall:.6f} s on {st['launches'] - launches0}"
            f" launches; device_bytes {svc.device_bytes()}")
        if st["recoveries"] != N_SHARDS or st["launches"] == launches0 or \
                st["failed_tickets"]:
            fail(f"the rebuild did not bring launches back: {st}")
    return checked


def tier_part(S, plan, want: dict, p1, rng) -> int:
    """Part T: a budget of two shard streams, ``cold_after=2``. Serial hot
    and tier-miss latencies; Zipf traffic at shard 3 with the monitor on
    until a promotion displaces a colder shard (the budget held after
    every tick); P1 pushdown on the tiered service against ``want``;
    quiet ticks that age a warm shard to cold, served from its runs; an
    explicit demote/promote round trip that frees the card's memory.
    Returns the rows checked."""
    q = plan.n_rows // N_SHARDS
    stream_b = (q * sum(plan.device_bits)) // 8
    budget = 2 * stream_b
    checked = 0
    with S.FeatureService(plan, sharded=True, hbm_budget_bytes=budget,
                          cold_after=2, buckets=(SHARD_RSZ,), coalesce=8,
                          linger_us=1000.0, max_replicas=0) as svc:
        sx = svc._sharded_ex
        if svc.tiers != ["hot", "hot", "warm", "warm"] or \
                sx.executors[0].stream_nbytes() != stream_b:
            fail(f"tiers at start {svc.tiers}, not two hot and two warm")
        ticks = []
        monitor = svc._rebalance_locked

        def tick():
            acts = monitor()
            ticks.append(sum(sx.device_bytes().values()))
            return acts
        svc._rebalance_locked = tick
        # T1: serial requests, a hot shard's and a warm one's in turns (no
        # monitor yet: equal zero heat displaces nothing, shard 2 stays
        # warm); a lone hot request waits out the 1 ms linger of its group
        t0 = time.perf_counter()
        lat = {"hot": [], "miss": []}
        for h, m in zip(zipf_blocks(rng, 200, q, 2 * q),
                        zipf_blocks(rng, 200, 2 * q, 3 * q)):
            for key, r in (("hot", h), ("miss", m)):
                t1 = time.perf_counter()
                got = svc.result(svc.submit(r), timeout=120)
                lat[key].append((time.perf_counter() - t1) * 1e3)
                checked += check_sample("tier latency", plan, [(r, got)], 0)
        log(f"  T serial ({time.perf_counter() - t0:.3f} s): hot "
            f"{pcts(lat['hot'])}; tier miss {pcts(lat['miss'])}; tiers "
            f"{svc.tiers}, tier_misses {svc.stats['tier_misses']}")
        if svc.tiers[2] != "warm" or svc.stats["tier_misses"] < 200:
            fail(f"the misses did not stay warm: {svc.tiers}")
        # T2: the monitor on, Zipf traffic at shard 3
        t0 = time.perf_counter()
        svc.rebalance_every = 8
        for _ in range(8):
            wall, sampled = burst(svc, zipf_blocks(rng, 128, 3 * q,
                                                   plan.n_rows), 4)
            checked += check_sample("tier traffic", plan, sampled, 0)
            if svc.tiers[3] == "hot":
                break
        st = dict(svc.stats)
        log(f"  T promotion ({time.perf_counter() - t0:.3f} s): tiers "
            f"{svc.tiers}, promotions {st['promotions']}, demotions "
            f"{st['demotions']}, tier_misses {st['tier_misses']}, "
            f"host_gathers {st['host_gathers']}; {len(ticks)} monitor "
            f"ticks, the most resident {max(ticks)} B against a {budget} B "
            "budget")
        if svc.tiers[3] != "hot" or st["promotions"] < 1 or \
                st["demotions"] < 1 or max(ticks) > budget:
            fail(f"no promotion displaced a colder shard within the budget: "
                 f"{svc.tiers}, {st}")
        # T3: P1 pushdown on the tiered service
        t0 = time.perf_counter()
        tiers, before = svc.tiers, sum(svc.device_bytes().values())
        got = {"count_where(P1)": svc.count_where(p1),
               "filtered_rows(P1)": svc.filtered_rows(p1),
               "groupby_where(device, P1)":
               svc.groupby_where("device", p1)[1],
               "agg_where(P1, income, mean)": svc.agg_where(p1, "income",
                                                            "mean")}
        after = sum(svc.device_bytes().values())
        for k in want:
            if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
                fail(f"tiered {k} differs from the unsharded executor's")
        rows_p1 = want["filtered_rows(P1)"]
        feats = svc.result(svc.submit(where=p1), timeout=120)
        checked += check_sample("tiered submit(where=P1)", plan,
                                [(rows_p1, feats)], 0)
        svc.rebalance()
        log(f"  T pushdown ({time.perf_counter() - t0:.3f} s): P1 over tiers "
            f"{tiers} equals the unsharded executor's; resident {before} B "
            f"before the scans, {after} B after them (the off-device "
            f"shards' words put again), {sum(svc.device_bytes().values())} "
            f"B after submit(where=P1) and the next tick; tiers "
            f"{svc.tiers}")
        if sum(svc.device_bytes().values()) > budget:
            fail("the tick after pushdown did not settle the budget")
        # T4: quiet ticks age a warm shard to cold; serve from its runs
        t0 = time.perf_counter()
        for _ in range(3):
            svc.rebalance()
        cold = [s for s, tier in enumerate(svc.tiers) if tier == "cold"]
        if not cold or max(ticks) > budget:
            fail(f"no quiet warm shard aged to cold: {svc.tiers}")
        c = cold[0]
        rle = sx.shards[c].rle_bytes()
        packed_b = sx.executors[c].stream_nbytes()
        r0 = svc.stats["rehydrations"]
        wall, sampled = burst(svc, zipf_blocks(rng, 160, c * q, (c + 1) * q),
                              1)
        checked += check_sample("cold shard", plan, sampled, 0)
        log(f"  T cold ({time.perf_counter() - t0:.3f} s): shard {c} held as "
            f"{rle} B of RLE runs against {packed_b} B packed "
            f"({rle / packed_b:.3f}x: random codes barely run); 160 blocks "
            f"from it in {wall:.6f} s, rehydrations "
            f"+{svc.stats['rehydrations'] - r0}, tiers {svc.tiers}")
        if svc.stats["rehydrations"] == r0:
            fail("the cold shard was not served from its runs")
        # T5: an explicit demote/promote round trip
        t0 = time.perf_counter()
        s = svc.tiers.index("hot")
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        freed = svc.demote(s, "warm")
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated()
        ok = svc.promote(s)
        wall, sampled = burst(svc, zipf_blocks(rng, 160, s * q, (s + 1) * q),
                              1)
        checked += check_sample("round trip", plan, sampled, 0)
        st = svc.stats
        tier_st = {k: st[k] for k in ("promotions", "demotions",
                                      "rehydrations", "tier_misses",
                                      "tier_hot", "tier_warm", "tier_cold")}
        log(f"  T round trip ({time.perf_counter() - t0:.3f} s): demote({s}) "
            f"freed {freed} B, memory_allocated {m0} -> {m1} B; promote({s})"
            f" {ok}, tiers {svc.tiers}; stats {tier_st}")
        if freed != stream_b or m0 - m1 < stream_b or not ok or \
                svc.tiers[s] != "hot" or st["failed_tickets"]:
            fail("the demote/promote round trip did not free and restore "
                 "the shard's words")
    if checked < 10_000:
        fail(f"tiers: only {checked} rows checked")
    return checked


def fault_tier_path(S, plan, ex_p, p1, rng, counters, dev) -> dict:
    """Phase 3d: hedging, device loss and tiered residency on the 4-IMCU
    table of phase 3c. Returns the launches."""
    # the unsharded executor's answers, which part T holds the tiered
    # service's against (taken before the counts are set to 0)
    want = {"count_where(P1)": ex_p.count_where(p1),
            "filtered_rows(P1)": ex_p.filtered_rows(p1),
            "groupby_where(device, P1)": ex_p.groupby_where("device", p1)[1],
            "agg_where(P1, income, mean)": ex_p.agg_where(p1, "income",
                                                          "mean")}
    for counter in counters:
        counter.reset_launches()
    parts = {}
    for name, part in (("H", lambda: hedge_part(S, plan, rng)),
                       ("L", lambda: device_loss_part(S, plan, rng, dev)),
                       ("T", lambda: tier_part(S, plan, want, p1, rng))):
        t0 = time.perf_counter()
        checked = part()
        parts[name] = (time.perf_counter() - t0, checked)
    path = launch_counts(counters)
    launched = {k: path[k] for k in ("adv_gather_packed_rows",
                                     "predicate_scan", "masked_counts")}
    log(f"  parts' walls and rows checked: "
        f"{ {k: (round(w, 3), c) for k, (w, c) in parts.items()} }")
    log(f"kernels launched on the fault-tolerance and tier path: {path}")
    idle = [k for k, v in launched.items() if v <= 0]
    if idle:
        fail(f"kernels never launched on the fault-tolerance and tier "
             f"path: {idle}")
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


# -- phase 8 ------------------------------------------------------------------
LM_ARCHS = ("glm4-9b", "qwen2-7b", "minicpm-2b", "starcoder2-15b",
            "llava-next-mistral-7b")
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 dense, tensor cores
# Largest |logit| difference allowed between glm4-9b's bf16 serve path and
# its bf16 forward over the same tokens: logits have std ~1, bf16 rounds
# them to 2**-5 near |4|, and 40 residual layers in bf16 add their own
# rounding (PERF.md §6, PR 23, written before the first run).
LM_LOGIT_TOL = 0.25


def lm_bytes(tree) -> int:
    from torch.utils import _pytree as pytree
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def lm_matmul_params(cfg) -> int:
    """Weights a token multiplies: every block matrix and the head (the
    embedding is gathered); of a MoE layer the router, its top_k routed
    experts and the shared expert."""
    hd, d = cfg.head_dim, cfg.d_model
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv * hd * 2
    mlp = (3 if cfg.mlp_style == "swiglu" else 2) * d * cfg.d_ff
    moe = cfg.top_k * 3 * d * cfg.d_ff + d * cfg.n_experts + \
        (mlp if cfg.shared_expert else 0)
    return sum(attn + (moe if cfg.is_moe_layer(i) else mlp)
               for i in range(cfg.n_layers)) + d * cfg.padded_vocab


def lm_prefill_flops(cfg, b: int, plen: int) -> int:
    """A prefill's operations: 2 per weight per token, and QK^T and PV over
    the causal pairs (query i sees i + 1 keys)."""
    pairs = b * plen * (plen + 1) // 2
    return 2 * lm_matmul_params(cfg) * b * plen + \
        cfg.n_layers * 4 * cfg.n_heads * cfg.head_dim * pairs


def count_launches(fn, top: int = 0) -> str:
    """Launch calls, device activities (kernels, copies, fills) and their
    summed device time in one call of ``fn``, from torch.profiler's trace
    (the call's wall is the profiled one, so only the counts and device
    time are read), and with ``top`` the ``top`` activities by summed
    device time; "not measured" when the trace shows no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
    except RuntimeError as e:
        return f"not measured ({e})"
    on_card = [e for e in events
               if getattr(e, "device_type", None) is not None and
               e.device_type.name == "CUDA"]
    calls = sum(1 for e in events if "LaunchKernel" in e.name)
    if not on_card:
        return "not measured (the trace shows no device activity)"
    busy = sum(e.time_range.elapsed_us() for e in on_card)
    by_name: dict = {}
    for e in on_card:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    tops = "".join(f"; {us / busy:.3f} in {n} x {name[:60]}"
                   for name, (n, us) in heavy)
    return (f"{calls} launch calls, {len(on_card)} device activities, "
            f"{busy:.1f} us of device time{tops}")


def lm_full_width(lm, get_config, Request, ServeEngine, dev, seed: int,
                  smi: str) -> None:
    """glm4-9b at full width and depth in bf16, weights drawn on the card
    from ``seed``: two served batches, each held by teacher forcing against
    ``lm.forward`` over the same tokens."""
    from repro_torch.serve import lm_parity
    cfg = get_config("glm4-9b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    weights = lm_bytes(params)
    log(f"glm4-9b: {lm.param_count(params)} parameters, {weights} B of "
        f"bf16 weights drawn on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(seed + 1)
    # warm-up at each run's shapes (cuBLAS picks and loads its bf16
    # kernels at first use): two tokens, not timed
    runs = ((8, 128, 32, 160), (4, 1024, 16, 2048))
    for b, plen, _, max_len in runs:
        ServeEngine(cfg, params, batch_size=b, max_len=max_len).run_batch(
            [Request(prompt=np.zeros(plen, np.int32), max_new_tokens=2)
             for _ in range(b)])
    for b, plen, new, max_len in runs:
        prompts = rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)
        eng = ServeEngine(cfg, params, batch_size=b, max_len=max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_batch([Request(prompt=q, max_new_tokens=new)
                              for q in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.throughput_stats(done, wall)
        outs = np.asarray([r.out_tokens for r in done], np.int32)
        if outs.shape != (b, new) or outs.min() < 0 or \
                outs.max() >= cfg.vocab:
            fail(f"glm4-9b served {outs.shape} tokens, not ({b}, {new}) "
                 f"ids in [0, {cfg.vocab})")
        seq = np.concatenate([prompts, outs], axis=1)
        serve, state, prefill_s, steps = lm_parity.replay(
            cfg, params, seq, plen, max_len, dev, timed=True)
        launches = count_launches(lambda: lm.decode_step(
            cfg, params, state, torch.from_numpy(seq[:, -1:]).to(dev)))
        # the forward over the same tokens, padded past 1,024 to a
        # multiple of the flash chunk (causal: the pad changes nothing
        # before it)
        s = seq.shape[1] - 1
        pad = s if s <= 1024 else -(-s // 1024) * 1024
        fwd_tokens = np.zeros((b, pad), np.int32)
        fwd_tokens[:, :s] = seq[:, :s]
        fwd, _, _ = lm.forward(cfg, params,
                               {"tokens": torch.from_numpy(fwd_tokens)
                                .to(dev)})
        fwd = fwd[:, :s, :cfg.vocab]
        if not (torch.isfinite(serve).all() and torch.isfinite(fwd).all()):
            fail(f"glm4-9b ({b} x {plen}): non-finite logits")
        diff = (serve - fwd).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        del diff
        top2 = fwd[:, plen - 1:].topk(2, dim=-1)
        margin = top2.values[..., 0] - top2.values[..., 1]
        clear = margin > LM_LOGIT_TOL
        served = torch.from_numpy(outs).to(dev)
        agree = int((top2.indices[..., 0] == served)[clear].sum())
        n_clear = int(clear.sum())
        del serve, fwd, top2
        step_s = float(np.median(steps))
        kv_bytes = lm_bytes(state["blocks"]) * plen // max_len
        decode_bound = (weights + kv_bytes) / HBM_BYTES_PER_S
        flops = lm_prefill_flops(cfg, b, plen)
        prefill_bound = max(weights / HBM_BYTES_PER_S,
                            flops / BF16_OPS_PER_S)
        log(f"glm4-9b, {b} requests x {plen}-token prompts, {new} new tokens,"
            f" max_len {max_len} ({'flash' if max_len > 1024 else 'direct'}"
            f" prefill):")
        log(f"  engine: {st['new_tokens']} new tokens in {wall:.6f} s = "
            f"{st['tok_per_s']:.3f} tok/s end to end")
        log(f"  prefill: {b * plen} tokens in {prefill_s * 1e3:.6f} ms = "
            f"{b * plen / prefill_s:.1f} tok/s; bound "
            f"{prefill_bound * 1e3:.6f} ms ({flops} bf16 ops at 989 TFLOP/s)"
            f", {prefill_bound / prefill_s:.4f} of it")
        log(f"  decode: median {step_s * 1e3:.6f} ms/step (min "
            f"{min(steps) * 1e3:.6f}, max {max(steps) * 1e3:.6f}, "
            f"{len(steps)} steps) = {b / step_s:.1f} tok/s; bound "
            f"{decode_bound * 1e3:.6f} ms ({weights} B of weights + "
            f"{kv_bytes} B of cache at 3.35 TB/s), "
            f"{decode_bound / step_s:.4f} of it; one step: {launches}")
        log(f"  teacher forcing: serve vs forward logits max |d| {err:.6f} "
            f"(tolerance {LM_LOGIT_TOL}), mean |d| {mean_err:.3e}; greedy "
            f"tokens equal the forward's argmax at {agree} of {n_clear} "
            f"positions whose top-2 margin exceeds {LM_LOGIT_TOL} "
            f"({b * new} served)")
        log(f"  card: {smi}")
        if err > LM_LOGIT_TOL:
            fail(f"glm4-9b ({b} x {plen}): serve logits differ from the "
                 f"forward's by {err} > {LM_LOGIT_TOL}")
        if agree != n_clear:
            fail(f"glm4-9b ({b} x {plen}): {n_clear - agree} greedy tokens "
                 "differ from the forward's argmax past the tolerance")
        del state
    peak = torch.cuda.max_memory_allocated()
    log(f"max_memory_allocated: {peak} B ({weights} B of weights)")
    if peak < weights or weights < 18_799_534_080:
        fail(f"glm4-9b: {peak} B allocated at peak, {weights} B of weights; "
             "the full-width model was not resident")
    del params
    torch.cuda.empty_cache()


# MoE at full width in bf16: (arch, layers kept or None for the config's,
# the least bytes of weights that must be resident, M1's run, M2's run),
# each run (requests, prompt tokens, new tokens, max_len). llama4-maverick
# keeps 2 of its 48 layers (one dense, one MoE): 48 do not fit one card
MOE_MODELS = (("moonshot-v1-16b-a3b", None, 56_959_045_632,
               (8, 128, 32, 160), (4, 1024, 16, 2048)),
              ("llama4-maverick-400b-a17b", 2, 37_111_777_280,
               (8, 128, 32, 160), (8, 128, 32, 160)))


def moe_no_drop(cfg):
    """``cfg`` with a capacity factor at which a call of S tokens has a
    capacity of at least S (S * k / E * (E / k + 1) >= S): no pair drops,
    so the serve path's calls route as the forward's."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts /
                               cfg.top_k + 1)


class MoERun:
    """One full-width MoE model's runs (``lm_moe_full_width``): its
    modules, parameters and byte counts."""

    def __init__(self, mods, cfg, params, dev, smi: str):
        self.lm, self.moe, self.lm_parity = mods
        self.cfg, self.params, self.dev, self.smi = cfg, params, dev, smi
        self.n_moe = cfg.n_moe_layers
        self.weights = lm_bytes(params)
        # one expert's three matrices in one layer, and what a decode
        # step reads besides the routed experts (every other weight; of
        # the embedding only its B rows, left out)
        d, f = cfg.d_model, cfg.d_ff
        elem = params["embed"].element_size()
        self.expert_bytes = 3 * d * f * elem
        all_experts = self.n_moe * cfg.n_experts * self.expert_bytes
        self.rest_bytes = self.weights - all_experts - \
            lm_bytes(params["embed"])
        self.all_expert_bytes = all_experts

    def serve(self, cfg, prompts, new: int, max_len: int):
        """The engine's greedy tokens (B, new) and its wall."""
        from repro_torch.serve import Request, ServeEngine
        eng = ServeEngine(cfg, self.params, batch_size=prompts.shape[0],
                          max_len=max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_batch([Request(prompt=q, max_new_tokens=new)
                              for q in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = np.asarray([r.out_tokens for r in done], np.int32)
        if outs.shape != (prompts.shape[0], new) or outs.min() < 0 or \
                outs.max() >= cfg.vocab:
            fail(f"{cfg.name} served {outs.shape} tokens, not "
                 f"({prompts.shape[0]}, {new}) ids in [0, {cfg.vocab})")
        return outs, wall

    def forward(self, cfg, tokens: np.ndarray):
        """``lm.forward`` over ``tokens`` (B, S) under a routing trace,
        padded past 1,024 to a multiple of the flash chunk (causal: the
        pad changes nothing before it). -> (logits (B, S, vocab), the
        routing table over the S positions)."""
        b, s = tokens.shape
        pad = s if s <= 1024 else -(-s // 1024) * 1024
        padded = np.zeros((b, pad), np.int32)
        padded[:, :s] = tokens
        with self.moe.routing_trace() as tr:
            out, _, _ = self.lm.forward(
                cfg, self.params, {"tokens": torch.from_numpy(padded)
                                   .to(self.dev)})
        fwd = out[:, :s, :cfg.vocab].contiguous()
        del out
        table = self.lm_parity.routing_table(tr.calls, self.n_moe)
        for t in table:
            t["idx"], t["margin"] = t["idx"][:, :s], t["margin"][:, :s]
            t["dropped"] = t["dropped"][:, :s]
        return fwd, table

    def timed_replay(self, cfg, seq, plen: int, max_len: int):
        """The serve path over ``seq`` (teacher forcing, timed) under a
        routing trace: (logits, state, prefill s, step s, routing table).
        Recording keeps views of tensors the layer makes anyway: it adds
        no launch."""
        with self.moe.routing_trace() as tr:
            out = self.lm_parity.replay(cfg, self.params, seq, plen, max_len,
                                        self.dev, timed=True)
        return (*out, tr.calls)

    def bounds(self, cfg, state, calls, b: int, plen: int, max_len: int):
        """The prefill bound (weights at 3.35 TB/s, or the active
        parameters' and attention's bf16 ops at 989 TFLOP/s) and, per
        decode step of ``calls``, the bytes it must read: every weight but
        the embedding's table and the routed experts, the distinct experts
        its B tokens chose in each MoE layer, and the cache filled to the
        prompt. -> (prefill s, ops, median step bound s, median distinct
        experts a layer, all-expert step bound s)."""
        ops = lm_prefill_flops(cfg, b, plen)
        prefill = max(self.weights / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
        kv = lm_bytes(state["blocks"]) * plen // max_len
        steps = [calls[i:i + self.n_moe]
                 for i in range(self.n_moe, len(calls), self.n_moe)]
        distinct = [sum(int(c.idx.unique().numel()) for c in step)
                    for step in steps]
        median = statistics.median(distinct)
        step = (self.rest_bytes + median * self.expert_bytes + kv) / \
            HBM_BYTES_PER_S
        every = (self.rest_bytes + self.all_expert_bytes + kv) / \
            HBM_BYTES_PER_S
        return prefill, ops, step, median / self.n_moe, every

    def log_times(self, cfg, b, plen, new, wall, prefill_s, steps, launches,
                  bounds):
        prefill_b, ops, step_b, per_layer, every = bounds
        step_s = float(np.median(steps))
        log(f"  engine: {b * new} new tokens in {wall:.6f} s = "
            f"{b * new / wall:.3f} tok/s end to end")
        log(f"  prefill: {b * plen} tokens in {prefill_s * 1e3:.6f} ms = "
            f"{b * plen / prefill_s:.1f} tok/s; bound "
            f"{prefill_b * 1e3:.6f} ms (max of {self.weights} B at 3.35 "
            f"TB/s and {ops} bf16 ops at 989 TFLOP/s), "
            f"{prefill_b / prefill_s:.4f} of it")
        log(f"  decode: median {step_s * 1e3:.6f} ms/step (min "
            f"{min(steps) * 1e3:.6f}, max {max(steps) * 1e3:.6f}, "
            f"{len(steps)} steps) = {b / step_s:.1f} tok/s; bound "
            f"{step_b * 1e3:.6f} ms (the distinct experts a step's {b} "
            f"tokens chose, median {per_layer:.2f} of {cfg.n_experts} a "
            f"layer, {self.expert_bytes} B each, plus {self.rest_bytes} B "
            f"of other weights and the cache at 3.35 TB/s), "
            f"{step_b / step_s:.4f} of it; reading every expert, as "
            f"products over all of them do: {every * 1e3:.6f} ms, "
            f"{every / step_s:.4f} of it; one step: {launches}")

    def m1(self, rng, run) -> None:
        """As configured: the engine, the replay (timed), the dropped
        pairs per layer, and the prefill's logits held against the
        forward over exactly the prompts (padding would change the
        capacity)."""
        cfg, dev = self.cfg, self.dev
        b, plen, new, max_len = run
        name = f"{cfg.name} M1 ({b} x {plen}, capacity factor " \
            f"{cfg.capacity_factor})"
        prompts = rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)
        outs, wall = self.serve(cfg, prompts, new, max_len)
        seq = np.concatenate([prompts, outs], axis=1)
        serve, state, prefill_s, steps, calls = self.timed_replay(
            cfg, seq, plen, max_len)
        launches = count_launches(lambda: self.lm.decode_step(
            cfg, self.params, state, torch.from_numpy(seq[:, -1:]).to(dev)))
        bounds = self.bounds(cfg, state, calls, b, plen, max_len)
        k = cfg.top_k
        dropped = [float((~c.keep).sum()) / (b * plen * k)
                   for c in calls[:self.n_moe]]
        later = sum(int((~c.keep).sum()) for c in calls[self.n_moe:])
        fwd, _ = self.forward(cfg, prompts)
        pre = serve[:, :plen]
        finite = bool(torch.isfinite(pre).all() and
                      torch.isfinite(fwd).all())
        err = float((pre - fwd).abs().max())
        mean_err = float((pre - fwd).abs().mean())
        del serve, fwd, pre, state
        log(f"{name}, {new} new tokens, max_len {max_len}:")
        self.log_times(cfg, b, plen, new, wall, prefill_s, steps, launches,
                       bounds)
        log(f"  dropped pairs a MoE layer in the prefill (of {b * plen * k}"
            f"): min {min(dropped):.4f}, median "
            f"{statistics.median(dropped):.4f}, max {max(dropped):.4f}; "
            f"by layer {[round(x, 4) for x in dropped]}; in decode steps "
            f"{later}")
        log(f"  prefill vs forward over the prompts: max |d| {err:.6f} "
            f"(tolerance {LM_LOGIT_TOL}), mean |d| {mean_err:.3e}")
        log(f"  card: {self.smi}")
        if not finite:
            fail(f"{name}: non-finite logits")
        if err > LM_LOGIT_TOL:
            fail(f"{name}: prefill logits differ from the forward's by "
                 f"{err} > {LM_LOGIT_TOL}")

    def m2(self, rng, run) -> None:
        """At a capacity where nothing drops: the engine, then teacher
        forcing over the served tokens with the forward's expert ids
        forced (each position's ids to the call that reads it), held at
        every position; the unforced replay (timed) logged against the
        forward."""
        lm_parity = self.lm_parity
        cfg, dev = moe_no_drop(self.cfg), self.dev
        b, plen, new, max_len = run
        name = f"{cfg.name} M2 ({b} x {plen}, capacity factor " \
            f"{cfg.capacity_factor:.4f})"
        prompts = rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)
        outs, wall = self.serve(cfg, prompts, new, max_len)
        seq = np.concatenate([prompts, outs], axis=1)
        s = seq.shape[1] - 1
        spans = lm_parity.replay_spans(plen, s)
        fwd, ftab = self.forward(cfg, seq[:, :s])
        with self.moe.routing_trace(
                forced=lm_parity.forced_routes(ftab, spans)) as tr:
            forced, _, _, _ = lm_parity.replay(cfg, self.params, seq, plen,
                                               max_len, dev)
        drops = sum(int(t["dropped"].sum()) for t in ftab) + \
            sum(int((~c.keep).sum()) for c in tr.calls)
        finite = bool(torch.isfinite(forced).all() and
                      torch.isfinite(fwd).all())
        err = float((forced - fwd).abs().max())
        mean_err = float((forced - fwd).abs().mean())
        top2 = fwd.topk(2, dim=-1)
        clear = top2.values[..., 0] - top2.values[..., 1] > LM_LOGIT_TOL
        same = forced.argmax(dim=-1) == top2.indices[..., 0]
        n_clear, agree = int(clear.sum()), int((same & clear).sum())
        # the served greedy tokens against the forward's argmax
        gclear = clear[:, plen - 1:]
        served = torch.from_numpy(outs[:, :s - plen + 1]).to(dev)
        gagree = int(((top2.indices[:, plen - 1:, 0] == served) &
                      gclear).sum())
        del forced, top2, same
        serve, state, prefill_s, steps, calls = self.timed_replay(
            cfg, seq, plen, max_len)
        launches = count_launches(lambda: self.lm.decode_step(
            cfg, self.params, state, torch.from_numpy(seq[:, -1:]).to(dev)))
        bounds = self.bounds(cfg, state, calls, b, plen, max_len)
        rtab = lm_parity.routing_table(calls, self.n_moe)
        differ = torch.stack([(r["idx"] != f["idx"]).any(dim=-1)
                              for r, f in zip(rtab, ftab)])      # (L,B,S)
        hit = differ.any(dim=0)                                   # (B,S)
        first = torch.where(hit, torch.arange(s), s).amin(dim=1)
        margins = [float(ftab[int(differ[:, q, int(first[q])].nonzero()[0])]
                         ["margin"][q, int(first[q])])
                   for q in range(b) if int(first[q]) < s]
        held = torch.arange(s)[None, :] < first[:, None]
        d = (serve - fwd).abs().amax(dim=-1).cpu()
        free_err = float(d[held].max()) if held.any() else 0.0
        del serve, fwd, state, d
        log(f"{name}, {new} new tokens, max_len {max_len}:")
        self.log_times(cfg, b, plen, new, wall, prefill_s, steps, launches,
                       bounds)
        log(f"  teacher forcing with the forward's experts forced: max |d| "
            f"{err:.6f} over all {b * s} positions (tolerance "
            f"{LM_LOGIT_TOL}), mean |d| {mean_err:.3e}; argmax equal to the "
            f"forward's at {agree} of {n_clear} positions whose top-2 "
            f"margin exceeds {LM_LOGIT_TOL}; {drops} pairs dropped")
        log(f"  unforced (not gated): {int(differ.sum())} of "
            f"{self.n_moe * b * s} routing decisions differ from the "
            f"forward's, first flips at positions "
            f"{[p if p < s else None for p in first.tolist()]} (forward "
            f"top-k margins there {[f'{m:.3e}' for m in margins]}); max |d| "
            f"{free_err:.6f} before them; served greedy tokens equal the "
            f"forward's argmax at {gagree} of {int(gclear.sum())} positions "
            f"whose top-2 margin exceeds {LM_LOGIT_TOL}")
        log(f"  card: {self.smi}")
        if not finite:
            fail(f"{name}: non-finite logits")
        if drops:
            fail(f"{name}: {drops} pairs dropped at a capacity past S")
        if err > LM_LOGIT_TOL:
            fail(f"{name}: with the forward's experts forced, serve logits "
                 f"differ from the forward's by {err} > {LM_LOGIT_TOL}")
        if agree != n_clear:
            fail(f"{name}: {n_clear - agree} argmaxes differ from the "
                 "forward's past the tolerance")


def lm_moe_full_width(lm, get_config, dev, seed: int, smi: str) -> None:
    """moonshot-v1-16b-a3b at full width and depth and llama4-maverick at
    full width over two layers, in bf16, weights drawn on the card from
    ``seed``, each freed before the next: M1 as configured, M2 at a
    capacity where nothing drops."""
    from repro_torch.models import moe
    from repro_torch.serve import lm_parity, Request, ServeEngine
    for arch, layers, least, run1, run2 in MOE_MODELS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed, device=dev)
        torch.cuda.synchronize()
        r = MoERun((lm, moe, lm_parity), cfg, params, dev, smi)
        cut = "" if layers is None else \
            f", n_layers reduced 48 -> {layers} (one dense, one MoE layer)"
        log(f"{arch}: {lm.param_count(params)} parameters, {r.weights} B "
            f"of bf16 weights (router float32) drawn on the card in "
            f"{time.perf_counter() - t0:.3f} s{cut}; "
            f"{lm_matmul_params(cfg)} weights multiplied a token")
        # warm-up at each run's shapes and capacity, two tokens, not timed
        for c, (b, plen, _, max_len) in ((cfg, run1),
                                         (moe_no_drop(cfg), run2)):
            ServeEngine(c, params, batch_size=b, max_len=max_len).run_batch(
                [Request(prompt=np.zeros(plen, np.int32), max_new_tokens=2)
                 for _ in range(b)])
        rng = np.random.default_rng(seed + 2)
        r.m1(rng, run1)
        r.m2(rng, run2)
        peak = torch.cuda.max_memory_allocated()
        log(f"max_memory_allocated: {peak} B ({r.weights} B of weights)")
        if peak < r.weights or r.weights < least:
            fail(f"{arch}: {peak} B allocated at peak, {r.weights} B of "
                 f"weights (at least {least}); the model was not resident")
        del params, r
        torch.cuda.empty_cache()


# seamless-m4t-large-v2 at full width and depth in bf16: its weights' bytes
# (the reference's param_specs), the token store's corpus, and the runs B1
# and B2, each (requests, loader sequence = frames, prompt tokens, new)
AUDIO_ARCH = "seamless-m4t-large-v2"
AUDIO_BYTES = 4_070_100_992
AUDIO_CORPUS = 1_000_000
AUDIO_RUNS = (("B1", 8, 128, 128, 32), ("B2", 4, 2048, 128, 16))


def audio_prefill_flops(cfg, b: int, plen: int, frames: int) -> int:
    """An audio prefill's operations, 2 per weight per row: the frames'
    projection and the encoder's blocks over ``frames``, its bidirectional
    QK^T and PV over frames x frames; the decoder's blocks over the prompt
    (self-attention, cross-attention's Q and O, the MLP), cross K and V over
    the frames in every layer, causal self-attention pairs, cross-attention
    over prompt x frames, and the head."""
    d, hd = cfg.d_model, cfg.head_dim
    q_o = 2 * d * cfg.n_heads * hd
    k_v = 2 * d * cfg.n_kv * hd
    mlp = (3 if cfg.mlp_style == "swiglu" else 2) * d * cfg.d_ff
    score = 4 * cfg.n_heads * hd           # QK^T and PV, per query-key pair
    enc = 2 * cfg.frontend_dim * d * b * frames + cfg.enc_layers * (
        2 * (q_o + k_v + mlp) * b * frames + score * b * frames * frames)
    pairs = b * plen * (plen + 1) // 2
    dec = cfg.n_layers * (2 * (2 * q_o + k_v + mlp) * b * plen +
                          2 * k_v * b * frames + score * pairs +
                          score * b * plen * frames)
    return enc + dec + 2 * d * cfg.padded_vocab * b * plen


def audio_full_width(lm, get_config, dev, seed: int, smi: str) -> None:
    """seamless-m4t-large-v2 at full width and depth in bf16, weights drawn
    on the card from ``seed``, fed by the columnar token store: a
    ``TokenStore`` over ``synthetic_corpus`` and ``token_batches``' tokens
    and frames on the card. B1: 8 x 128 tokens over 128 frames; B2: 4 x
    128 tokens over 2,048 frames (the flash route for the encoder and for
    cross-attention). Each: greedy tokens through ``lm_parity.greedy``
    (prefill with the frames, decode on the memory), the prefill held
    against ``lm.forward`` over exactly the prompts, teacher forcing
    against the forward at every position."""
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.serve import lm_parity
    cfg = get_config(AUDIO_ARCH)
    t0 = time.perf_counter()
    store = TokenStore(synthetic_corpus(AUDIO_CORPUS, cfg.vocab, seed),
                       cfg.vocab, device_unpack=True)
    log(f"{AUDIO_ARCH}'s token store: {store.n} tokens of "
        f"synthetic_corpus, vocab {cfg.vocab}, {store.bits} bits, device "
        f"words of {store.device_bits} bits: {store.packed_nbytes} B packed,"
        f" {store.raw_nbytes} B as int32 ids, unigram entropy "
        f"{store.entropy_bits():.6f} bits; built in "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    weights = lm_bytes(params)
    read = lm_bytes(params["blocks"]) + lm_bytes(params["head"]) + \
        lm_bytes(params["final_norm"])
    log(f"{AUDIO_ARCH}: {lm.param_count(params)} parameters, {weights} B "
        f"of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s ({cfg.enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model})")
    if weights != AUDIO_BYTES:
        fail(f"{AUDIO_ARCH}: {weights} B of weights, not {AUDIO_BYTES}")
    for k, (name, b, frames, plen, new) in enumerate(AUDIO_RUNS):
        batch = next(token_batches(store, cfg, batch=b, seq=frames,
                                   seed=seed + k, device=dev))
        prompts = batch["tokens"][:, :plen].cpu().numpy()
        fr = batch["frames"]
        max_len = plen + new
        what = f"{AUDIO_ARCH} {name} ({b} x {plen} tokens over {frames} " \
            f"frames)"
        if fr.shape != (b, frames, cfg.frontend_dim) or not fr.is_cuda:
            fail(f"{what}: the loader's frames are {tuple(fr.shape)} on "
                 f"{fr.device}")
        # warm-up at the run's shapes, two tokens, not timed
        lm_parity.greedy(cfg, params, prompts, 2, max_len, dev, fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = lm_parity.greedy(cfg, params, prompts, new, max_len, dev, fr)
        wall = time.perf_counter() - t0
        if outs.shape != (b, new) or outs.min() < 0 or \
                outs.max() >= cfg.vocab:
            fail(f"{what}: served {outs.shape} tokens, not ({b}, {new}) ids "
                 f"in [0, {cfg.vocab})")
        seq = np.concatenate([prompts, outs], axis=1)
        s = seq.shape[1] - 1
        serve, state, prefill_s, steps = lm_parity.replay(
            cfg, params, seq, plen, max_len, dev, timed=True, frames=fr)
        launches = count_launches(lambda: lm.decode_step(
            cfg, params, state, torch.from_numpy(seq[:, -1:]).to(dev)))
        del state
        pre_fwd, _, _ = lm.forward(cfg, params, {
            "tokens": torch.from_numpy(prompts).to(dev), "frames": fr})
        pre_fwd = pre_fwd[..., :cfg.vocab]
        pre_err = float((serve[:, :plen] - pre_fwd).abs().max())
        finite = bool(torch.isfinite(pre_fwd).all())
        del pre_fwd
        fwd, _, _ = lm.forward(cfg, params, {
            "tokens": torch.from_numpy(seq[:, :s]).to(dev), "frames": fr})
        fwd = fwd[..., :cfg.vocab]
        finite &= bool(torch.isfinite(serve).all() and
                       torch.isfinite(fwd).all())
        diff = (serve - fwd).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        del diff
        top2 = fwd.topk(2, dim=-1)
        clear = top2.values[..., 0] - top2.values[..., 1] > LM_LOGIT_TOL
        same = serve.argmax(dim=-1) == top2.indices[..., 0]
        n_clear, agree = int(clear.sum()), int((same & clear).sum())
        del serve, fwd, top2, same
        ops = audio_prefill_flops(cfg, b, plen, frames)
        prefill_b = max(weights / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
        recompute = cfg.n_layers * 2 * 2 * b * frames * cfg.d_model * \
            cfg.n_kv * cfg.head_dim
        step_b = max(read / HBM_BYTES_PER_S, recompute / BF16_OPS_PER_S)
        step_s = float(np.median(steps))
        log(f"{what}, {new} new tokens, max_len {max_len}, encoder and "
            f"cross-attention on the {'flash' if frames > 1024 else 'direct'}"
            f" route:")
        log(f"  served: {b * new} new tokens in {wall:.6f} s = "
            f"{b * new / wall:.3f} tok/s end to end (prefill with the "
            f"frames, then greedy decode on the memory)")
        log(f"  prefill: {b * plen} tokens over {b * frames} frames in "
            f"{prefill_s * 1e3:.6f} ms = {b * plen / prefill_s:.1f} tok/s; "
            f"bound {prefill_b * 1e3:.6f} ms ({ops} bf16 ops of the encoder"
            f" and decoder products and attention at 989 TFLOP/s), "
            f"{prefill_b / prefill_s:.4f} of it")
        log(f"  decode: median {step_s * 1e3:.6f} ms/step (min "
            f"{min(steps) * 1e3:.6f}, max {max(steps) * 1e3:.6f}, "
            f"{len(steps)} steps) = {b / step_s:.1f} tok/s; bound "
            f"{step_b * 1e3:.6f} ms (max of {read} B of decoder, head and "
            f"final norm at 3.35 TB/s and {recompute} ops of the cross K/V "
            f"recompute at 989 TFLOP/s), {step_b / step_s:.4f} of it; one "
            f"step: {launches}")
        log(f"  prefill vs the forward over exactly the prompts: max |d| "
            f"{pre_err:.6f}; teacher forcing vs the forward: max |d| "
            f"{err:.6f} over all {b * s} positions (tolerance "
            f"{LM_LOGIT_TOL}), mean |d| {mean_err:.3e}; argmax equal to the"
            f" forward's at {agree} of {n_clear} positions whose top-2 "
            f"margin exceeds {LM_LOGIT_TOL}")
        log(f"  card: {smi}")
        if not finite:
            fail(f"{what}: non-finite logits")
        if pre_err > LM_LOGIT_TOL:
            fail(f"{what}: prefill logits differ from the forward's over "
                 f"the prompts by {pre_err} > {LM_LOGIT_TOL}")
        if err > LM_LOGIT_TOL:
            fail(f"{what}: serve logits differ from the forward's by {err} "
                 f"> {LM_LOGIT_TOL}")
        if agree != n_clear:
            fail(f"{what}: {n_clear - agree} argmaxes differ from the "
                 "forward's past the tolerance")
    peak = torch.cuda.max_memory_allocated()
    log(f"max_memory_allocated: {peak} B ({weights} B of weights)")
    if peak < weights:
        fail(f"{AUDIO_ARCH}: {peak} B allocated at peak, {weights} B of "
             "weights; the model was not resident")
    del params
    torch.cuda.empty_cache()


# The recurrent families at full width and depth, each model freed before
# the next: (name, requests, prompt tokens, new tokens, max_len)
RECURRENT_ARCHS = ("xlstm-1.3b", "hymba-1.5b")
RECURRENT_BYTES = {"xlstm-1.3b": 4_497_625_088, "hymba-1.5b": 3_448_838_400}
RECURRENT_RUNS = (("R1", 8, 128, 32, 160), ("R2", 4, 1024, 16, 2048))
# Bound C, bf16: the largest |logit| difference of the prefill against
# the forward over exactly the prompts, and of teacher forcing against the
# forward over the served sequence (padded to 2,048 past 1,024), each
# max(0.25, twice the larger of the reference's own two readings at seeds
# 0 and 1 on the CPU), rounded up to a multiple of 0.05 (PERF.md section
# 6, fixed before the first card reading): (prefill, teacher forcing)
RECURRENT_BF16_TOL = {("xlstm-1.3b", "R1"): (0.25, 4.90),
                      ("xlstm-1.3b", "R2"): (0.25, 4.90),
                      ("hymba-1.5b", "R1"): (0.25, 0.60),
                      ("hymba-1.5b", "R2"): (0.70, 0.55)}
# the reference's own share of clear argmaxes (top-2 margin past 0.25)
# that agree, seeds 0 / 1: printed beside the card's, not gated
RECURRENT_REF_AGREE = {
    ("xlstm-1.3b", "R1"): "400 of 428 / 379 of 400",
    ("xlstm-1.3b", "R2"): "1,303 of 1,310 / 1,311 of 1,312",
    ("hymba-1.5b", "R1"): "426 of 426 / 408 of 408",
    ("hymba-1.5b", "R2"): "1,377 of 1,377 / 1,391 of 1,391"}
RECURRENT_F32_TOL = 0.01        # bound B: float32, both comparisons


def recurrent_prefill_ops(cfg, b: int, plen: int) -> tuple[int, int]:
    """A recurrent prefill's operations, 2 per weight per token and 2 per
    multiply-add of the GLA chunks (each chunk's C x C scores and
    intra-chunk product, its inter-chunk read and state update, the
    normalizer), the sLSTM recurrence, Hymba's causal attention pairs
    within each layer's window, and the head: -> (operations on
    ``cfg.dtype`` operands, operations on float32 ones: the float32
    weights, the GLA's upcast products and the sLSTM recurrence)."""
    from repro_torch.models import blocks, lm
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    n = b * plen
    c = blocks._pick_chunk(plen)
    kinds = [kind for kind in blocks.block_pattern(cfg)
             for _ in range(blocks.n_groups(cfg))]
    windows = lm.build_meta(cfg)[0].get("window")
    dt_ops, f32_ops = 2 * d * cfg.padded_vocab * n, 0
    for i, kind in enumerate(kinds):
        if kind == "mlstm":
            dk = int(di * cfg.qk_dim_ratio)
            dkh, dvh = dk // h, di // h
            dt_ops += 2 * n * (d * 2 * di + 2 * di * dk + di * d +
                               cfg.conv_width * di)
            f32_ops += 2 * n * (di * 2 * h + h * (
                c * dkh + c * dvh + 2 * dkh * dvh + dkh))
        elif kind == "slstm":
            dh = d // h
            dt_ops += 2 * n * d * d
            f32_ops += 2 * n * (4 * d * d + h * dh * 4 * dh)
        else:                                  # hymba
            hd, kv, ds = cfg.head_dim, cfg.n_kv, cfg.ssm_state
            dvh = di // h
            w = int(windows[i]) if windows is not None else 0
            pairs = sum(min(q + 1, w) if w > 0 else q + 1
                        for q in range(plen)) * b
            dt_ops += 2 * n * (2 * d * h * hd + 2 * d * kv * hd +
                               d * 2 * di + di * 2 * h * ds + di * d +
                               3 * d * cfg.d_ff + cfg.conv_width * di)
            dt_ops += 4 * h * hd * pairs
            f32_ops += 2 * n * (di * h + h * (
                c * ds + c * dvh + 2 * ds * dvh))
    if cfg.dtype == "float32":
        return 0, dt_ops + f32_ops
    return dt_ops, f32_ops


def recurrent_state_bytes(state, plen: int, max_len: int) -> int:
    """A decode step's serve state: every recurrent state and conv
    history whole, an attention cache's K/V up to the prompt."""
    total = 0
    for c in state["blocks"]:
        for name, t in c.items():
            if name == "attn":
                total += lm_bytes(t) * plen // max_len
            else:
                total += lm_bytes(t)
    return total


def recurrent_run(lm, lm_parity, ServeEngine, Request, cfg, params, name,
                  b, plen, new, max_len, dev, rng, smi) -> None:
    """One served batch of a recurrent model: the engine's tokens, the
    teacher-forced replay (timed), one decode step's launches, then the
    prefill against ``lm.forward`` over exactly the prompts and the replay
    against the forward over the served sequence (padded to a multiple of
    1,024 past 1,024: the same flash route and 256-token GLA chunks as the
    prefill), each within its bound; the argmax agreement at clear
    positions, gated in float32 and printed beside the reference's in
    bf16."""
    bf16 = cfg.dtype == "bfloat16"
    what = f"{cfg.name} {cfg.dtype} {name} ({b} x {plen}, {new} new, " \
        f"max_len {max_len})"
    weights = lm_bytes(params)
    ServeEngine(cfg, params, batch_size=b, max_len=max_len).run_batch(
        [Request(prompt=np.zeros(plen, np.int32), max_new_tokens=2)
         for _ in range(b)])                       # warm-up, not timed
    prompts = rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)
    eng = ServeEngine(cfg, params, batch_size=b, max_len=max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_batch([Request(prompt=q, max_new_tokens=new)
                          for q in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = np.asarray([r.out_tokens for r in done], np.int32)
    if outs.shape != (b, new) or outs.min() < 0 or outs.max() >= cfg.vocab:
        fail(f"{what}: served {outs.shape} tokens, not ({b}, {new}) ids in "
             f"[0, {cfg.vocab})")
    seq = np.concatenate([prompts, outs], axis=1)
    serve, state, prefill_s, steps = lm_parity.replay(
        cfg, params, seq, plen, max_len, dev, timed=True)
    launches = count_launches(lambda: lm.decode_step(
        cfg, params, state, torch.from_numpy(seq[:, -1:]).to(dev)))
    state_bytes = recurrent_state_bytes(state, plen, max_len)
    del state
    pre_fwd, _, _ = lm.forward(cfg, params,
                               {"tokens": torch.from_numpy(prompts).to(dev)})
    pre_fwd = pre_fwd[..., :cfg.vocab]
    pre_err = float((serve[:, :plen] - pre_fwd).abs().max())
    finite = bool(torch.isfinite(pre_fwd).all())
    del pre_fwd
    s = seq.shape[1]
    pad = s if s <= 1024 else -(-s // 1024) * 1024
    fwd_tokens = np.zeros((b, pad), np.int32)
    fwd_tokens[:, :s] = seq
    fwd, _, _ = lm.forward(cfg, params,
                           {"tokens": torch.from_numpy(fwd_tokens).to(dev)})
    fwd = fwd[:, :s - 1, :cfg.vocab]
    finite &= bool(torch.isfinite(serve).all() and torch.isfinite(fwd).all())
    diff = (serve - fwd).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    pad_pre_err = float(diff[:, :plen].max())
    del diff
    top2 = fwd.topk(2, dim=-1)
    clear = top2.values[..., 0] - top2.values[..., 1] > LM_LOGIT_TOL
    same = serve.argmax(dim=-1) == top2.indices[..., 0]
    n_clear, agree = int(clear.sum()), int((same & clear).sum())
    del serve, fwd, top2, same
    dt_ops, f32_ops = recurrent_prefill_ops(cfg, b, plen)
    prefill_b = max(weights / HBM_BYTES_PER_S,
                    dt_ops / BF16_OPS_PER_S + f32_ops / FP32_OPS_PER_S)
    step_b = (weights + state_bytes) / HBM_BYTES_PER_S
    step_s = float(np.median(steps))
    if bf16:
        pre_tol, tf_tol = RECURRENT_BF16_TOL[(cfg.name, name)]
        ref = RECURRENT_REF_AGREE[(cfg.name, name)]
    else:
        pre_tol = tf_tol = RECURRENT_F32_TOL
    log(f"{what}:")
    log(f"  served: {b * new} new tokens in {wall:.6f} s = "
        f"{b * new / wall:.3f} tok/s end to end (the engine)")
    ops = (f"{dt_ops} bf16 ops at 989 TFLOP/s + " if bf16 else "") + \
        f"{f32_ops} float32 ops at 67 TFLOP/s"
    log(f"  prefill: {b * plen} tokens in {prefill_s * 1e3:.6f} ms = "
        f"{b * plen / prefill_s:.1f} tok/s; bound {prefill_b * 1e3:.6f} ms "
        f"({ops}, or {weights} B of weights at 3.35 TB/s), "
        f"{prefill_b / prefill_s:.4f} of it")
    log(f"  decode: median {step_s * 1e3:.6f} ms/step (min "
        f"{min(steps) * 1e3:.6f}, max {max(steps) * 1e3:.6f}, {len(steps)} "
        f"steps) = {b / step_s:.1f} tok/s; bound {step_b * 1e3:.6f} ms "
        f"({weights} B of weights + {state_bytes} B of serve state at 3.35 "
        f"TB/s), {step_b / step_s:.4f} of it; one step: {launches}")
    log(f"  prefill vs the forward over exactly the prompts: max |d| "
        f"{pre_err:.6f} (bound {pre_tol}); vs the forward over the served "
        f"sequence ({pad} wide): {pad_pre_err:.6f} (not gated)")
    log(f"  teacher forcing vs the forward: max |d| {err:.6f} over all "
        f"{b * (s - 1)} positions (bound {tf_tol}), mean |d| {mean_err:.3e};"
        f" argmax equal to the forward's at {agree} of {n_clear} positions "
        f"whose top-2 margin exceeds {LM_LOGIT_TOL}" +
        (f" (the reference's own, seeds 0 / 1: {ref})" if bf16 else ""))
    log(f"  card: {smi}")
    if not finite:
        fail(f"{what}: non-finite logits")
    if pre_err > pre_tol:
        fail(f"{what}: prefill logits differ from the forward's over the "
             f"prompts by {pre_err} > {pre_tol}")
    if err > tf_tol:
        fail(f"{what}: teacher-forced logits differ from the forward's by "
             f"{err} > {tf_tol}")
    if not bf16 and agree != n_clear:
        fail(f"{what}: {n_clear - agree} argmaxes differ from the forward's "
             "past the tolerance")


def recurrent_full_width(lm, get_config, dev, seed: int, smi: str) -> None:
    """xlstm-1.3b and hymba-1.5b at full width and depth, weights drawn on
    the card from ``seed``, each in bf16 and then float32, each served in
    R1 (8 x 128-token prompts, 32 new, max_len 160) and R2 (4 x 1,024, 16
    new, max_len 2,048): :func:`recurrent_run`."""
    from repro_torch.serve import Request, ServeEngine, lm_parity
    for arch in RECURRENT_ARCHS:
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_config(arch), dtype=dtype)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = lm.init_params(cfg, seed, device=dev)
            torch.cuda.synchronize()
            weights = lm_bytes(params)
            log(f"{arch} in {dtype}: {lm.param_count(params)} parameters, "
                f"{weights} B of weights drawn on the card in "
                f"{time.perf_counter() - t0:.3f} s ({cfg.n_layers} layers, "
                f"d_model {cfg.d_model})")
            if dtype == "bfloat16" and weights != RECURRENT_BYTES[arch]:
                fail(f"{arch}: {weights} B of weights, not "
                     f"{RECURRENT_BYTES[arch]}")
            rng = np.random.default_rng(seed + 1)
            for name, b, plen, new, max_len in RECURRENT_RUNS:
                recurrent_run(lm, lm_parity, ServeEngine, Request, cfg,
                              params, name, b, plen, new, max_len, dev, rng,
                              smi)
            peak = torch.cuda.max_memory_allocated()
            log(f"{arch} {dtype}: max_memory_allocated {peak} B ({weights} "
                f"B of weights)")
            if peak < weights:
                fail(f"{arch}: {peak} B allocated at peak, {weights} B of "
                     "weights; the model was not resident")
            del params
            torch.cuda.empty_cache()


def lm_path(lm, configs, Request, ServeEngine, dev, seed: int,
            smi: str) -> None:
    """Phase 8: the LM serving path, every family (dense, vlm, moe,
    audio, ssm and hybrid)."""
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.serve import lm_parity
    log("LM parity at reduced width, float32, the engine on the card "
        "against the CPU (repro_torch.serve.lm_parity):")
    glm = configs.reduced(configs.get_config("glm4-9b"))
    cases = [(configs.reduced(configs.get_config(a)), 24) for a in LM_ARCHS]
    cases += [(dataclasses.replace(glm, kv_cache_dtype="int8"), 24),
              (glm, 2048)]
    cases += [(configs.reduced(configs.get_config(a)), n)
              for a, *_ in MOE_MODELS for n in (24, 2048)]
    cases += [(configs.reduced(configs.get_config(a)), n)
              for a in RECURRENT_ARCHS for n in (24, 2048)]
    cases = [(cfg, max_len, None) for cfg, max_len in cases]
    # reduced seamless: over the loader's frames, enc_len the prompt's
    # length (both of _bidir_attention's routes direct), over 2,048 frames
    # (both flash), and through the engine on an empty memory
    audio = configs.reduced(configs.get_config(AUDIO_ARCH))
    store = TokenStore(synthetic_corpus(10_000, audio.vocab, seed),
                       audio.vocab)
    for frames in (lm_parity.PROMPT, 2048):
        fr = next(token_batches(store, audio, batch=lm_parity.BATCH,
                                seq=frames, seed=seed, device="cpu"))
        cases.append((audio, 24, fr["frames"].numpy()))
    cases.append((audio, 24, None))
    for cfg, max_len, frames in cases:
        try:
            log("  " + lm_parity.check_card_matches_cpu(
                cfg, dev, seed=seed, max_len=max_len, frames=frames))
        except AssertionError as e:
            fail(f"LM parity: {e}")
    lm_full_width(lm, configs.get_config, Request, ServeEngine, dev, seed,
                  smi)
    lm_moe_full_width(lm, configs.get_config, dev, seed, smi)
    audio_full_width(lm, configs.get_config, dev, seed, smi)
    recurrent_full_width(lm, configs.get_config, dev, seed, smi)


# -- phase 9 ------------------------------------------------------------------
F32_OPS_PER_S = 67e12              # H100 SXM float32, no tensor cores
TRAIN_ARCH = "minicpm-2b"
# its bf16 weights: ModelConfig.param_count()'s 2,724,986,880 parameters
# and the 81 norm scales it leaves out (186,624)
TRAIN_BYTES = 5_450_347_008
TRAIN_CORPUS = 2_000_000
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 2, 2048, 12, 2, 3e-3
T2_STEPS = 4
# |bf16 - float32| train_loss of minicpm-2b's first batch at full width:
# twice the reference's own gap on the CPU (PERF.md section 6, LM training;
# fixed before the first card reading)
TRAIN_BF16_LOSS_TOL = 0.17
FLASH_GRAD_SHAPE = (2, 2048, 36, 1, 64)       # minicpm-2b's layer: B,S,KV,G,dh
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
CE_TOL = 1e-5


def lm_train_flops(cfg, b: int, s: int) -> tuple[int, int]:
    """A train step's products as the reference defines them: (bf16 ops,
    float32 ops). 6 per weight per token (forward and two backward
    products); attention's products over every key (no causal block is
    skipped), 2 B H S T dh each: three with bf16 inputs (the forward
    scores and p.v, the backward's recomputed scores), four in float32
    (the backward's dv, dp, dq, dk)."""
    per = 2 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers
    return 6 * lm_matmul_params(cfg) * b * s + 3 * per, 4 * per


def lm_train_flops_causal(cfg, b: int, s: int) -> int:
    """The same step's own work, whatever the design: 6 per weight per
    token, and attention's six products (forward scores and p.v; backward
    dv, dp, dq, dk) over the causal pairs only, all with bf16 inputs. The
    float32 term of :func:`lm_train_flops` is the cost of this port's
    backward design, not a floor."""
    pairs = b * s * (s + 1) // 2
    return 6 * lm_matmul_params(cfg) * b * s + \
        cfg.n_layers * 6 * 2 * cfg.n_heads * cfg.head_dim * pairs


def peak_bytes(fn) -> int:
    """Device bytes allocated at peak during ``fn`` above those live
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def train_parity(configs, dev, seed: int) -> None:
    """9A: one train step and one update of each optimizer, card against
    CPU, every arch at reduced width, then reduced glm4-9b at S 2,048."""
    from repro_torch.train import parity
    log("A. train parity at reduced width, float32, the card against the "
        "CPU (repro_torch.train.parity):")
    cases = [(configs.reduced(configs.get_config(a)), 16)
             for a in configs.ARCH_IDS]
    cases.append((dataclasses.replace(
        configs.reduced(configs.get_config("glm4-9b")), loss_chunk=1024,
        remat="layer"), 2048))
    for cfg, s in cases:
        t0 = time.perf_counter()
        try:
            line = parity.check_train_card_matches_cpu(cfg, dev, seed=seed,
                                                       s=s)
        except AssertionError as e:
            fail(f"train parity: {e}")
        log(f"  {line} [{time.perf_counter() - t0:.3f} s]")


def direct_attention(qg, k, v, q_pos, window: float) -> torch.Tensor:
    """Softmax attention over the whole (S, T) score matrix, float32."""
    from repro_torch.models.flash import _mask
    t = k.shape[1]
    k_pos = torch.arange(t, dtype=torch.float32, device=k.device)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    scores = scores + _mask(q_pos, k_pos, window,
                            torch.zeros(t, device=k.device))
    return torch.einsum("bkgst,btkd->bskgd", torch.softmax(scores, dim=-1),
                        v)


def flash_grad_check(dev, seed: int) -> None:
    """9B: the flash backward at minicpm-2b's layer shape against autograd
    of direct attention on the card."""
    from repro_torch.models.flash import flash_attention
    b, s, kvh, g, dh = FLASH_GRAD_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qg = torch.randn((b, s, kvh, g, dh), generator=gen, device=dev) * \
        dh ** -0.5
    k = torch.randn((b, s, kvh, dh), generator=gen, device=dev)
    v = torch.randn((b, s, kvh, dh), generator=gen, device=dev)
    dout = torch.randn((b, s, kvh, g, dh), generator=gen, device=dev)
    q_pos = torch.arange(s, dtype=torch.float32, device=dev)
    kbias = torch.zeros(s, dtype=torch.float32, device=dev)
    log(f"B. the flash backward, qg {tuple(qg.shape)}, k/v "
        f"{tuple(k.shape)}, chunk 1024, against autograd of direct "
        "attention:")
    for window in (0.0, 1024.0):
        for dt in (torch.float32, torch.bfloat16):
            ins = [x.to(dt) for x in (qg, k, v)]
            d_in = dout.to(dt)

            def flash():
                leaves = [x.clone().requires_grad_() for x in ins]
                out = flash_attention(*leaves, q_pos, kbias, window, 1024)
                return torch.autograd.grad(out, leaves, d_in)

            def direct():
                leaves = [x.float().requires_grad_() for x in ins]
                out = direct_attention(*leaves, q_pos, window)
                return torch.autograd.grad(out, leaves, d_in.float())

            got, want = flash(), direct()
            errs = []
            for name, a, r in zip(("dq", "dk", "dv"), got, want):
                d = float((a.float() - r).abs().max())
                ref = float(r.abs().max())
                errs.append(f"{name} {d:.3e} / {ref:.3e}")
                if not d <= FLASH_GRAD_TOL[dt] * ref:
                    fail(f"flash backward ({dt}, window {window:g}): {name} "
                         f"differs by {d} > {FLASH_GRAD_TOL[dt]} x {ref}")
            del got, want
            f_ms, d_ms = (time_ms(flash, 1, 3, False),
                            time_ms(direct, 1, 3, False))
            f_peak, d_peak = peak_bytes(flash), peak_bytes(direct)
            log(f"  {str(dt)[6:]}, window {window:g}: max |d| / max |ref| "
                f"{', '.join(errs)} (tolerance {FLASH_GRAD_TOL[dt]}); "
                f"forward + backward flash {f_ms:.3f} ms, peak "
                f"{f_peak} B; direct {d_ms:.3f} ms, peak {d_peak} B")


def chunked_ce_check(lm, get_config, dev, seed: int) -> None:
    """9C: ``chunked_ce`` at minicpm-2b's full vocabulary against the
    unchunked loss on the card, float32."""
    from repro_torch.models import layers as L
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    embed = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=dev)
    x = L.rms_norm(torch.randn((TRAIN_B, TRAIN_S, cfg.d_model),
                               generator=gen, device=dev),
                   torch.ones(cfg.d_model, device=dev), cfg.norm_eps)
    labels = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S), generator=gen,
                           device=dev)
    labels[0, 5] = -1

    def run(chunked: bool):
        xs, e = x.clone().requires_grad_(), embed.clone().requires_grad_()
        if chunked:
            loss_sum, n = lm.chunked_ce(cfg, xs, e.T, labels, 1024)
        else:
            logits = lm._mask_pad_vocab(cfg, (xs @ e.T).float())
            loss_sum, n = lm._ce_terms(cfg, logits, labels)
        loss = loss_sum / n
        return (loss.detach(), *torch.autograd.grad(loss, [xs, e]))

    got, want = run(True), run(False)
    loss_d = abs(float(got[0]) - float(want[0]))
    errs = []
    if not loss_d <= CE_TOL * max(1.0, abs(float(want[0]))):
        fail(f"chunked_ce: loss {float(got[0])} against {float(want[0])}")
    for name, a, r in zip(("x_final", "head"), got[1:], want[1:]):
        d, ref = float((a - r).abs().max()), float(r.abs().max())
        errs.append(f"d{name} {d:.3e} / {ref:.3e}")
        if not d <= CE_TOL * ref:
            fail(f"chunked_ce: the gradient of {name} differs by {d} > "
                 f"{CE_TOL} x {ref}")
    del got, want
    c_ms = time_ms(lambda: run(True), 1, 3, False)
    u_ms = time_ms(lambda: run(False), 1, 3, False)
    c_peak, u_peak = peak_bytes(lambda: run(True)), \
        peak_bytes(lambda: run(False))
    log(f"C. chunked_ce, tied head {cfg.d_model} x {cfg.padded_vocab}, B "
        f"{TRAIN_B} x S {TRAIN_S}, chunk 1024, float32: loss "
        f"{float(run(True)[0]):.6f} (|d| {loss_d:.3e}), max |d| / max |ref| "
        f"{', '.join(errs)} (tolerance {CE_TOL}); loss + backward chunked "
        f"{c_ms:.3f} ms, peak {c_peak} B; unchunked {u_ms:.3f} ms, peak "
        f"{u_peak} B")


def train_full_width(lm, get_config, dev, seed: int, smi: str) -> None:
    """9D: minicpm-2b at full width and depth in bf16, T1 (AdamW, 12
    steps) and T2 (AdamW8, 4 steps) through the ``Trainer``."""
    from torch.utils import _pytree as pytree
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.train import optimizer, parity
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           make_train_step)
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    weights = lm_bytes(params)
    log(f"D. {TRAIN_ARCH}: {lm.param_count(params)} parameters, {weights} B "
        f"of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, remat {cfg.remat!r}, loss_chunk {cfg.loss_chunk})")
    if weights != TRAIN_BYTES:
        fail(f"{TRAIN_ARCH}: {weights} B of weights, not {TRAIN_BYTES}")
    t0 = time.perf_counter()
    store = TokenStore(synthetic_corpus(TRAIN_CORPUS, cfg.vocab, seed=seed),
                       cfg.vocab)
    log(f"  token store: {store.n} tokens, {store.bits}-bit codes, built in "
        f"{time.perf_counter() - t0:.3f} s")

    def batches():
        return token_batches(store, cfg, batch=TRAIN_B, seq=TRAIN_S,
                             seed=seed, device=dev)

    first = next(batches())
    with torch.no_grad():
        loss_bf16 = float(lm.train_loss(cfg, params, first)[0])
        p32 = pytree.tree_map(lambda t: t.float(), params)
        loss_f32 = float(lm.train_loss(
            dataclasses.replace(cfg, dtype="float32"), p32, first)[0])
        del p32
    torch.cuda.empty_cache()
    gap = abs(loss_bf16 - loss_f32)
    log(f"  step 0's batch: train_loss {loss_bf16!r} in bf16, {loss_f32!r} "
        f"with a float32 copy of the weights, |d| {gap!r} (tolerance "
        f"{TRAIN_BF16_LOSS_TOL})")
    if not gap <= TRAIN_BF16_LOSS_TOL:
        fail(f"{TRAIN_ARCH}: bf16 loss {loss_bf16} is {gap} from the "
             f"float32 loss {loss_f32} (tolerance {TRAIN_BF16_LOSS_TOL})")

    bf16_ops, f32_ops = lm_train_flops(cfg, TRAIN_B, TRAIN_S)
    bound = bf16_ops / BF16_OPS_PER_S + f32_ops / F32_OPS_PER_S
    own_ops = lm_train_flops_causal(cfg, TRAIN_B, TRAIN_S)
    own = own_ops / BF16_OPS_PER_S
    runs = (("T1", "adamw", TRAIN_STEPS), ("T2", "adamw8", T2_STEPS))
    adamw_bytes = 0
    for name, opt_name, steps in runs:
        opt = optimizer.OptConfig(name=opt_name, lr=TRAIN_LR)
        train = TrainConfig(steps=steps, warmup=TRAIN_WARMUP, schedule="wsd",
                            log_every=1, ckpt_every=0)
        trainer = Trainer(cfg=cfg, opt=opt, train=train)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, hist = trainer.fit(params, batches())
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        state_b = optimizer.state_bytes(trainer.opt_state)
        log(f"  {name}: {TRAIN_ARCH} with {opt_name}, lr {TRAIN_LR} (wsd, "
            f"warmup {TRAIN_WARMUP}), {steps} steps of B {TRAIN_B} x S "
            f"{TRAIN_S} in {wall:.3f} s:")
        for h in hist:
            log(f"    step {h['step']}: loss {h['loss']!r}, grad norm "
                f"{h['grad_norm']!r}, lr {h['lr']!r}, {h['dt'] * 1e3:.3f} ms")
        bad = [h["step"] for h in hist if not (math.isfinite(h["loss"]) and
                                               math.isfinite(h["grad_norm"]))]
        if bad:
            fail(f"{name}: non-finite loss or grad norm at steps {bad}")
        if name == "T1":
            adamw_bytes = state_b
            if not hist[-1]["loss"] < hist[0]["loss"]:
                fail(f"{name}: the loss at step {hist[-1]['step']} "
                     f"({hist[-1]['loss']}) is not below step 0's "
                     f"({hist[0]['loss']})")
            step_s = statistics.median(h["dt"] for h in hist[2:])
            log(f"    median step over steps 2-{steps - 1}: "
                f"{step_s * 1e3:.3f} ms = "
                f"{TRAIN_B * TRAIN_S / step_s:.1f} tok/s; bound "
                f"{bound * 1e3:.3f} ms ({bf16_ops} bf16 ops at 989 TFLOP/s "
                f"+ {f32_ops} float32 ops at 67 TFLOP/s), "
                f"{bound / step_s:.4f} of it; the function's own bound "
                f"{own * 1e3:.3f} ms ({own_ops} ops over the causal pairs, "
                f"all bf16 at 989 TFLOP/s), {own / step_s:.4f} of it")
            step_fn, _ = make_train_step(cfg, opt, train)
            batch = next(batches())
            state = trainer.opt_state
            launches = count_launches(lambda: step_fn(params, state, batch,
                                                      steps), top=8)
            _, _, grads = parity.loss_and_grads(cfg, params, batch)
            lr = torch.tensor(TRAIN_LR, dtype=torch.float32)
            opt_ms = time_ms(lambda: optimizer.apply_updates(
                opt, grads, state, params, lr), 1, 3, False)
            del grads, state
            log(f"    one more step: {launches}; the optimizer alone "
                f"{opt_ms:.3f} ms a step")
        log(f"    optimizer state {state_b} B"
            + (f" ({state_b / adamw_bytes:.4f} of AdamW's {adamw_bytes} B)"
               if name == "T2" else "")
            + f"; max_memory_allocated {peak} B ({weights} B of weights)")
        log(f"    card: {smi}")
        del trainer
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def lm_train_path(lm, configs, dev, seed: int, smi: str) -> None:
    """Phase 9: LM training, every family at reduced width held to the
    CPU, the flash backward and the chunked loss at minicpm-2b's shapes,
    then minicpm-2b trained at full width and depth."""
    train_parity(configs, dev, seed)
    flash_grad_check(dev, seed)
    chunked_ce_check(lm, configs.get_config, dev, seed)
    train_full_width(lm, configs.get_config, dev, seed, smi)


MESH_B, MESH_S = 2, 16                     # 10A's reduced steps
DRY_SHAPE = ("t1", TRAIN_S, TRAIN_B, "train")   # minicpm-2b's T1 step
DRY_PEAK_BAND = (0.85, 1.15)       # measured peak / predicted, B and C
SHARE_ARCH, SHARE_SHAPE, SHARE_WORLD = "glm4-9b", "train_4k", 256
SHARE_LIMIT = 72e9                 # else C takes glm4-9b prefill_32k


def one_rank_mesh(dev, path: str):
    """A (1, 1) ("data", "model") mesh over a one-rank process group on
    ``dev`` (NCCL on the card, gloo on the CPU), met through a file."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def full_leaves(tree) -> list:
    from torch.utils import _pytree as pytree
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in pytree.tree_leaves(tree)]


def mesh_matches_meshless(configs, mesh, dev, seed: int) -> None:
    """10A, reduced: every arch, float32, 2 AdamW steps of B 2 x S 16
    through ``make_train_step(mesh=)`` against 2 meshless steps from the
    same init: the losses and every parameter bit for bit."""
    from repro_torch.models import lm
    from repro_torch.train import parity
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    opt = OptConfig(name="adamw", lr=1e-2)
    train = TrainConfig(steps=4, warmup=1)
    for arch in configs.ARCH_IDS:
        cfg = configs.reduced(configs.get_config(arch))
        rng = np.random.default_rng(seed)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    parity.train_batch(cfg, rng, MESH_B, MESH_S).items()}
                   for _ in range(2)]
        runs = []
        t0 = time.perf_counter()
        for m in (None, mesh):
            params = lm.init_params(cfg, seed, device=dev)
            state = init_opt_state(opt, params)
            step, _ = make_train_step(cfg, opt, train, mesh=m)
            losses = []
            for i, b in enumerate(batches):
                params, state, met = step(params, state, b, i)
                losses.append(met["loss"])
            runs.append((losses, full_leaves(params)))
        (l0, p0), (l1, p1) = runs
        same = [torch.equal(a, b) for a, b in zip(p0, p1)]
        log(f"  {arch}: losses {[float(x) for x in l0]} meshless, "
            f"{[float(x) for x in l1]} on the mesh; {sum(same)} of "
            f"{len(same)} parameters equal [{time.perf_counter() - t0:.3f}"
            " s]")
        if not (all(torch.equal(a, b) for a, b in zip(l0, l1)) and
                all(same)):
            fail(f"10A: {arch} on the one-rank mesh differs from its "
                 "meshless steps")


def mesh_full_width(lm, configs, mesh, dev, seed: int) -> None:
    """10A, minicpm-2b at full width and depth in bf16 on T1's first batch:
    ``loss_and_grads`` twice meshless and once on the mesh, from the same
    parameters. The mesh's loss and each gradient leaf within the second
    meshless run's distance from the first (bit for bit where the
    meshless run repeats itself)."""
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.train.trainer import loss_and_grads
    cfg = configs.get_config(TRAIN_ARCH)
    params = lm.init_params(cfg, seed, device=dev)
    store = TokenStore(synthetic_corpus(TRAIN_CORPUS, cfg.vocab, seed=seed),
                       cfg.vocab)
    batch = next(token_batches(store, cfg, batch=TRAIN_B, seq=TRAIN_S,
                               seed=seed, device=dev))

    def run(p, b, m=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_mesh(m):
            out = loss_and_grads(cfg, p, b)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (l1, _, g1), ms1 = run(params, batch)
    (l2, _, g2), _ = run(params, batch)
    g1, g2 = full_leaves(g1), full_leaves(g2)
    noise = [float((a.float() - b.float()).abs().max())
             for a, b in zip(g1, g2)]
    del g2
    dp = shd.distribute(params, shd.param_pspecs(cfg, params, mesh), mesh)
    db = shd.distribute(batch, shd.batch_pspecs(cfg, batch, mesh), mesh)
    (l3, _, g3), ms3 = run(dp, db, mesh)
    l3 = l3.full_tensor()
    worse = []
    for i, (a, b) in enumerate(zip(g1, full_leaves(g3))):
        d = float((a.float() - b.float()).abs().max())
        if d > noise[i]:
            worse.append((i, d, noise[i]))
    calls = {}
    for name, fn in (("meshless", lambda: loss_and_grads(cfg, params,
                                                         batch)),
                     ("mesh", lambda: run(dp, db, mesh))):
        calls[name] = count_launches(fn)
    log(f"  {TRAIN_ARCH} full width, bf16, B {TRAIN_B} x S {TRAIN_S}: loss "
        f"{float(l1)!r} meshless ({float(l2)!r} again), {float(l3)!r} on "
        f"the mesh; {len(g1) - len(worse)} of {len(g1)} gradient leaves "
        f"within the meshless runs' own distance (largest "
        f"{max(noise)!r}); step {ms1:.3f} ms meshless ({calls['meshless']}"
        f"), {ms3:.3f} ms on the mesh ({calls['mesh']})")
    if abs(float(l3) - float(l1)) > abs(float(l2) - float(l1)) or worse:
        fail(f"10A: {TRAIN_ARCH} on the mesh: loss {float(l3)} against "
             f"{float(l1)}/{float(l2)}; leaves past the meshless noise "
             f"(index, |d|, noise): {worse[:5]}")
    del g1, g3, dp, params
    torch.cuda.empty_cache()


def dryrun_against_card(configs, mesh, dev, seed: int) -> None:
    """10B: the dry-run's trace of minicpm-2b's T1 step on the one-rank
    mesh against the same step run for real: FLOPs equal to
    ``FlopCounterMode``'s count exactly, the predicted peak within
    ``DRY_PEAK_BAND`` of ``max_memory_allocated``."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch import dryrun
    cfg = configs.get_config(TRAIN_ARCH)
    shape = configs.ShapeSpec(*DRY_SHAPE)
    pred = dryrun.trace_cell(cfg, shape, mesh, device=dev.type)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    step, args = dryrun.build_cell(cfg, shape, mesh, dev.type)
    dryrun.fill(args, cfg, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, activation_mesh(mesh), \
            dryrun.step_context(shape.kind):
        out = step(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    flops = fc.get_total_flops()
    ratio = peak / pred["memory"]["peak_bytes"]
    log(f"  B. {TRAIN_ARCH} T1 ({shape.global_batch} x {shape.seq_len}, "
        f"AdamW, remat {cfg.remat!r}) on the one-rank mesh: trace "
        f"{pred['flops']!r} FLOPs, {pred['bytes_accessed']!r} B accessed, "
        f"peak {pred['memory']['peak_bytes']} B predicted "
        f"({pred['memory']}) [trace {pred['times']['trace_s']:.3f} s]; "
        f"the step for real: {flops!r} FLOPs (FlopCounterMode), "
        f"max_memory_allocated {peak} B above the {base} B before, "
        f"{ratio:.4f} of the prediction, {wall:.3f} ms under the counter")
    del out, args, step
    torch.cuda.empty_cache()
    if flops != pred["flops"]:
        fail(f"10B: the trace counts {pred['flops']} FLOPs, the card's step "
             f"{flops}")
    if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
        fail(f"10B: peak {peak} B is {ratio:.4f} of the predicted "
             f"{pred['memory']['peak_bytes']} B (band {DRY_PEAK_BAND})")


def production_share(configs, dev, seed: int) -> None:
    """10C: rank 0's share of a production cell run for real on the card,
    under a fake process group of 256 ranks (its collectives move
    nothing, so its values are not checked): FLOPs equal to the dry-run's
    trace exactly, peak within ``DRY_PEAK_BAND`` of its prediction, and
    the share's ms beside the roofline's compute and memory terms."""
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    cfg = configs.get_config(SHARE_ARCH)
    name = SHARE_SHAPE
    with fake_world(SHARE_WORLD):
        mesh = make_production_mesh(device_type=dev.type)
        pred = dryrun.trace_cell(cfg, configs.SHAPES[name], mesh,
                                 device=dev.type)
        if pred["memory"]["peak_bytes"] > SHARE_LIMIT:
            name = "prefill_32k"
            pred = dryrun.trace_cell(cfg, configs.SHAPES[name], mesh,
                                     device=dev.type)
        shape = configs.SHAPES[name]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        step, args = dryrun.build_cell(cfg, shape, mesh, dev.type)
        dryrun.fill(args, cfg, seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = dryrun.StepTrace(dryrun.mesh_groups(mesh))
        with activation_mesh(mesh), dryrun.step_context(shape.kind), tr:
            out = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        t0 = time.perf_counter()
        with activation_mesh(mesh), dryrun.step_context(shape.kind):
            out = step(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        del out, args, step
        torch.cuda.empty_cache()
    nvlink, net = dryrun.link_bytes(pred["collectives"]["axis_bytes"])
    roof = dryrun.roofline_terms(pred["flops"], pred["bytes_accessed"],
                                 nvlink, 1, net)
    ratio = peak / pred["memory"]["peak_bytes"]
    log(f"  C. {SHARE_ARCH} {name} on (32, 8), rank 0's share on the card: "
        f"{tr.flops!r} FLOPs ({pred['flops']!r} traced), peak {peak} B "
        f"({pred['memory']['peak_bytes']} B predicted, {ratio:.4f} of it), "
        f"collectives {pred['collectives']['axis_bytes']} B by axis "
        f"(moving nothing here); the step {ms:.3f} ms against the "
        f"roofline's compute {roof['compute_s'] * 1e3:.3f} ms and memory "
        f"{roof['memory_s'] * 1e3:.3f} ms (H100 published figures) "
        f"[trace {pred['times']['trace_s']:.3f} s]")
    if tr.flops != pred["flops"]:
        fail(f"10C: the share runs {tr.flops} FLOPs, the trace counts "
             f"{pred['flops']}")
    if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
        fail(f"10C: peak {peak} B is {ratio:.4f} of the predicted "
             f"{pred['memory']['peak_bytes']} B (band {DRY_PEAK_BAND})")


def mesh_path(lm, configs, dev, seed: int) -> None:
    """Phase 10: the one-rank mesh against no mesh (A), the dry-run against
    the card (B), a production cell's share on the card (C)."""
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        mesh = one_rank_mesh(dev, str(Path(tmp) / "store"))
        try:
            log("A. a one-rank mesh on the card against no mesh:")
            mesh_matches_meshless(configs, mesh, dev, seed)
            mesh_full_width(lm, configs, mesh, dev, seed)
            dryrun_against_card(configs, mesh, dev, seed)
        finally:
            dist.destroy_process_group()
    production_share(configs, dev, seed)


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
    from repro_torch.models import lm
    from repro_torch.models import widedeep as wd
    from repro_torch import configs
    from repro_torch import serve as S
    from repro_torch.serve import FeatureService, Request, ServeEngine
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

    # -- 3c. sharded serving ----------------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    table_s = sharded_table(Column, Dictionary, Table, table,
                            n_rows // N_SHARDS)
    plan_s = FeaturePlan(table_s, serving_features(FeatureSet), packed=True,
                         device=dev)
    log(f"sharded serving (bench_featurize.py's serve/feature_service_"
        f"sharded and _skewed mixes over this table in {N_SHARDS} IMCUs of "
        f"{n_rows // N_SHARDS} rows; table and plan built in "
        f"{time.perf_counter() - t0:.3f} s):")
    sharded = sharded_path(S, ops, scan_ops, hist_ops, ex_p, plan_p, plan_s,
                           plan_i, p1, p2,
                           np.random.default_rng(args.seed + 13), counters)
    del plan_s
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    log(f"phase 3c (sharded serving) wall: "
        f"{time.perf_counter() - phase_t0:.3f} s")

    # -- 3d. fault tolerance and tiers ------------------------------------------------
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    plan_d = FeaturePlan(table_s, serving_features(FeatureSet), packed=True,
                         device=dev)
    log(f"fault tolerance and tiers (phase 3c's table, {N_SHARDS} IMCUs of "
        f"{n_rows // N_SHARDS} rows, a fresh plan over it in "
        f"{time.perf_counter() - phase_t0:.3f} s):")
    faulted = fault_tier_path(S, plan_d, ex_p, p1,
                              np.random.default_rng(args.seed + 14),
                              counters, dev)
    del table_s, plan_d
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    log(f"phase 3d (fault tolerance and tiers) wall: "
        f"{time.perf_counter() - phase_t0:.3f} s")

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
    for k, v in (*front.items(), *sharded.items(), *faulted.items()):
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

    # -- 8. LM serving (every family) ----------------------------------------------------
    phase_t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the LM's float32 parity needs full float32")
    for counter in counters:
        counter.reset_launches()
    log("LM serving (no hand-written kernel on this path: cuBLAS products "
        "and PyTorch ops; the launch counts must stay 0):")
    lm_path(lm, configs, Request, ServeEngine, dev, args.seed, smi)
    served = {k: v for counter in counters for k, v in counter.LAUNCHES.items()}
    log(f"kernels launched on the LM serving path: {served}")
    if any(served.values()):
        fail("the LM serving path launched a kernel it has no use for")
    log(f"phase 8 (LM serving) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 9. LM training -------------------------------------------------------------------
    phase_t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the training parity needs full float32")
    for counter in counters:
        counter.reset_launches()
    log("LM training (no hand-written kernel on this path: cuBLAS products "
        "and PyTorch ops; the launch counts must stay 0):")
    lm_train_path(lm, configs, dev, args.seed, smi)
    trained = {k: v for counter in counters
               for k, v in counter.LAUNCHES.items()}
    log(f"kernels launched on the LM training path: {trained}")
    if any(trained.values()):
        fail("the LM training path launched a kernel it has no use for")
    log(f"phase 9 (LM training) wall: {time.perf_counter() - phase_t0:.3f} s")

    # -- 10. dry-run and model sharding -------------------------------------------------
    phase_t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the mesh parity needs full float32")
    for counter in counters:
        counter.reset_launches()
    log("dry-run and model sharding (no hand-written kernel on this path; "
        "the launch counts must stay 0):")
    mesh_path(lm, configs, dev, args.seed)
    sharded = {k: v for counter in counters
               for k, v in counter.LAUNCHES.items()}
    log(f"kernels launched on the sharding path: {sharded}")
    if any(sharded.values()):
        fail("the sharding path launched a kernel it has no use for")
    log(f"phase 10 (dry-run and model sharding) wall: "
        f"{time.perf_counter() - phase_t0:.3f} s")

    # -- 11. report ------------------------------------------------------------------
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
