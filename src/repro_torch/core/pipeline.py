"""Feature pipeline split into a compile-time plan and a run-time executor.

The paper's device pipeline is 'codes in, features out' (§6, Fig 2): only
dictionary codes (b-bit packed) and K-row ADV tables move to the device;
row-space float features are produced on-device by the ADV gather kernels
and consumed immediately — never materialized in host memory or exported
files, the data-movement win over the CSV-export workflow of Fig 1.

Layering (this module):

- :class:`FeaturePlan` — the compile-time half. Builds the per-column fused
  K-row ADV tables, puts them on the device ONCE (back to back, see
  :func:`repro_torch.kernels.adv_gather.fuse_tables`), and lays out the host
  code streams in one of two forms:

  * ``packed=False`` — a single (C, N) int32 matrix; a batch slice is ONE
    fancy-index + ONE host->device transfer.
  * ``packed=True``  — the packed fast path: per-column uint32 word streams
    at the device width ``tpu_width(bits)`` (straight from the Column/IMCU
    device views). int32 code streams never exist — neither in host RAM nor
    on the wire.

  Both layouts are maintained under streaming inserts via
  :meth:`FeaturePlan.refresh`. :func:`plan_from_reference` builds a packed
  plan from another implementation's plan state (word streams, widths,
  tables) instead of from a table.
- :class:`FeatureExecutor` — the run-time half. Packed plans keep every
  column's words in ONE device-resident stream and serve word-aligned
  ranges (:meth:`FeatureExecutor.batch_range`, coalesced
  :meth:`FeatureExecutor._multi_range_future`) and arbitrary rows
  (:meth:`FeatureExecutor._rows_future`) through the packed CUDA kernels —
  a range moves only its start index, a row set only its int32 indices.
  int32 plans ship code slices into the int32 kernel
  (:meth:`FeatureExecutor.gather_device`). :meth:`FeatureExecutor.batches`
  keeps ``prefetch`` launches in flight; on int32 plans the code slices are
  staged in pinned memory and copied on a side stream, overlapping the
  gather of the batch before. Packed executors also push predicates down
  (:meth:`FeatureExecutor.count_where`, ``filtered_rows``, ``batch_where``,
  ``groupby_where``, ``agg_where``): a predicate compiles to code-space
  terms over the column dictionaries, one scan kernel launch evaluates it
  on the resident words and counts the matches, and the matches are
  compacted on the device and gathered, or counted per code by the masked
  histogram kernel.
- :class:`ShardedFeatureExecutor` — per-IMCU serving.
  :meth:`FeaturePlan.imcu_shards` of a packed plan yields one word-stream
  SLICE per IMCU (zero-copy at word-aligned boundaries, repacked at
  unaligned seams); each slice is resident on its own serve-pool device
  with its own CUDA stream, the ADV tables are held once per device, and
  arbitrary-row requests are routed to the shard that owns them. Hot
  shards gain replicas (read fan-out) and the open tail shard splits under
  streaming growth. Under ``hbm_budget_bytes`` only the shards that fit
  commit their words; a shard plan can drop to RLE runs on the host
  (:meth:`_PackedShardPlan.demote_cold`), and a lost device's streams are
  evicted and rebuilt elsewhere (``evict_device``, ``rebuild_on``).
- :class:`FeaturePipeline` — the facade over both.

Every launch goes through a hand-written CUDA kernel on a CUDA device; the
same entry points run the kernels' plain PyTorch versions when the plan's
device is the CPU. The device defaults to ``cuda`` and a plan refuses to
build when CUDA is unavailable unless the caller passes ``device="cpu"``.

Host->device bytes per batch row, by path (b = dictionary bits, db =
tpu_width(b) <= 2b, F = feature dim):

    ========================  =================================  ==========
    path                      bytes/row                          example*
    ========================  =================================  ==========
    recompute (Fig 1 CSV)     4 x F                              232
    int32 codes (packed=0)    4 x C                              16
    packed words (packed=1)   sum_c db_c / 8                     3.25
    packed + device-resident  ~0 (words moved once, amortized)   ~0
    ========================  =================================  ==========

    *4-column mixed-cardinality serve workload (db = 8,8,8,2; F = 58).
"""
from __future__ import annotations

import bisect
import functools
import itertools
from collections import deque
from dataclasses import dataclass, replace
from typing import Iterator, Mapping

import numpy as np
import torch

from repro_torch.columnar import query as colquery
from repro_torch.columnar.bitpack import (bits_needed, pack_bits,
                                          packed_gather, packed_nbytes,
                                          unpack_bits)
from repro_torch.columnar.dictionary import Dictionary
from repro_torch.columnar.rle import rle_decode, rle_encode, rle_nbytes
from repro_torch.columnar.table import Table
from repro_torch.core.adv import AugmentedDictionary
from repro_torch.core.feature_spec import FeatureSet
from repro_torch.distributed.sharding import (DeviceBudget,
                                              canonical_device,
                                              replica_device, serve_devices,
                                              serve_mesh, surviving_devices)
from repro_torch.kernels.adv_gather import ops as adv_ops
from repro_torch.kernels.bitunpack.kernel import tpu_width
from repro_torch.kernels.predicate_scan import ops as scan_ops


def _pad32(n: int) -> int:
    """Round up to the word-alignment quantum: a row index that is a
    multiple of 32 is word-aligned at EVERY divisor width (32/db | 32)."""
    return ((max(n, 1) + 31) // 32) * 32


def _agg_from_counts(d: Dictionary, counts: np.ndarray, agg: str) -> float:
    """Dict-aware aggregate tail: a masked per-code histogram + the K
    dictionary values give count/sum/mean without touching any row."""
    counts = np.asarray(counts, np.float64)
    n = float(counts.sum())
    if agg == "count":
        return n
    if not d.is_numeric():
        raise TypeError(f"{agg} requires a numeric dictionary "
                        f"(column {d.name!r} is {d.values.dtype})")
    s = float(np.dot(d.values.astype(np.float64), counts))
    if agg == "sum":
        return s
    if agg == "mean":
        return s / n if n else float("nan")
    raise ValueError(f"unknown agg {agg!r}")


def resolve_device(device=None) -> torch.device:
    """The plan's device: ``cuda`` unless the caller names another. CUDA
    that is asked for but missing is an error, never a quiet CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions of the kernels")
    return device


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. CUDA copies are staged in pinned
    memory and issued asynchronously on the current stream (the caching
    host allocator keeps the staging buffer alive until the copy ran)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_rows_edge(rows: np.ndarray, to: int) -> np.ndarray:
    """Right-pad a row-index vector to a static shape by repeating the last
    row — always a valid index; callers slice the padded outputs off. The
    ONE encoding of the pad-to-static-bucket contract on the host side."""
    pad = to - rows.shape[0]
    if pad <= 0:
        return rows
    return np.concatenate([rows, np.full(pad, rows[-1], dtype=rows.dtype)])


class _ShardStats(dict):
    """Per-shard stats that roll every numeric delta up into the parent:
    ``shard.stats['words_put'] += 1`` bumps the shard's own counter AND the
    plan total, so the parent's numbers mean 'whole plan' while each
    shard's dict says which shard did it."""

    def __init__(self, parent: dict, init: Mapping | None = None):
        super().__init__(init or {})
        self._parent = parent

    def __setitem__(self, key, value):
        old = self.get(key, 0)
        if isinstance(value, (int, float)) and isinstance(old, (int, float)):
            self._parent[key] = self._parent.get(key, 0) + (value - old)
        super().__setitem__(key, value)


def _shard_stats(parent: dict) -> _ShardStats:
    return _ShardStats(parent, {k: 0 for k, v in parent.items()
                                if isinstance(v, (int, float))})


@dataclass
class ColumnPlan:
    """One column's compiled gather plan."""
    column: str
    adv_names: list[str]
    fused_host: np.ndarray        # (K, F_col) host copy of the ADV tables
    bits: int
    aug_version: int              # AugmentedDictionary.version at build time

    @property
    def out_dim(self) -> int:
        return int(self.fused_host.shape[1])

    @property
    def cardinality(self) -> int:
        return int(self.fused_host.shape[0])


def _new_stats() -> dict:
    return {"tables_refreshed": 0, "fused_rebuilds": 0, "words_repacked": 0,
            "words_put": 0, "rle_encoded": 0, "rehydrated": 0}


class FeaturePlan:
    """Compile-time artifact: device-resident ADV tables + host code layout."""

    def __init__(self, table: Table, features: FeatureSet,
                 augmented: dict[str, AugmentedDictionary] | None = None,
                 packed: bool = False, device=None):
        self.device = resolve_device(device)
        self.table = table
        self.features = features
        self.augmented = augmented if augmented is not None \
            else features.build(table)
        self.packed = packed
        self.dictionaries = None       # reference plans only: see augmented
        self.stats = _new_stats()
        self.plans: list[ColumnPlan] = []
        for column, aug in self.augmented.items():
            names = [s.adv_name for s in features.specs if s.column == column]
            self.plans.append(self._compile_column(column, aug, names))
        if packed:
            # packed fast path: per-column device-width word streams from the
            # Column/IMCU device views — the (C, N) int32 matrix never exists
            self._codes_matrix = None
            self._n_rows = table.n_rows
            self.packed_words: list[np.ndarray] = []
            self.device_bits: list[int] = []
            # packed_versions bumps on ANY stream change (repack or append);
            # packed_layout_versions only on a width-boundary repack.
            # Executors key their resident-stream sync on these: an append
            # rewrites the tail, so only the open-ended last IMCU shard (and
            # the parent) re-sync for it
            self.packed_versions: list[int] = []
            self.packed_layout_versions: list[int] = []
            for p in self.plans:
                words, db = table[p.column].device_words()
                self.packed_words.append(words)
                self.device_bits.append(db)
                self.packed_versions.append(0)
                self.packed_layout_versions.append(0)
        else:
            codes = [table[p.column].codes() for p in self.plans]
            # (C, N): one row-aligned int32 code stream per planned column —
            # a batch slice is ONE fancy-index + ONE host->device transfer
            self._codes_matrix = (np.stack(codes) if codes
                                  else np.zeros((0, table.n_rows), np.int32))
        # one-slot box, so IMCU shard views share (and co-invalidate) the
        # resident ADV tables with their parent
        self._fused_box: dict[str, adv_ops.FusedTables | None] = {"t": None}

    @staticmethod
    def _compile_column(column: str, aug: AugmentedDictionary,
                        names: list[str]) -> ColumnPlan:
        return ColumnPlan(column=column, adv_names=names,
                          fused_host=aug.fused_table(names),
                          bits=aug.dictionary.bits, aug_version=aug.version)

    # -- shape info -------------------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return [p.column for p in self.plans]

    @property
    def codes_matrix(self) -> np.ndarray:
        if self.packed:
            raise RuntimeError(
                "packed plan never materializes the int32 code matrix — "
                "use packed_words / host_codes()")
        return self._codes_matrix

    @property
    def n_rows(self) -> int:
        return self._n_rows if self.packed else int(self._codes_matrix.shape[1])

    @property
    def out_dim(self) -> int:
        return sum(p.out_dim for p in self.plans)

    # -- host-side code access ---------------------------------------------------
    def host_codes(self, rows: np.ndarray) -> np.ndarray:
        """(C, len(rows)) int32 codes for arbitrary rows.

        int32 plans: one fancy-index on the stacked matrix. Packed plans:
        per-column word gather — touches O(len(rows)) uint32 words and never
        unpacks the stream.
        """
        if not self.packed:
            return np.ascontiguousarray(self._codes_matrix[:, rows])
        rows = np.asarray(rows)
        out = np.empty((len(self.plans), rows.shape[0]), np.int32)
        for i, (w, db) in enumerate(zip(self.packed_words, self.device_bits)):
            out[i] = packed_gather(w, db, rows)
        return out

    def host_features(self, rows: np.ndarray) -> np.ndarray:
        """(len(rows), F) features computed ENTIRELY on the host with numpy:
        codes from the host layout, then the host fused ADV tables with the
        device paths' OOB clamp — the reference a device launch over the
        same plan state must equal bit for bit."""
        rows = np.asarray(rows)
        if not self.plans:
            return np.zeros((rows.shape[0], 0), np.float32)
        codes = self.host_codes(rows)
        outs = [p.fused_host[np.clip(codes[i], 0,
                                     p.fused_host.shape[0] - 1)]
                for i, p in enumerate(self.plans)]
        return np.concatenate(outs, axis=-1)

    # -- resident ADV tables -----------------------------------------------------
    def fused_tables(self) -> adv_ops.FusedTables:
        """Every column's ADV tables, resident back to back on the device;
        rebuilt lazily after a refresh changed any of them."""
        if self._fused_box["t"] is None:
            self._fused_box["t"] = adv_ops.fuse_tables(
                [p.fused_host for p in self.plans], self.device)
            self.stats["fused_rebuilds"] += 1
        return self._fused_box["t"]

    # -- maintenance (§6.3: streaming inserts) -----------------------------------
    def refresh(self, new_codes: Mapping[str, np.ndarray] | None = None) -> int:
        """Incremental plan refresh after ``Dictionary.add_rows``.

        Re-derives ADVs for grown dictionaries (``extend_for_new_codes``) and
        recompiles ONLY columns whose AugmentedDictionary changed since
        compile. ``new_codes`` optionally appends freshly inserted rows
        (codes from ``add_rows``) to the plan's code layout; it must cover
        every planned column with equal lengths. Packed plans repack a
        column's word stream only when its dictionary grew across a device
        width boundary, and append new rows by rewriting at most one partial
        tail word. Returns the number of columns refreshed.
        """
        if self.augmented is None:
            raise RuntimeError("a plan built from reference state has no "
                               "ADVs to refresh")
        fresh = None
        if new_codes is not None:          # validate BEFORE mutating anything
            missing = [c for c in self.columns if c not in new_codes]
            if missing:
                raise KeyError(f"new_codes missing columns {missing}")
            fresh = np.stack([np.asarray(new_codes[c], np.int32).reshape(-1)
                              for c in self.columns])
        refreshed = 0
        for i, p in enumerate(self.plans):
            aug = self.augmented[p.column]
            aug.extend_for_new_codes()
            if aug.version == p.aug_version:
                continue
            self.plans[i] = self._compile_column(p.column, aug, p.adv_names)
            self.stats["tables_refreshed"] += 1
            refreshed += 1
        if refreshed:
            self._fused_box["t"] = None    # every shard view rebuilds lazily
        if self.packed:
            for i, p in enumerate(self.plans):
                db = tpu_width(p.bits)
                if db != self.device_bits[i]:   # grew across a width boundary
                    codes = unpack_bits(self.packed_words[i],
                                        self.device_bits[i], self._n_rows)
                    self.packed_words[i] = pack_bits(codes, db)
                    self.device_bits[i] = db
                    self.packed_versions[i] += 1
                    self.packed_layout_versions[i] += 1
                    self.stats["words_repacked"] += 1
            if fresh is not None:
                for i in range(len(self.plans)):
                    self._append_packed(i, fresh[i])
                self._n_rows += fresh.shape[1]
        elif fresh is not None:
            self._codes_matrix = np.concatenate(
                [self._codes_matrix, fresh], axis=1)
        return refreshed

    def _append_packed(self, i: int, codes: np.ndarray) -> None:
        """Append rows to column i's word stream, rewriting at most the one
        partial tail word (fields at divisor widths never straddle words)."""
        db = self.device_bits[i]
        s = 32 // db
        words = self.packed_words[i]
        tail = self._n_rows % s
        if tail:
            codes = np.concatenate([unpack_bits(words[-1:], db, tail), codes])
            words = words[:-1]
        self.packed_words[i] = np.concatenate([words, pack_bits(codes, db)])
        self.packed_versions[i] += 1

    # -- partitioning (per-IMCU shard plans) --------------------------------------
    def imcu_shards(self) -> list["FeaturePlan"]:
        """One plan per IMCU partition, sharing this plan's ADV tables.

        int32 plans: shard k's code matrix is a zero-copy view of this
        plan's matrix over the IMCU's rows. Packed plans: shard k carries
        its own per-column word-stream slice (:class:`_PackedShardPlan`),
        zero-copy where the IMCU boundary is word-aligned at the column's
        device width and repacked once per refresh generation at unaligned
        seams, so a sharded executor keeps each slice resident on its own.
        The LAST shard is open-ended: rows appended by :meth:`refresh`
        extend it. The resident ADV tables are shared and co-invalidated,
        never put again, and every shard gets its own stats dict whose
        counts roll up into this plan's (``stats['per_shard']``)."""
        bounds = self.imcu_bounds()
        shard_stats = [_shard_stats(self.stats) for _ in bounds]
        self.stats["per_shard"] = shard_stats
        if self.packed:
            return [_PackedShardPlan(self, start, stop, st,
                                     last=(i == len(bounds) - 1))
                    for i, ((start, stop), st) in
                    enumerate(zip(bounds, shard_stats))]
        shards = []
        for (start, stop), st in zip(bounds, shard_stats):
            shard = FeaturePlan.__new__(FeaturePlan)
            shard.device = self.device
            shard.table = self.table
            shard.features = self.features
            shard.augmented = self.augmented
            shard.dictionaries = self.dictionaries
            shard.packed = False
            shard.stats = st                       # rolls up into self.stats
            shard.plans = self.plans               # shared ADV tables
            shard._codes_matrix = self._codes_matrix[:, start:stop]
            shard._fused_box = self._fused_box     # shared, co-invalidated
            shards.append(shard)
        return shards

    def imcu_bounds(self) -> list[tuple[int, int]]:
        """[start, stop) rows of each IMCU of the plan's first column."""
        if not self.plans:
            raise ValueError("plan has no feature columns to partition")
        if self.table is None:
            raise ValueError("a plan built from reference state has no "
                             "IMCU bounds")
        return self.table[self.plans[0].column].imcu_bounds()

    # -- adaptive re-shard (tail split under streaming growth) --------------------
    def split_tail_shard(self, tail: "_PackedShardPlan", cut: int,
                         close: bool = True) -> "_PackedShardPlan":
        """Split the open tail shard at parent row ``cut``; return the NEW
        open tail shard over [cut, n_rows).

        Appends extend the last shard only, so once it outgrows its row
        budget the tail splits: the new shard's slice is zero-copy where
        ``cut`` is word-aligned at a column's device width (``cut % 32 ==
        0`` aligns at every width) and repacked at the seam otherwise. The
        new shard's rolled-up stats dict is APPENDED to
        ``stats['per_shard']`` (existing shard indices never move).
        ``close=False`` leaves the old tail open, so a caller can swap its
        routing first and close after (:meth:`_PackedShardPlan.close_at`);
        until then both views serve [cut, n_rows) from the same words."""
        if not self.packed:
            raise RuntimeError("tail re-shard applies to packed plans only")
        if not isinstance(tail, _PackedShardPlan) or tail._parent is not self:
            raise ValueError("tail is not a shard view of this plan")
        if not tail._last:
            raise ValueError("only the open tail shard can split")
        start, stop = tail.shard_bounds
        if not start < cut <= stop:
            raise ValueError(f"cut {cut} outside open tail ({start}, {stop}]")
        st = _shard_stats(self.stats)
        new = _PackedShardPlan(self, cut, stop, st, last=True)
        self.stats.setdefault("per_shard", []).append(st)
        if close:
            tail.close_at(cut)
        return new

    # -- data-movement accounting (paper's central claim) --------------------------
    def bytes_moved_adv(self, batch_rows: int) -> int:
        """Host->device bytes per batch on the ADV path, for THIS plan's
        layout: device-width packed words (``packed=True``) vs 4-byte int32
        codes. The K-row tables are resident either way, and a packed
        executor additionally keeps the word streams device-resident."""
        if self.packed:
            return sum(packed_nbytes(batch_rows, db)
                       for db in self.device_bits)
        return 4 * batch_rows * len(self.plans)

    def bytes_moved_recompute(self, batch_rows: int) -> int:
        """Traditional path ships row-space f32 features."""
        return 4 * batch_rows * self.out_dim

    def bytes_resident_tables(self) -> int:
        return sum(int(p.fused_host.size) * 4 for p in self.plans)

    def bytes_resident_codes(self) -> int:
        """Host bytes held by the code layout (the duplication the packed
        path avoids: 32/db x smaller than the int32 matrix)."""
        if self.packed:
            return sum(int(w.nbytes) for w in self.packed_words)
        return int(self._codes_matrix.nbytes)


def plan_from_reference(state: Mapping, device=None) -> FeaturePlan:
    """A packed plan over another implementation's plan state, as numpy.

    ``state`` holds ``columns`` (names), ``n_rows``, and per column
    ``packed_words`` (uint32 device-width streams), ``device_bits``,
    ``fused_host`` ((K_c, F_c) float32 tables) and ``cards`` (K_c). Serving
    from it reproduces exactly that state — the counterpart of loading a
    model's weights. An optional ``dictionaries`` entry holds, for every
    column, a mapping with the dictionary's ``values`` in code order and
    whether they are ``sorted``; the plan builds its own
    :class:`Dictionary` objects from it (counts taken from the carried
    codes), which predicate pushdown compiles predicates over. Without it
    the plan serves features but refuses pushdown. It has no ADVs, so it
    cannot refresh.
    """
    columns = list(state["columns"])
    words = [np.asarray(w, np.uint32) for w in state["packed_words"]]
    dbs = [int(db) for db in state["device_bits"]]
    tables = [np.asarray(t, np.float32) for t in state["fused_host"]]
    cards = [int(k) for k in state["cards"]]
    n_rows = int(state["n_rows"])
    if not len(columns) == len(words) == len(dbs) == len(tables) \
            == len(cards):
        raise ValueError("reference state needs one entry per column")
    for c, w, db, t, k in zip(columns, words, dbs, tables, cards):
        if db != tpu_width(db):
            raise ValueError(f"column {c}: device width {db} does not "
                             "divide 32")
        if t.ndim != 2 or t.shape[0] != k:
            raise ValueError(f"column {c}: table shape {t.shape} does not "
                             f"match cardinality {k}")
        if w.shape[0] * (32 // db) < n_rows:
            raise ValueError(f"column {c}: {w.shape[0]} words hold fewer "
                             f"than {n_rows} rows")
    dicts = state.get("dictionaries")
    if dicts is not None:
        if len(dicts) != len(columns) or not all(
                isinstance(d, Mapping) and {"values", "sorted"} <= d.keys()
                for d in dicts):
            raise ValueError("reference state needs one {values, sorted} "
                             "dictionary mapping per column")
        dicts = {c: _reference_dictionary(c, d, k, w, db, n_rows)
                 for c, d, k, w, db in zip(columns, dicts, cards, words, dbs)}
    plan = FeaturePlan.__new__(FeaturePlan)
    plan.device = resolve_device(device)
    plan.table = plan.features = plan.augmented = None
    plan.dictionaries = dicts
    plan.packed = True
    plan.stats = _new_stats()
    plan.plans = [ColumnPlan(column=c, adv_names=[], fused_host=t,
                             bits=bits_needed(k), aug_version=0)
                  for c, t, k in zip(columns, tables, cards)]
    plan._codes_matrix = None
    plan._n_rows = n_rows
    plan.packed_words = words
    plan.device_bits = dbs
    plan.packed_versions = [0] * len(columns)
    plan.packed_layout_versions = [0] * len(columns)
    plan._fused_box = {"t": None}
    return plan


def _reference_dictionary(column: str, entry: Mapping, k: int,
                          words: np.ndarray, db: int,
                          n_rows: int) -> Dictionary:
    """A column's :class:`Dictionary` from reference state: its values in
    code order and whether codes follow value order; the per-code counts
    are those of the carried code stream."""
    values = np.asarray(entry["values"])
    if values.ndim != 1 or values.shape[0] != k:
        raise ValueError(f"column {column}: {values.shape} dictionary "
                         f"values for cardinality {k}")
    counts = np.bincount(unpack_bits(words, db, n_rows), minlength=k)
    return Dictionary(values=values, counts=counts, name=column,
                      sorted_codes=bool(entry["sorted"]))


class _PackedShardPlan(FeaturePlan):
    """One IMCU partition of a packed plan: a per-column word-stream slice.

    Shares the parent's dictionaries, ADVs and resident ADV tables (one
    box, co-invalidated on refresh); what is partitioned is exactly the
    word streams. Column i's slice is zero-copy when the partition starts
    word-aligned at the column's device width (``start % (32 / db) == 0``,
    always true for the default 2**19-row IMCUs); an unaligned seam
    repacks just this shard's rows, once per parent refresh generation.
    ``last=True`` marks the open-ended tail shard: rows appended by the
    parent's :meth:`FeaturePlan.refresh` extend it. Refresh always goes
    through the parent, where the words, dictionaries and versions live.

    The cold residency tier (:meth:`demote_cold`) keeps a closed shard as
    RLE runs of its codes and no packed copy; :meth:`rehydrate` packs the
    runs again.
    """

    def __init__(self, parent: FeaturePlan, start: int, stop: int,
                 stats: _ShardStats, last: bool = False):
        # deliberately NOT calling FeaturePlan.__init__: every layout
        # artifact derives from the parent
        self._parent = parent
        self._start = start
        self._stop = stop
        self._last = last
        self.packed = True
        self.device = parent.device
        self.table = parent.table
        self.features = parent.features
        self.augmented = parent.augmented
        self.dictionaries = parent.dictionaries
        self.plans = parent.plans               # shared ADV tables
        self._fused_box = parent._fused_box     # shared, co-invalidated
        self._codes_matrix = None
        self.stats = stats                      # rolls up into the parent
        self._words_cache: dict[int, tuple[int, np.ndarray]] = {}
        # cold tier: column -> (run values, run lengths, cumulative ends);
        # while set, the shard holds no packed copy of its own
        self._rle: dict[int, tuple[np.ndarray, np.ndarray,
                                   np.ndarray]] | None = None

    @property
    def shard_bounds(self) -> tuple[int, int]:
        """[start, stop) in parent rows (stop follows appends when last)."""
        stop = self._parent.n_rows if self._last else self._stop
        return self._start, max(stop, self._start)

    @property
    def _n_rows(self) -> int:                   # FeaturePlan.n_rows reads it
        start, stop = self.shard_bounds
        return stop - start

    @property
    def device_bits(self) -> list[int]:
        return self._parent.device_bits

    @property
    def packed_versions(self) -> list[int]:
        # executors key their resident-stream sync on these: a width
        # repack changes every shard's slice (layout version), an append
        # only rewrites the open tail, so interior shards keep their
        # resident streams through streaming inserts
        if self._last:
            return self._parent.packed_versions
        return self._parent.packed_layout_versions

    @property
    def packed_words(self) -> list[np.ndarray]:
        return [self._shard_words(i) for i in range(len(self.plans))]

    def _shard_words(self, i: int) -> np.ndarray:
        if self._rle is not None:
            # cold: pack column i from its runs at the CURRENT width (codes
            # of existing rows never change, so the runs outlive a width
            # repack); uncached, rehydrate() is the bulk path
            values, lengths, _ = self._rle[i]
            return pack_bits(rle_decode(values, lengths),
                             self._parent.device_bits[i])
        parent = self._parent
        version = self.packed_versions[i]
        hit = self._words_cache.get(i)
        if hit is not None and hit[0] == version:
            return hit[1]
        db = parent.device_bits[i]
        s = 32 // db
        start, stop = self.shard_bounds
        if start % s == 0:                      # word-aligned boundary
            words = parent.packed_words[i][start // s:(stop + s - 1) // s]
        else:                                   # seam: repack this shard only
            codes = packed_gather(parent.packed_words[i], db,
                                  np.arange(start, stop))
            words = pack_bits(codes, db)
            self.stats["words_repacked"] += 1
        self._words_cache[i] = (version, words)
        return words

    def refresh(self, new_codes=None) -> int:
        raise RuntimeError("shard plans are views — refresh the parent "
                           "FeaturePlan; every shard re-syncs by itself")

    # -- the cold residency tier: RLE runs, no packed copy -----------------------
    @property
    def is_cold(self) -> bool:
        return self._rle is not None

    def demote_cold(self) -> int:
        """Hold this CLOSED shard as RLE runs of every column's codes and
        drop its packed slice; returns the run bytes. The runs stay right
        because codes of existing rows never change (dictionaries only
        grow). The open tail is refused: appends would stale the runs."""
        if self._last:
            raise ValueError("the open tail shard cannot go cold: streaming "
                             "appends extend it and would stale the runs")
        if self._rle is not None:
            return self.rle_bytes()
        runs = {}
        for i in range(len(self.plans)):
            codes = unpack_bits(self._shard_words(i),
                                self._parent.device_bits[i], self._n_rows)
            values, lengths = rle_encode(codes)
            runs[i] = (values, lengths, np.cumsum(lengths))
        self._rle = runs
        self._words_cache.clear()               # the packed copy is dropped
        self.stats["rle_encoded"] += 1
        return self.rle_bytes()

    def rehydrate(self) -> None:
        """Leave the cold tier: decode every column's runs and pack them at
        the CURRENT device width into the slice cache, so the executor's
        next version-keyed put finds the words ready."""
        if self._rle is None:
            return
        for i in range(len(self.plans)):
            values, lengths, _ = self._rle[i]
            words = pack_bits(rle_decode(values, lengths),
                              self._parent.device_bits[i])
            self._words_cache[i] = (self.packed_versions[i], words)
        self._rle = None
        self.stats["rehydrated"] += 1

    def rle_bytes(self) -> int:
        """Host bytes of the cold runs (0 when not cold)."""
        if self._rle is None:
            return 0
        return sum(rle_nbytes(v, n, self._parent.device_bits[i])
                   for i, (v, n, _) in self._rle.items())

    def host_codes(self, rows: np.ndarray) -> np.ndarray:
        """A cold shard gathers codes from its runs: one ``searchsorted``
        per column against the cumulative run ends, no packed or decoded
        stream built. Otherwise the packed-word gather."""
        if self._rle is None:
            return super().host_codes(rows)
        rows = np.asarray(rows)
        out = np.empty((len(self.plans), rows.shape[0]), np.int32)
        for i, (values, _, ends) in self._rle.items():
            run = np.searchsorted(ends, rows, side="right")
            out[i] = values[np.minimum(run, values.size - 1)]
        return out

    def close_at(self, cut: int) -> None:
        """Close this open tail shard at parent row ``cut``: it becomes an
        interior shard over [start, cut). The second half of
        :meth:`FeaturePlan.split_tail_shard`, for callers that swap
        routing first. The slice cache drops: the version source switches
        from packed to layout versions, and an equal number must not
        revive a slice with the old open-ended bounds."""
        if not self._last:
            raise ValueError("only the open tail shard can close")
        start, stop = self.shard_bounds
        if not start < cut <= stop:
            raise ValueError(f"cut {cut} outside open tail ({start}, {stop}]")
        self._stop = cut
        self._last = False
        self._words_cache.clear()


def _place_fused(fused: adv_ops.FusedTables,
                 device: torch.device) -> adv_ops.FusedTables:
    """A copy of ``fused`` on another device."""
    return replace(fused, tables=fused.tables.to(device),
                   meta=fused.meta.to(device),
                   col_of=fused.col_of.to(device),
                   jmeta=fused.jmeta.to(device))


class _DeviceTableCache:
    """The ADV tables as placed on one device. Executors on the same
    device share one of these (:class:`ShardedFeatureExecutor` keeps one
    per device), so the tables exist once per device, never once per
    shard. On the plan's own device the placed tables ARE the plan's."""

    def __init__(self):
        self.fused_src: adv_ops.FusedTables | None = None
        self.fused: adv_ops.FusedTables | None = None


# process-unique launch-stream identity (FeatureExecutor.stream_token):
# unlike id(executor), a token is never reused after an executor is dropped,
# so health state keyed on it can never alias onto a NEW stream
_STREAM_TOKENS = itertools.count()


def _on_stream(fn):
    """Run an executor method on the executor's own CUDA stream.

    Executors without a stream of their own (``stream is None``: the CPU,
    and executors built without ``own_stream``) run on the caller's
    current stream, as before. Otherwise the executor's stream first waits
    for the caller's current stream (inputs the caller queued there), the
    body runs on it, and the caller's stream then waits for it; tensors
    returned to the caller are recorded on the caller's stream, so the
    caching allocator cannot reuse them while the caller reads them. A
    call already on the executor's stream (the serving pump) runs as is.
    """
    @functools.wraps(fn)
    def run(self, *args, **kw):
        s = self.stream
        if s is None:
            return fn(self, *args, **kw)
        cur = torch.cuda.current_stream(self.device)
        if cur == s:
            return fn(self, *args, **kw)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = fn(self, *args, **kw)
        cur.wait_stream(s)
        for t in (out if isinstance(out, tuple) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(cur)
        return out
    return run


class FeatureExecutor:
    """Run-time half: resident word stream, kernel launches, and the
    ``prefetch``-deep batch iterator.

    The fused ADV tables are read from the plan at every launch, so a
    :meth:`FeaturePlan.refresh` flows into the next launch. Packed plans
    additionally keep the word streams device-resident (re-put when a
    refresh bumps a column's version) and serve word-aligned ranges via
    :meth:`batch_range` with no per-batch host->device code traffic, and
    ARBITRARY rows via :meth:`_rows_future`: the kernel computes word index
    + bit offset against the resident stream, so the only per-call traffic
    is the 4B x N index vector, independent of column count.

    Placement (the sharded-serving building block, one executor per IMCU
    shard or replica): ``device`` commits the resident words and launches
    to a device other than the plan's (default: the plan's);
    ``table_cache`` shares the placed ADV tables between executors on one
    device; ``commit=False`` defers the word-stream put to the first
    launch. ``own_stream=True`` gives a CUDA executor a ``torch.cuda.Stream``
    of its own: every put, launch and copy it makes runs there
    (:func:`_on_stream`), and ``stream`` is None otherwise (the caller's
    current stream). ``stream_token`` names the launch stream for health
    state, unique for the process's lifetime.
    """

    def __init__(self, plan: FeaturePlan, prefetch: int = 2, device=None,
                 table_cache: _DeviceTableCache | None = None,
                 commit: bool = True, own_stream: bool = False):
        if prefetch < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.plan = plan
        self.prefetch = prefetch
        self.packed = plan.packed
        self.device = plan.device if device is None else torch.device(device)
        self.stream_token = next(_STREAM_TOKENS)
        self.stream = (torch.cuda.Stream(self.device)
                       if own_stream and self.device.type == "cuda" else None)
        self._tcache = table_cache if table_cache is not None \
            else _DeviceTableCache()
        self._fused_seen: adv_ops.FusedTables | None = None
        # compiled-predicate cache: a deployed filter family scans on every
        # request, so the code-set compile and the device put of the term
        # table must not repeat per call (keyed also by the dictionaries'
        # cardinalities: appends that grow a dictionary can change what a
        # value predicate matches)
        self._pred_cache: dict = {}
        if self.packed:
            # ONE flat device-resident stream holds every column's words
            # (column c's start in row c of _wmeta, beside its width; the
            # starts also on the host in _word_offs)
            self._flat_words: torch.Tensor | None = None
            self._wmeta: torch.Tensor | None = None
            self._word_offs: tuple[int, ...] = ()
            self._words_sig: tuple | None = None
            self._capacity = 0
            if commit:
                self.ensure_range_capacity(plan.n_rows)
        self._device_fused()           # resident before the first launch

    def _device_fused(self) -> adv_ops.FusedTables:
        """The plan's ADV tables on this executor's device: the plan's own
        on the plan's device, else one copy per device (the table cache),
        placed again only after a refresh rebuilt them.

        The tables are written synchronously (a pageable copy), so any
        stream may read them once they exist; but they are freed when a
        refresh replaces them, so an executor with its own stream records
        them on it the first time it sees them, and the caching allocator
        holds their memory until that stream's work on them is done."""
        fused = self.plan.fused_tables()
        tc = self._tcache
        if tc.fused_src is not fused:
            same = canonical_device(self.device) == \
                canonical_device(self.plan.device)
            tc.fused = fused if same else _place_fused(fused, self.device)
            tc.fused_src = fused
        placed = tc.fused
        if self.stream is not None and self._fused_seen is not placed:
            for t in (placed.tables, placed.meta, placed.col_of,
                      placed.jmeta):
                t.record_stream(self.stream)
            self._fused_seen = placed
        return placed

    @_on_stream
    def gather_device(self, dev_codes: torch.Tensor) -> torch.Tensor:
        """(C, B) int32 device codes -> (B, out_dim) concatenated features."""
        return adv_ops.gather_fused_parts(self._device_fused(), dev_codes)

    # -- packed fast path: device-resident words, range batches -------------------
    @_on_stream
    def ensure_range_capacity(self, limit: int) -> None:
        """Grow the device word stream to cover rows [0, pad32(limit)).

        Padding words are zeros -> code 0 (a valid row of every table); any
        features gathered past the real row count are sliced off by callers.
        """
        if not self.packed:
            raise RuntimeError("range capacity applies to packed plans only")
        self._capacity = max(self._capacity, _pad32(limit))
        self._sync_device_words()

    def _sync_device_words(self) -> None:
        """Re-put the flat resident stream when any column's words moved.

        One concatenated buffer holds every column at the current capacity,
        so a refresh that touches any column re-puts the whole stream —
        word streams are 32/db x smaller than the codes they encode, and
        one copy keeps device residency at exactly the stream bytes. The
        put runs on this executor's stream (callers hold it), so its
        launches are ordered behind the put, and the old stream, read only
        there, is reused only after them.
        """
        plan = self.plan
        sig = (tuple(plan.packed_versions), tuple(plan.device_bits),
               self._capacity)
        if self._words_sig == sig:
            return
        parts, offs, off = [], [], 0
        for i in range(len(plan.plans)):
            need = self._capacity * plan.device_bits[i] // 32
            w = plan.packed_words[i]
            if w.shape[0] < need:
                w = np.concatenate([w, np.zeros(need - w.shape[0],
                                                np.uint32)])
            else:
                w = w[:need]
            parts.append(w)
            offs.append(off)
            off += need
        flat = (np.concatenate(parts) if parts else np.zeros(0, np.uint32))
        self._flat_words = to_device(flat.view(np.int32), self.device)
        self._wmeta = adv_ops.word_meta(offs, plan.device_bits, self.device)
        self._word_offs = tuple(offs)
        self._words_sig = sig
        plan.stats["words_put"] += 1

    def resident_bytes(self) -> int:
        """Device bytes currently held by the resident word stream."""
        if not self.packed or self._flat_words is None:
            return 0
        return int(self._flat_words.numel()) * 4

    def stream_nbytes(self) -> int:
        """Device bytes of a FULL commit at the current capacity (what a
        promotion would charge), whether or not the words are resident."""
        if not self.packed:
            return 0
        plan = self.plan
        cap = max(self._capacity, _pad32(plan.n_rows))
        return sum(cap * db // 32 * 4 for db in plan.device_bits)

    def evict_words(self) -> int:
        """Release the resident word stream; returns the bytes freed. The
        tensor is dereferenced, not freed at once: it was put and read on
        this executor's stream only, so the caching allocator hands its
        memory out again only to later work on that stream. Any later
        launch re-puts it through the version-keyed sync."""
        freed = self.resident_bytes()
        self._flat_words = None
        self._wmeta = None
        self._words_sig = None
        return freed

    def _starts_tensor(self, starts: np.ndarray) -> torch.Tensor:
        return to_device(np.asarray(starts, np.int32), self.device)

    @_on_stream
    def _range_future(self, start: int, batch: int) -> torch.Tensor:
        """Async gather of rows [start, start+batch) from resident words.

        Per-batch host->device traffic: ONE scalar (the start index).
        Returns the full (batch, out_dim) device buffer; callers slice the
        valid prefix when retiring.
        """
        if start % 32 or batch % 32:
            raise ValueError("packed ranges must be word-aligned "
                             f"(start % 32 == 0, batch % 32 == 0); got "
                             f"[{start}, {start + batch})")
        self.ensure_range_capacity(max(start + batch, self.plan.n_rows))
        return adv_ops.adv_gather_packed(
            self._flat_words, self._wmeta, self._device_fused(),
            self._starts_tensor(np.array([start])), batch)

    @_on_stream
    def _multi_range_future(self, starts, batch: int) -> torch.Tensor:
        """Async gather of K coalesced ranges -> (K, batch, out_dim) buffer.

        ONE kernel launch serves all K ranges; the only host->device traffic
        is the (K,) start-index vector.
        """
        starts = np.asarray(starts, np.int64).reshape(-1)
        if starts.size == 0:
            raise ValueError("need at least one range start")
        if batch % 32 or (starts % 32).any():
            raise ValueError("packed ranges must be word-aligned "
                             "(starts % 32 == 0, batch % 32 == 0)")
        if starts.min() < 0:
            raise IndexError("range starts must be >= 0")
        self.ensure_range_capacity(max(int(starts.max()) + batch,
                                       self.plan.n_rows))
        out = adv_ops.adv_gather_packed(
            self._flat_words, self._wmeta, self._device_fused(),
            self._starts_tensor(starts), batch)
        return out.reshape(starts.size, batch, -1)

    def batch_range(self, start: int, n: int) -> torch.Tensor:
        """Featurize the contiguous rows [start, start+n) (start % 32 == 0)
        without any host code work: unpack happens inside the gather."""
        return self._range_future(start, _pad32(n))[:n]

    # -- packed random-row path: indices in, features out -------------------------
    @_on_stream
    def _rows_future(self, rows) -> torch.Tensor:
        """Async indexed gather of arbitrary rows from the resident words.

        Per-call host->device traffic: the (N,) int32 index vector — 4B per
        row, independent of column count. The serving pump's unified launch:
        K coalesced bucket-padded row sets arrive here flattened.
        """
        if not self.packed:
            raise RuntimeError("indexed row gather applies to packed plans "
                               "only; int32 plans ship code slices")
        # the stream must cover every live row: refresh() appends can push
        # n_rows past the capacity the stream was last put at
        self.ensure_range_capacity(self.plan.n_rows)
        if isinstance(rows, torch.Tensor):
            dev_rows = rows.to(self.device, torch.int32)
        else:
            dev_rows = to_device(np.asarray(rows, np.int32).reshape(-1),
                                 self.device)
        return adv_ops.adv_gather_packed_rows(
            self._flat_words, self._wmeta, self._device_fused(), dev_rows)

    # -- predicate pushdown: scan -> compact -> gather on resident words ----------
    def _dictionary(self, column: str) -> Dictionary:
        """Column ``column``'s dictionary, for a plan built from a table (its
        ADVs' dictionaries) or from reference state (the dictionaries the
        state carried)."""
        plan = self.plan
        if column not in plan.columns:
            raise KeyError(f"column {column!r} not in plan ({plan.columns})")
        if plan.augmented is not None:
            return plan.augmented[column].dictionary
        d = (plan.dictionaries or {}).get(column)
        if d is None:
            raise RuntimeError(
                f"column {column!r} has no dictionary: this plan was built "
                "from reference state without 'dictionaries', and predicate "
                "pushdown compiles each predicate over the column "
                "dictionaries")
        return d

    def _scan_terms(self, pred) -> tuple[tuple, str]:
        """Compile a value-space predicate to device scan terms: each leaf
        runs once over its column's K dictionary entries, and column names
        resolve to this plan's resident stream slots."""
        if not self.packed:
            raise RuntimeError("predicate pushdown runs on packed plans "
                               "only; int32 plans filter host-side")
        cols = self.plan.columns
        cp = colquery.compile_predicate(
            pred, {c: self._dictionary(c) for c in cols})
        slot = {c: i for i, c in enumerate(cols)}
        terms = tuple(scan_ops.ScanTerm(col=slot[t.column], kind=t.kind,
                                        lo=t.lo, hi=t.hi, lut=t.lut)
                      for t in cp.terms)
        return terms, cp.combine

    def _compiled_pred(self, pred):
        """(terms, combine, packed device term table) for a predicate,
        cached. The key includes every dictionary's cardinality:
        dictionaries only ever grow, and a grown dictionary can change a
        value predicate's matching code set."""
        key = (pred, tuple(self._dictionary(c).cardinality
                           for c in self.plan.columns))
        hit = self._pred_cache.get(key)
        if hit is None:
            terms, combine = self._scan_terms(pred)
            packed = scan_ops.pack_terms(terms, self.plan.device_bits,
                                         self.device)
            hit = self._pred_cache[key] = (terms, combine, packed)
        return hit

    @_on_stream
    def _mask_count_future(self, pred) -> tuple[torch.Tensor, torch.Tensor]:
        """(mask, count) on the device from ONE scan launch over the
        resident stream, read in place: no code stream and no per-query
        copy of the used columns exists anywhere."""
        _, combine, packed = self._compiled_pred(pred)
        self.ensure_range_capacity(self.plan.n_rows)
        return scan_ops.predicate_scan(self._flat_words, self._wmeta, packed,
                                       self.plan.n_rows, combine)

    @_on_stream
    def predicate_mask(self, pred) -> torch.Tensor:
        """(n_rows,) bool device mask for a value-space predicate."""
        return self._mask_count_future(pred)[0]

    @_on_stream
    def count_where(self, pred) -> int:
        """SELECT COUNT(*) WHERE pred — one scan launch, one scalar sync."""
        return int(self._mask_count_future(pred)[1])

    @_on_stream
    def filtered_rows(self, pred) -> np.ndarray:
        """Matching row indices (ascending int64), compacted on the
        device."""
        mask, cnt_dev = self._mask_count_future(pred)
        cnt = int(cnt_dev)             # one scalar sync: the static length
        if cnt == 0:
            return np.zeros(0, np.int64)
        rows = scan_ops.compact_rows(mask, _pad32(cnt))
        return rows[:cnt].cpu().numpy().astype(np.int64)

    @_on_stream
    def batch_where(self, pred) -> tuple[np.ndarray, torch.Tensor]:
        """Filtered featurization: scan -> compact -> rows gather, all
        against the resident stream. Returns (rows, features) for the
        matching rows in ascending row order. The ONE host sync before the
        gather is the match count (the compaction's static length); the
        compacted index vector feeds the gather without visiting the
        host."""
        mask, cnt_dev = self._mask_count_future(pred)
        cnt = int(cnt_dev)
        if cnt == 0:
            return (np.zeros(0, np.int64),
                    torch.zeros((0, self.plan.out_dim), dtype=torch.float32,
                                device=self.device))
        rows_dev = scan_ops.compact_rows(mask, _pad32(cnt))
        feats = self._rows_future(rows_dev)     # device-to-device indices
        return rows_dev[:cnt].cpu().numpy().astype(np.int64), feats[:cnt]

    @_on_stream
    def _masked_counts_from(self, column: str,
                            mask: torch.Tensor) -> torch.Tensor:
        """(K,) per-code counts of ``column`` under a device mask."""
        d = self._dictionary(column)
        ci = self.plan.columns.index(column)
        return scan_ops.masked_counts(
            self._flat_words, self._word_offs[ci], self.plan.device_bits[ci],
            mask, d.cardinality, self.plan.n_rows)

    @_on_stream
    def groupby_where(self, column: str,
                      pred) -> tuple[np.ndarray, np.ndarray]:
        """GROUP BY column COUNT(*) WHERE pred — masked histogram over the
        resident words; returns (values, counts) like ``groupby_count``."""
        counts = self._masked_counts_from(column, self.predicate_mask(pred))
        return (self._dictionary(column).values,
                counts.cpu().numpy().astype(np.int64))

    @_on_stream
    def agg_where(self, pred, column: str, agg: str = "count") -> float:
        """Masked count/sum/mean of ``column`` under ``pred`` — K-entry
        dictionary tail work on top of the device masked histogram."""
        counts = self._masked_counts_from(column, self.predicate_mask(pred))
        return _agg_from_counts(self._dictionary(column),
                                counts.cpu().numpy(), agg)

    # -- single batch -------------------------------------------------------------
    def slice_codes(self, row_idx: np.ndarray) -> np.ndarray:
        """Host-side work for one batch: one fancy-index on the code matrix
        (int32 plans) or a per-column word gather (packed plans)."""
        return self.plan.host_codes(row_idx)

    @_on_stream
    def batch(self, row_idx: np.ndarray) -> torch.Tensor:
        """Featurize the given rows. int32 plans ship the stacked code slice;
        packed plans ship ONLY the row indices — the kernel computes word
        index + bit offset against the resident stream."""
        if self.packed:
            rows = np.asarray(row_idx, np.int64).reshape(-1)
            n = rows.shape[0]
            if n == 0:                 # match the int32 path's empty gather
                return torch.zeros((0, self.plan.out_dim),
                                   dtype=torch.float32, device=self.device)
            if rows.min() < 0 or rows.max() >= self.plan.n_rows:
                # the kernel clamps word indices, which would silently read
                # ANOTHER column's words — keep numpy's error contract
                raise IndexError(
                    f"row indices out of range [0, {self.plan.n_rows})")
            rows = pad_rows_edge(rows, _pad32(n))
            return self._rows_future(rows.astype(np.int32))[:n]
        return self.gather_device(to_device(self.slice_codes(row_idx),
                                            self.device))

    # -- double-buffered iteration --------------------------------------------------
    def batches(self, batch_size: int, seed: int = 0,
                epochs: int = 1) -> Iterator[tuple[np.ndarray, torch.Tensor]]:
        """Shuffled minibatch iterator with a ``prefetch``-deep pipeline.

        Up to ``prefetch`` launches are kept in flight: the host prepares
        and issues batch i+1 (i+2, ...) while the device still works on
        batch i, so consumers that block on each result hide the host-side
        slicing and transfer latency.

        Packed plans shuffle at word-aligned BLOCK granularity (the order of
        contiguous ``batch_size``-row ranges is permuted, rows within a range
        stay contiguous) so batches slice on word boundaries and no int32
        codes are ever built; ``batch_size`` must be a multiple of 32.
        int32 plans copy each batch's codes from pinned memory on a side
        stream, so the copy of batch i+1 overlaps the gather of batch i.
        """
        rng = np.random.default_rng(seed)
        n = self.plan.n_rows

        if self.packed:
            if batch_size % 32:
                raise ValueError("packed plans need batch_size % 32 == 0 "
                                 f"(word-aligned ranges), got {batch_size}")
            # a per-epoch word-aligned jitter rotates which remainder rows
            # fall outside the epoch's blocks; only a sub-word tail (< 32
            # rows, when n % 32 != 0) is never range-reachable
            leftover = (n % batch_size) // 32 * 32

            def ranges():
                for _ in range(epochs):
                    jitter = 32 * rng.integers(0, leftover // 32 + 1)
                    yield from rng.permutation(
                        np.arange(jitter, n - batch_size + 1, batch_size))

            inflight: deque[tuple[np.ndarray, torch.Tensor]] = deque()
            for start in ranges():
                idx = np.arange(start, start + batch_size)
                inflight.append((idx, self._range_future(int(start),
                                                         batch_size)))
                if len(inflight) >= self.prefetch:
                    yield inflight.popleft()
            while inflight:
                yield inflight.popleft()
            return

        def indices():
            for _ in range(epochs):
                perm = rng.permutation(n)
                for start in range(0, n - batch_size + 1, batch_size):
                    yield perm[start:start + batch_size]

        copy_stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        inflight = deque()
        for idx in indices():
            codes = self.slice_codes(idx)
            if copy_stream is None:
                dev_codes = torch.from_numpy(codes)
            else:
                host = torch.from_numpy(codes).pin_memory()
                with torch.cuda.stream(copy_stream):
                    dev_codes = host.to(self.device, non_blocking=True)
                main = torch.cuda.current_stream(self.device)
                main.wait_stream(copy_stream)
                # allocated on the side stream, consumed on the main one
                dev_codes.record_stream(main)
            inflight.append((idx, self.gather_device(dev_codes)))
            if len(inflight) >= self.prefetch:
                yield inflight.popleft()
        while inflight:
            yield inflight.popleft()


class ShardedFeatureExecutor:
    """Per-IMCU serving: one executor per shard, each on its own stream.

    The plan is partitioned by :meth:`FeaturePlan.imcu_shards` and each
    shard's resident word stream is committed to a device of the serve pool
    (``devices``, default the plan's device; :func:`repro_torch.distributed.
    sharding.serve_devices` round-robins shards over it) — 'move compute to
    the data': a launch for rows of shard k runs on shard k's executor
    against shard-local operands only. The ADV tables are held once per
    DEVICE (shards sharing a device share one copy); the word streams, the
    part that grows with table rows, stay partitioned. On a CUDA device
    every executor, primary or replica, launches on its own
    ``torch.cuda.Stream`` (several shards on one card are several streams).

    :meth:`batch` is the synchronous routed gather: the host buckets rows
    by owning shard, every shard's launch is dispatched before any result
    is read, and the results are reassembled in request order. The serving
    pump drives the per-shard executors directly (one queue per shard).

    The shard set is adaptive: :meth:`add_replica` commits another copy of
    a hot shard's words and :meth:`next_executor` round-robins reads over
    the copies (every copy re-syncs from the parent plan's versioned words
    at its next launch, so a refresh needs no fan-in); :meth:`split_tail`
    closes the open tail shard at a cut row and opens a fresh tail once
    appends outgrow a budget. Routing state is swapped as one snapshot
    tuple, and a split orders create-new -> swap-routing -> close-old so a
    reader holding either snapshot stays bit-exact. Mutators are not safe
    against a concurrent :meth:`batch`: FeatureService runs them on its
    pump; standalone users must quiesce first.

    ``hbm_budget_bytes`` caps the word-stream bytes each device holds: the
    shards commit in order while they fit (:class:`DeviceBudget`), and the
    rest keep an executor with no words on the device until a launch or a
    promotion puts them. :meth:`evict_device` takes a lost device's
    streams out and :meth:`rebuild_on` commits an orphaned shard again on
    a surviving device.
    """

    def __init__(self, plan: FeaturePlan, prefetch: int = 2, devices=None,
                 hbm_budget_bytes: int | None = None):
        if not plan.packed:
            raise ValueError("sharded executors serve packed plans; int32 "
                             "plans route host code slices instead")
        self.plan = plan
        self.prefetch = prefetch
        self.hbm_budget_bytes = hbm_budget_bytes
        self.device_pool = serve_mesh(devices if devices is not None
                                      else [plan.device])
        self.shards = plan.imcu_shards()
        self.devices = serve_devices(len(self.shards), self.device_pool)
        # tables are held once per DEVICE, keyed by the device itself
        # (equal devices are one key); the dict persists so replicas and
        # splits landing on a device later reuse the same placed tables
        self._caches = {dev: _DeviceTableCache() for dev in self.devices}
        # commit each shard's words, in shard order, while they fit the
        # per-device budget; the rest start with none (no budget: all)
        ledger = DeviceBudget(hbm_budget_bytes)
        self.executors = []
        for sp, dev in zip(self.shards, self.devices):
            ex = self._executor(sp, dev, commit=False)
            if ledger.fits(dev, ex.stream_nbytes()):
                ex.ensure_range_capacity(sp.n_rows)
                ledger.charge(dev, ex.resident_bytes())
            self.executors.append(ex)
        self.replicas: list[list[FeatureExecutor]] = [[] for _ in self.shards]
        self._rr = [0] * len(self.shards)   # read-fan-out cursor per shard
        self._set_routing()

    def _executor(self, shard_plan, device,
                  commit: bool = True) -> FeatureExecutor:
        return FeatureExecutor(shard_plan, prefetch=self.prefetch,
                               device=device,
                               table_cache=self._caches.setdefault(
                                   device, _DeviceTableCache()),
                               commit=commit, own_stream=True)

    def _set_routing(self) -> None:
        """Swap the routing table as ONE snapshot: readers take the tuple
        once, so a concurrent swap never hands them new starts with an old
        bisect list."""
        starts = np.array([sp._start for sp in self.shards], np.int64)
        self.starts = starts
        self._starts_list = starts.tolist()
        self._routing = (starts, self._starts_list)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    # -- adaptive shard management -------------------------------------------------
    def n_streams(self, shard: int) -> int:
        """Launch streams serving this shard (primary + replicas)."""
        return 1 + len(self.replicas[shard])

    def stream_executors(self, shard: int) -> list[FeatureExecutor]:
        return [self.executors[shard], *self.replicas[shard]]

    def next_executor(self, shard: int) -> FeatureExecutor:
        """Read fan-out: round-robin over the shard's launch streams (the
        primary alone while it has no replica)."""
        reps = self.replicas[shard]
        if not reps:
            return self.executors[shard]
        i = self._rr[shard]
        self._rr[shard] = (i + 1) % (1 + len(reps))
        return self.executors[shard] if i == 0 else reps[i - 1]

    def device_load(self) -> dict:
        """Resident launch streams per device — the placement pressure the
        replica and split policies balance."""
        load: dict = {}
        for s in range(self.n_shards):
            for ex in self.stream_executors(s):
                load[ex.device] = load.get(ex.device, 0) + 1
        return load

    def device_bytes(self) -> dict:
        """Resident word-stream bytes per device, summed over every launch
        stream, from the tensors actually held. The ADV tables are left
        out: K-row constants held once per device."""
        out: dict = {}
        for s in range(self.n_shards):
            for ex in self.stream_executors(s):
                b = ex.resident_bytes()
                if b:
                    out[ex.device] = out.get(ex.device, 0) + b
        return out

    def budget_ledger(self) -> DeviceBudget:
        """A :class:`DeviceBudget` charged with the live bytes of
        :meth:`device_bytes`: the fits/headroom view the tier policies
        consult."""
        ledger = DeviceBudget(self.hbm_budget_bytes)
        for dev, n in self.device_bytes().items():
            ledger.charge(dev, n)
        return ledger

    def add_replica(self, shard: int, device=None,
                    avoid=frozenset()) -> FeatureExecutor:
        """Commit a REPLICA of ``shard``'s resident words to the least
        loaded pool device not already holding a copy (``device`` to name
        one) and fan reads out over it. The replica shares the shard's plan
        view, so its puts count in the same ``per_shard`` entry, and a
        parent refresh re-puts it at its next launch like the primary.
        ``avoid`` names unhealthy devices to place around."""
        if device is None:
            held = {e.device for e in self.stream_executors(shard)}
            device = replica_device(self.device_pool, self.device_load(),
                                    exclude=held, unhealthy=avoid)
        else:
            device = serve_mesh([device])[0]
        ex = self._executor(self.shards[shard], device)
        self.replicas[shard].append(ex)
        self._rr[shard] = 0
        return ex

    def drop_replica(self, shard: int, index: int = -1) -> FeatureExecutor:
        """Retire one of ``shard``'s replicas: later launches stop routing
        to it. Its launches in flight keep their operands: its words were
        put and read on its own stream only, so their memory goes back to
        later work on that stream alone."""
        if not self.replicas[shard]:
            raise ValueError(f"shard {shard} has no replicas to drop")
        ex = self.replicas[shard].pop(index)
        self._rr[shard] = 0
        return ex

    def evict_device(self, device):
        """Take every launch stream on a lost ``device`` out of rotation:
        its replicas are dropped, and a shard whose PRIMARY was there
        promotes its first surviving replica (which holds the words
        already). Returns ``(removed, orphans)``: ``[(shard, executor)]``
        for every stream taken out, and the shards left with NO live
        stream, whose lost primary stays in place as a routing placeholder
        until :meth:`rebuild_on`. Every removed executor drops its words
        and the device's table copy goes; work already queued on their
        streams keeps its operands (the words were allocated on the
        executor's stream, the tables recorded on it)."""
        device = canonical_device(device)
        removed: list[tuple[int, FeatureExecutor]] = []
        orphans: list[int] = []
        for s in range(self.n_shards):
            reps = self.replicas[s]
            dead = [ex for ex in reps if ex.device == device]
            if dead:
                self.replicas[s] = [ex for ex in reps
                                    if ex.device != device]
                removed.extend((s, ex) for ex in dead)
                self._rr[s] = 0
            if self.executors[s].device == device:
                removed.append((s, self.executors[s]))
                if self.replicas[s]:           # failover: promote a replica
                    self.executors[s] = self.replicas[s].pop(0)
                    self.devices[s] = self.executors[s].device
                    self._rr[s] = 0
                else:
                    orphans.append(s)
        for _, ex in removed:
            ex.evict_words()
        self._caches.pop(device, None)
        return removed, orphans

    def rebuild_on(self, shard: int, device=None,
                   lost=frozenset()) -> FeatureExecutor:
        """Commit ``shard``'s primary stream again on a healthy device, from
        the HOST packed words through the version-keyed put a refresh uses,
        so it is bit for bit the lost one. The default device is the least
        loaded of the pool minus ``lost``, away from devices that hold a
        stream of the shard where it can. Raises ValueError when no device
        survives: the caller keeps serving from the host."""
        if device is None:
            pool = surviving_devices(self.device_pool, lost)
            if not pool:
                raise ValueError(
                    f"no surviving device to rebuild shard {shard} on")
            held = {e.device for e in self.stream_executors(shard)}
            device = replica_device(pool, self.device_load(), exclude=held,
                                    unhealthy=lost)
        else:
            device = serve_mesh([device])[0]
        ex = self._executor(self.shards[shard], device)
        self.executors[shard] = ex
        self.devices[shard] = device
        self._rr[shard] = 0
        return ex

    def tail_rows(self) -> int:
        """Rows owned by the open tail shard (append pressure)."""
        start, stop = self.shards[-1].shard_bounds
        return stop - start

    def split_tail(self, cut: int | None = None, device=None) -> int:
        """Split the open tail shard at parent row ``cut`` (default: the
        word-aligned midpoint) and serve the new tail [cut, n_rows) from its
        own executor on the least loaded device. Returns the new shard's
        index. The new shard exists first, the routing snapshot flips
        second, the old tail closes LAST: a reader holding the old snapshot
        still finds rows >= cut in the then-still-open old tail."""
        tail = self.shards[-1]
        start, stop = tail.shard_bounds
        if cut is None:
            # word-aligned midpoint, clamped so the default stays valid on
            # a sub-32-row tail (cut == stop closes it behind an empty one)
            cut = min(start + max(32, (stop - start) // 2 // 32 * 32), stop)
        new_plan = self.plan.split_tail_shard(tail, cut, close=False)
        device = (replica_device(self.device_pool, self.device_load())
                  if device is None else serve_mesh([device])[0])
        ex = self._executor(new_plan, device)
        self.shards.append(new_plan)
        self.executors.append(ex)
        self.replicas.append([])
        self._rr.append(0)
        self.devices.append(device)
        self._set_routing()
        tail.close_at(cut)
        return len(self.shards) - 1

    def shard_of(self, rows: np.ndarray) -> np.ndarray:
        """Owning shard per row; rows past the last compile-time bound
        (appends) belong to the open-ended last shard."""
        starts, _ = self._routing
        s = np.searchsorted(starts, rows, side="right") - 1
        return np.minimum(s, len(starts) - 1)

    @staticmethod
    def _shard_scalar(slist: list[int], row: int) -> int:
        return min(bisect.bisect_right(slist, row) - 1, len(slist) - 1)

    def route(self, rows: np.ndarray, lo: int | None = None,
              hi: int | None = None):
        """Bucket request rows by owning shard: [(shard, local_rows, dest)].

        ``dest`` gives each local row's position in the request (``None``:
        the whole request, in order — the clustered-lookup fast path, two
        scalar bisects and no per-row work). Local rows are shard-relative,
        so every launch indexes its own shard's stream. Callers that know
        the request's min/max row pass them in.
        """
        starts, slist = self._routing       # one snapshot, never torn
        rows = np.asarray(rows, np.int64).reshape(-1)
        if lo is None:
            lo, hi = int(rows.min()), int(rows.max())
        s_lo = self._shard_scalar(slist, lo)
        s_hi = self._shard_scalar(slist, hi)
        if s_lo == s_hi:                   # whole request owned by one shard
            return [(s_lo, rows - starts[s_lo], None)]
        shard = np.minimum(np.searchsorted(starts, rows, side="right") - 1,
                           len(starts) - 1)
        out = []
        for s in np.unique(shard):
            (dest,) = np.nonzero(shard == s)
            out.append((int(s), rows[dest] - starts[s], dest))
        return out

    # -- predicate pushdown, sharded: scan per shard, serve matches locally -------
    def _shard_masks(self, pred) -> list:
        """Every shard's scan dispatched, on the executor that owns (or
        replicates) its words, before any count is read: (shard, executor,
        mask, count) per shard. Each executor compiles the predicate once
        and caches it; the dictionaries are shared, so the terms agree."""
        return [(s, ex, *ex._mask_count_future(pred))
                for s, ex in ((s, self.next_executor(s))
                              for s in range(self.n_shards))]

    def count_where(self, pred) -> int:
        return sum(int(c) for _, _, _, c in self._shard_masks(pred))

    def filtered_rows(self, pred) -> np.ndarray:
        """Matching GLOBAL row indices, ascending (shards are ordered by
        start row, so shard order IS row order)."""
        starts, _ = self._routing
        parts = []
        for s, ex, mask, c in self._shard_masks(pred):
            cnt = int(c)
            if cnt == 0:
                continue
            rows = scan_ops.compact_rows(mask, _pad32(cnt))
            parts.append(rows[:cnt].cpu().numpy().astype(np.int64)
                         + int(starts[s]))
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def batch_where(self, pred) -> tuple[np.ndarray, torch.Tensor]:
        """Filtered featurization across the shards: each scans its own
        words, compacts its matches and gathers them LOCALLY; the host only
        assembles the per-shard results in global row order."""
        starts, _ = self._routing
        futs, total = [], 0
        for s, ex, mask, c in self._shard_masks(pred):
            cnt = int(c)
            if cnt == 0:
                continue
            rows = scan_ops.compact_rows(mask, _pad32(cnt))
            futs.append((s, ex._rows_future(rows), rows, cnt))
            total += cnt
        out_dim = self.plan.out_dim
        if not futs:
            return (np.zeros(0, np.int64),
                    torch.zeros((0, out_dim), dtype=torch.float32,
                                device=self.plan.device))
        rows_out = np.empty(total, np.int64)
        feats_out = np.empty((total, out_dim), np.float32)
        off = 0
        for s, fut, rows, cnt in futs:     # all dispatched; read in order
            rows_out[off:off + cnt] = \
                rows[:cnt].cpu().numpy().astype(np.int64) + int(starts[s])
            feats_out[off:off + cnt] = fut[:cnt].cpu().numpy()
            off += cnt
        return rows_out, torch.from_numpy(feats_out).to(self.plan.device)

    def _counts(self, column: str, pred) -> np.ndarray:
        """Per-shard masked histograms (local words, local mask) summed on
        the host: K-entry partials, never row-space traffic."""
        futs = [ex._masked_counts_from(column, mask)
                for _, ex, mask, _ in self._shard_masks(pred)]
        return np.sum([f.cpu().numpy() for f in futs], axis=0)

    def groupby_where(self, column: str,
                      pred) -> tuple[np.ndarray, np.ndarray]:
        """GROUP BY column COUNT(*) WHERE pred across the shards."""
        counts = self._counts(column, pred)
        return (self.executors[0]._dictionary(column).values,
                counts.astype(np.int64))

    def agg_where(self, pred, column: str, agg: str = "count") -> float:
        return _agg_from_counts(self.executors[0]._dictionary(column),
                                self._counts(column, pred), agg)

    def batch(self, row_idx: np.ndarray) -> torch.Tensor:
        """Routed featurization of arbitrary rows, request order kept.
        Every shard's launch is dispatched before any result is read."""
        rows = np.asarray(row_idx, np.int64).reshape(-1)
        n = rows.shape[0]
        out_dim = self.plan.out_dim
        if n == 0:
            return torch.zeros((0, out_dim), dtype=torch.float32,
                               device=self.plan.device)
        lo, hi = int(rows.min()), int(rows.max())
        if lo < 0 or hi >= self.plan.n_rows:
            raise IndexError(
                f"row indices out of range [0, {self.plan.n_rows})")
        futs = []
        for s, local, dest in self.route(rows, lo, hi):
            padded = pad_rows_edge(local, _pad32(local.shape[0]))
            futs.append((self.next_executor(s)._rows_future(
                padded.astype(np.int32)), local.shape[0], dest))
        if len(futs) == 1:
            return futs[0][0][:n]
        out = np.empty((n, out_dim), np.float32)
        for fut, m, dest in futs:
            out[dest] = fut[:m].cpu().numpy()
        return torch.from_numpy(out).to(self.plan.device)


class FeaturePipeline:
    """Facade over (FeaturePlan, FeatureExecutor)."""

    def __init__(self, table: Table, features: FeatureSet,
                 prefetch: int = 2, packed: bool = False, device=None):
        self.table = table
        self.features = features
        self.plan = FeaturePlan(table, features, packed=packed, device=device)
        self.executor = FeatureExecutor(self.plan, prefetch=prefetch)
        self.augmented = self.plan.augmented

    @property
    def out_dim(self) -> int:
        return self.plan.out_dim

    # -- device path ---------------------------------------------------------------
    def batch(self, row_idx: np.ndarray) -> torch.Tensor:
        return self.executor.batch(row_idx)

    def batches(self, batch_size: int, seed: int = 0, epochs: int = 1):
        yield from self.executor.batches(batch_size, seed=seed, epochs=epochs)

    # -- host baseline (Fig 1 traditional path) -------------------------------------
    def batch_recompute(self, row_idx: np.ndarray) -> np.ndarray:
        """Decode values + row-space transform + ship f32 — the CSV workflow."""
        outs = []
        codes_all = self.plan.host_codes(row_idx)
        for i, p in enumerate(self.plan.plans):
            aug = self.augmented[p.column]
            for name in p.adv_names:
                outs.append(aug.featurize_recompute(name, codes_all[i]))
        return np.concatenate(outs, axis=1)

    # -- data-movement accounting ----------------------------------------------------
    def bytes_moved_adv(self, batch_rows: int) -> int:
        return self.plan.bytes_moved_adv(batch_rows)

    def bytes_moved_recompute(self, batch_rows: int) -> int:
        return self.plan.bytes_moved_recompute(batch_rows)

    def bytes_resident_tables(self) -> int:
        return self.plan.bytes_resident_tables()
