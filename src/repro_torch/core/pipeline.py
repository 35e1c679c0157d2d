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

from collections import deque
from dataclasses import dataclass
from typing import Iterator, Mapping

import numpy as np
import torch

from repro_torch.columnar import query as colquery
from repro_torch.columnar.bitpack import (bits_needed, pack_bits,
                                          packed_gather, packed_nbytes,
                                          unpack_bits)
from repro_torch.columnar.dictionary import Dictionary
from repro_torch.columnar.table import Table
from repro_torch.core.adv import AugmentedDictionary
from repro_torch.core.feature_spec import FeatureSet
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
            "words_put": 0}


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
            # bumps on ANY stream change (repack or append); executors key
            # their resident-stream sync on it
            self.packed_versions: list[int] = []
            for p in self.plans:
                words, db = table[p.column].device_words()
                self.packed_words.append(words)
                self.device_bits.append(db)
                self.packed_versions.append(0)
        else:
            codes = [table[p.column].codes() for p in self.plans]
            # (C, N): one row-aligned int32 code stream per planned column —
            # a batch slice is ONE fancy-index + ONE host->device transfer
            self._codes_matrix = (np.stack(codes) if codes
                                  else np.zeros((0, table.n_rows), np.int32))
        self._fused: adv_ops.FusedTables | None = None

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
        if self._fused is None:
            self._fused = adv_ops.fuse_tables(
                [p.fused_host for p in self.plans], self.device)
            self.stats["fused_rebuilds"] += 1
        return self._fused

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
            self._fused = None             # rebuilt on next use
        if self.packed:
            for i, p in enumerate(self.plans):
                db = tpu_width(p.bits)
                if db != self.device_bits[i]:   # grew across a width boundary
                    codes = unpack_bits(self.packed_words[i],
                                        self.device_bits[i], self._n_rows)
                    self.packed_words[i] = pack_bits(codes, db)
                    self.device_bits[i] = db
                    self.packed_versions[i] += 1
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
    plan._fused = None
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
    """

    def __init__(self, plan: FeaturePlan, prefetch: int = 2):
        if prefetch < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.plan = plan
        self.prefetch = prefetch
        self.packed = plan.packed
        self.device = plan.device
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
            self.ensure_range_capacity(plan.n_rows)
        plan.fused_tables()            # resident before the first launch

    def gather_device(self, dev_codes: torch.Tensor) -> torch.Tensor:
        """(C, B) int32 device codes -> (B, out_dim) concatenated features."""
        return adv_ops.gather_fused_parts(self.plan.fused_tables(), dev_codes)

    # -- packed fast path: device-resident words, range batches -------------------
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
        one copy keeps device residency at exactly the stream bytes.
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

    def _starts_tensor(self, starts: np.ndarray) -> torch.Tensor:
        return to_device(np.asarray(starts, np.int32), self.device)

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
            self._flat_words, self._wmeta, self.plan.fused_tables(),
            self._starts_tensor(np.array([start])), batch)

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
            self._flat_words, self._wmeta, self.plan.fused_tables(),
            self._starts_tensor(starts), batch)
        return out.reshape(starts.size, batch, -1)

    def batch_range(self, start: int, n: int) -> torch.Tensor:
        """Featurize the contiguous rows [start, start+n) (start % 32 == 0)
        without any host code work: unpack happens inside the gather."""
        return self._range_future(start, _pad32(n))[:n]

    # -- packed random-row path: indices in, features out -------------------------
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
            self._flat_words, self._wmeta, self.plan.fused_tables(), dev_rows)

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

    def _mask_count_future(self, pred) -> tuple[torch.Tensor, torch.Tensor]:
        """(mask, count) on the device from ONE scan launch over the
        resident stream, read in place: no code stream and no per-query
        copy of the used columns exists anywhere."""
        _, combine, packed = self._compiled_pred(pred)
        self.ensure_range_capacity(self.plan.n_rows)
        return scan_ops.predicate_scan(self._flat_words, self._wmeta, packed,
                                       self.plan.n_rows, combine)

    def predicate_mask(self, pred) -> torch.Tensor:
        """(n_rows,) bool device mask for a value-space predicate."""
        return self._mask_count_future(pred)[0]

    def count_where(self, pred) -> int:
        """SELECT COUNT(*) WHERE pred — one scan launch, one scalar sync."""
        return int(self._mask_count_future(pred)[1])

    def filtered_rows(self, pred) -> np.ndarray:
        """Matching row indices (ascending int64), compacted on the
        device."""
        mask, cnt_dev = self._mask_count_future(pred)
        cnt = int(cnt_dev)             # one scalar sync: the static length
        if cnt == 0:
            return np.zeros(0, np.int64)
        rows = scan_ops.compact_rows(mask, _pad32(cnt))
        return rows[:cnt].cpu().numpy().astype(np.int64)

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

    def _masked_counts_from(self, column: str,
                            mask: torch.Tensor) -> torch.Tensor:
        """(K,) per-code counts of ``column`` under a device mask."""
        d = self._dictionary(column)
        ci = self.plan.columns.index(column)
        return scan_ops.masked_counts(
            self._flat_words, self._word_offs[ci], self.plan.device_bits[ci],
            mask, d.cardinality, self.plan.n_rows)

    def groupby_where(self, column: str,
                      pred) -> tuple[np.ndarray, np.ndarray]:
        """GROUP BY column COUNT(*) WHERE pred — masked histogram over the
        resident words; returns (values, counts) like ``groupby_count``."""
        counts = self._masked_counts_from(column, self.predicate_mask(pred))
        return (self._dictionary(column).values,
                counts.cpu().numpy().astype(np.int64))

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
