"""Augmented Dictionary Values (paper §6.3) — the core innovation.

An :class:`AugmentedDictionary` wraps a columnar :class:`Dictionary` and
attaches named ADV columns: per-dictionary-entry precomputed feature values
stored in the floating-point format the consuming ML/DL algorithm needs
(paper Table 4/5 — 'populated with floating-point numbers of the type that can
be directly used by the algorithms without conversion').

Featurizing N rows is then ``adv_table[codes]`` — a K-row gather, executed on
device by ``repro_torch.kernels.adv_gather``. Multiple alternative
featurizations (e.g. two bucketizations of the same column, Table 4) coexist
as sibling ADVs, and learned artifacts (embeddings, model-derived buckets)
are written back as new ADVs by the analytics cycle (paper §7).

Each ADV also carries the distribution statistics the paper suggests
(entropy/diversity/peculiarity, §6.3) for feature-interest ranking.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.columnar.dictionary import Dictionary
from repro_torch.columnar import featurize as F


@dataclass
class ADV:
    """One augmented dictionary value column."""
    name: str
    table: np.ndarray            # (K,) or (K, F) float32 — code -> feature row
    kind: str                    # 'float'|'minmax'|'zscore'|...|'embedding'|'learned'
    params: dict = field(default_factory=dict)
    learned: bool = False        # True if produced by the analytics cycle (§7)

    def __post_init__(self) -> None:
        self.table = np.asarray(self.table, dtype=np.float32)
        if self.table.ndim == 1:
            self.table = self.table[:, None]

    @property
    def dim(self) -> int:
        return int(self.table.shape[1])

    @property
    def cardinality(self) -> int:
        return int(self.table.shape[0])

    # -- §6.3 'statistical measures of its data distribution' -------------------
    def interest_stats(self, counts: np.ndarray) -> dict[str, float]:
        p = counts / max(counts.sum(), 1)
        ent = float(-(p[p > 0] * np.log2(p[p > 0])).sum())
        flat = self.table[:, 0]
        uniq = np.unique(flat)
        diversity = uniq.size / max(flat.size, 1)
        # 'peculiarity': weighted distance of a value's feature from the
        # count-weighted mean, normalized by std — flags rare-but-extreme codes.
        mu = float(np.dot(flat, p))
        sd = float(np.sqrt(np.dot((flat - mu) ** 2, p))) or 1.0
        peculiarity = float(np.max(np.abs(flat - mu)) / sd)
        return {"entropy": ent, "diversity": diversity,
                "peculiarity": peculiarity}


# featurizations whose tables depend on the count distribution, not just the
# value set: duplicate-value inserts (cardinality unchanged) still shift
# their normalization constants, so maintenance must rebuild them whenever
# the dictionary version moved — not only when it grew
_COUNT_SENSITIVE = {"mean_norm", "zscore", "quantile"}

_BUILDERS: dict[str, Callable[..., np.ndarray]] = {
    "float": F.to_float,
    "minmax": F.minmax_scale,
    "mean_norm": F.mean_normalize,
    "zscore": F.zscore,
    "log": F.log_scale,
    "onehot": F.onehot,
    "binarize": F.binarize,
    "quantile": F.quantile_bucket,
    "hash_bucket": F.hash_bucket,
    "bucketize": F.bucketize,
    "bucketize_cat": F.bucketize_categorical,
    "embedding": F.embedding_init,
}


class AugmentedDictionary:
    """Dictionary + named ADV columns + maintenance under inserts (§6.3)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary
        self.advs: dict[str, ADV] = {}
        # bumped on any ADV mutation; feature plans compare it to decide
        # whether their device-resident fused tables need a refresh
        self.version = 0
        self._built_at: dict[str, int] = {}    # adv name -> dictionary.version

    # -- creation ---------------------------------------------------------------
    def add(self, name: str, kind: str, **params: Any) -> ADV:
        if name in self.advs:
            raise KeyError(f"ADV {name!r} already exists")
        builder = _BUILDERS.get(kind)
        if builder is None:
            raise KeyError(f"unknown featurization kind {kind!r}; "
                           f"known: {sorted(_BUILDERS)}")
        table = builder(self.dictionary, **params)
        adv = ADV(name=name, table=table, kind=kind, params=params)
        self.advs[name] = adv
        self._built_at[name] = self.dictionary.version
        self.version += 1
        return adv

    def add_learned(self, name: str, table: np.ndarray,
                    params: dict | None = None) -> ADV:
        """Write-back path for the analytics cycle (paper §7): store an
        artifact learned during training as a first-class ADV."""
        adv = ADV(name=name, table=np.asarray(table, np.float32),
                  kind="learned", params=params or {}, learned=True)
        if adv.cardinality != self.dictionary.cardinality:
            raise ValueError(
                f"learned ADV rows {adv.cardinality} != dictionary "
                f"cardinality {self.dictionary.cardinality}")
        self.advs[name] = adv
        self.version += 1
        return adv

    def __getitem__(self, name: str) -> ADV:
        return self.advs[name]

    def __contains__(self, name: str) -> bool:
        return name in self.advs

    # -- the fast path (what the paper is about) ----------------------------------
    def featurize(self, name: str, codes: np.ndarray) -> np.ndarray:
        """Row-space features via ADV gather: out[i] = adv.table[codes[i]].

        Host/numpy reference; the device path is kernels/adv_gather (CUDA).
        """
        return self.advs[name].table[np.asarray(codes)]

    def featurize_many(self, names: list[str], codes: np.ndarray) -> np.ndarray:
        """Fused multi-ADV gather: one pass over codes, concatenated features.

        This is the 'single efficient step' of paper §6: K-row tables are
        concatenated once (dictionary-domain, cheap), then one gather serves
        every requested featurization.
        """
        fused = np.concatenate([self.advs[n].table for n in names], axis=1)
        return fused[np.asarray(codes)]

    def fused_table(self, names: list[str]) -> np.ndarray:
        return np.concatenate([self.advs[n].table for n in names], axis=1)

    # -- recompute baseline (what the paper replaces) ------------------------------
    def featurize_recompute(self, name: str, codes: np.ndarray) -> np.ndarray:
        """Row-space recompute: decode values then transform every row.

        Benchmark baseline modeling the traditional CSV-export pipeline
        (paper Fig 1): value decode + row-space arithmetic. Normalization
        constants come from full-column statistics (as a real preprocessing
        pass would), so outputs match the ADV path bit-for-bit-ish.
        """
        adv = self.advs[name]
        codes = np.asarray(codes)
        d = self.dictionary
        kind, params = adv.kind, adv.params
        if kind in ("embedding", "learned"):
            return adv.table[codes]                     # no row-space analogue
        if kind == "onehot":
            return F.onehot_rows(codes, d.cardinality)
        values = d.decode(codes)                        # N-row value materialize
        if kind == "float":
            out = values.astype(np.float32)
        elif kind == "minmax":
            v = values.astype(np.float64)
            lo, hi = float(d.vmin), float(d.vmax)
            out = (v - lo) / ((hi - lo) or 1.0)
        elif kind == "mean_norm":
            v = values.astype(np.float64)
            lo, hi = float(d.vmin), float(d.vmax)
            out = (v - d.mean()) / ((hi - lo) or 1.0)
        elif kind == "zscore":
            out = (values.astype(np.float64) - d.mean()) / (d.std() or 1.0)
        elif kind == "log":
            out = np.log1p(values.astype(np.float64))
        elif kind == "binarize":
            out = values.astype(np.float64) > params["threshold"]
        elif kind == "quantile":
            edges = d.quantile_edges(params["q"])
            out = np.searchsorted(edges, values.astype(np.float64),
                                  side="right")
        elif kind == "hash_bucket":
            # hash each row value (the whole point is ADV hashes only K values)
            row_table = F.hash_bucket(d, **params)
            out = row_table[codes][:, 0] if row_table.ndim > 1 else row_table[codes]
        elif kind == "bucketize":
            b = np.asarray(params["boundaries"], np.float64)
            out = np.searchsorted(b, values.astype(np.float64), side="right")
        elif kind == "bucketize_cat":
            mapping = params["mapping"]
            default = params.get("default", 0.0)
            out = np.array([float(mapping.get(v, default))
                            for v in values.tolist()])
        else:
            raise KeyError(kind)
        out = np.asarray(out, np.float32)
        return out[:, None] if out.ndim == 1 else out

    # -- maintenance (§6.3: inserts/updates/deletes) --------------------------------
    def extend_for_new_codes(self) -> None:
        """After Dictionary.add_rows/remove_rows, bring derived ADVs up to
        date: grown dictionaries get their tables recomputed for the new tail
        (learned ADVs get zero rows until next feedback), and count-sensitive
        featurizations (zscore etc.) rebuild even when cardinality is
        unchanged — duplicate-value inserts shift their statistics too."""
        k = self.dictionary.cardinality
        dv = self.dictionary.version
        changed = False
        for adv in self.advs.values():
            stale_counts = (not adv.learned
                            and adv.kind in _COUNT_SENSITIVE
                            and self._built_at.get(adv.name) != dv)
            if adv.cardinality == k and not stale_counts:
                continue
            changed = True
            if adv.learned:
                pad = np.zeros((k - adv.cardinality, adv.dim), np.float32)
                adv.table = np.concatenate([adv.table, pad], axis=0)
            else:
                fresh = _BUILDERS[adv.kind](self.dictionary, **adv.params)
                fresh = np.asarray(fresh, np.float32)
                if fresh.ndim == 1:
                    fresh = fresh[:, None]
                adv.table = fresh
                self._built_at[adv.name] = dv
        if changed:
            self.version += 1

    # -- reporting ---------------------------------------------------------------
    def summary(self) -> str:
        d = self.dictionary
        lines = [f"AugmentedDictionary[{d.name}: K={d.cardinality}, "
                 f"bits={d.bits}, rows={d.n_rows}]"]
        for adv in self.advs.values():
            stats = adv.interest_stats(d.counts)
            lines.append(f"  ADV {adv.name}: kind={adv.kind} dim={adv.dim} "
                         f"learned={adv.learned} entropy={stats['entropy']:.2f} "
                         f"diversity={stats['diversity']:.2f}")
        return "\n".join(lines)
