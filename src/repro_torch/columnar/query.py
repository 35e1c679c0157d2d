"""Code-domain relational ops (paper §5/§6: filters, joins, group-bys run on
small integer codes; values are only decoded at the query tail).

These give the framework the SQL-ish surface the paper assumes data scientists
use for featurization, while demonstrating the columnar win: every operator
below works on int32 codes + dictionary metadata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.columnar.column import Column
from repro_torch.columnar.dictionary import Dictionary
from repro_torch.columnar.table import Table


# -- predicates -----------------------------------------------------------------
def codes_matching(d: Dictionary, pred: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Evaluate a value-space predicate over the K dictionary values ONCE,
    returning the matching code set. Row filtering is then `isin` on codes."""
    mask = pred(d.values)
    return np.flatnonzero(mask).astype(np.int32)


def filter_mask(col: Column, pred: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Row mask for a value predicate, via dictionary + IMCU min/max pruning."""
    match = codes_matching(col.dictionary, pred)
    return _mask_from_codes(col, match)


def _mask_from_codes(col: Column, match: np.ndarray) -> np.ndarray:
    """Row mask for a matching-code set, decoding only the live IMCUs."""
    if match.size == 0:
        return np.zeros(col.n_rows, dtype=bool)
    if match.size == col.dictionary.cardinality:
        return np.ones(col.n_rows, dtype=bool)
    lut = np.zeros(col.dictionary.cardinality, dtype=bool)
    lut[match] = True
    mask = np.zeros(col.n_rows, dtype=bool)
    live = set(col.prune_imcus(match))
    for i, (start, stop) in enumerate(col.imcu_bounds()):
        if i in live:
            mask[start:stop] = lut[col.imcu_codes(i)]
    return mask


def filter_table(t: Table, column: str,
                 pred: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    return filter_mask(t[column], pred)


# -- predicate AST + code-set compiler (device pushdown front end) ---------------
class Predicate:
    """Composable value-space predicate over named columns.

    Leaves are :class:`ColumnPred` (a column name + a vectorized value
    function evaluated over the K dictionary entries); ``&`` / ``|`` build a
    flat AND / OR across columns — the combinator shape the predicate-scan
    kernel evaluates in one pass. Mixing the two requires explicit nesting
    the kernel doesn't model, so it raises.
    """

    def __and__(self, other: "Predicate") -> "Predicate":
        return _combine("and", self, other)

    def __or__(self, other: "Predicate") -> "Predicate":
        return _combine("or", self, other)


@dataclass(frozen=True)
class ColumnPred(Predicate):
    column: str
    fn: Callable[[np.ndarray], np.ndarray]
    label: str = ""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return self.label or f"where({self.column!r})"


@dataclass(frozen=True)
class CompositePred(Predicate):
    op: str                      # "and" | "or"
    parts: tuple

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f" {self.op} ".join(repr(p) for p in self.parts)


def _combine(op: str, a: Predicate, b: Predicate) -> CompositePred:
    parts: list[Predicate] = []
    for p in (a, b):
        if isinstance(p, CompositePred):
            if p.op != op:
                raise ValueError("predicates mix AND and OR; the scan "
                                 "kernel evaluates one flat combinator")
            parts.extend(p.parts)
        elif isinstance(p, ColumnPred):
            parts.append(p)
        else:
            raise TypeError(f"not a predicate: {p!r}")
    return CompositePred(op, tuple(parts))


def where(column: str, fn: Callable[[np.ndarray], np.ndarray],
          label: str = "") -> ColumnPred:
    """Leaf predicate: ``fn`` is evaluated over the column's K dictionary
    values (never the N rows), exactly like :func:`codes_matching`."""
    return ColumnPred(column, fn, label or f"where({column!r})")


def eq(column: str, value) -> ColumnPred:
    return ColumnPred(column, lambda v: v == value, f"{column} == {value!r}")


def isin(column: str, values) -> ColumnPred:
    vals = list(values)
    return ColumnPred(column, lambda v: np.isin(v, vals),
                      f"{column} IN {vals!r}")


def between(column: str, lo, hi) -> ColumnPred:
    """Inclusive value range [lo, hi]."""
    return ColumnPred(column, lambda v: (v >= lo) & (v <= hi),
                      f"{lo!r} <= {column} <= {hi!r}")


def gt(column: str, value) -> ColumnPred:
    return ColumnPred(column, lambda v: v > value, f"{column} > {value!r}")


def ge(column: str, value) -> ColumnPred:
    return ColumnPred(column, lambda v: v >= value, f"{column} >= {value!r}")


def lt(column: str, value) -> ColumnPred:
    return ColumnPred(column, lambda v: v < value, f"{column} < {value!r}")


def le(column: str, value) -> ColumnPred:
    return ColumnPred(column, lambda v: v <= value, f"{column} <= {value!r}")


@dataclass(frozen=True)
class CompiledTerm:
    """One column's predicate lowered to code space.

    ``kind`` 0 is the contiguous range [lo, hi] (two device compares; an
    empty match compiles to hi < lo), kind 1 an arbitrary set probed through
    a K-entry LUT. ``match`` keeps the raw matching-code set for IMCU
    pruning and host-side evaluation.
    """
    column: str
    kind: int
    lo: int = 0
    hi: int = -1
    lut: np.ndarray | None = None
    match: np.ndarray | None = None


@dataclass(frozen=True)
class CompiledPredicate:
    terms: tuple
    combine: str                 # "and" | "or"


def compile_predicate(pred: Predicate,
                      dictionaries: dict[str, Dictionary]) -> CompiledPredicate:
    """Lower a predicate AST to code-space terms: each leaf's value function
    runs ONCE over its column's K dictionary entries (via
    :func:`codes_matching`), and the matching code set is classified as a
    contiguous range (equality, ranges on sorted dictionaries) or a K-entry
    LUT (IN-sets, ranges over load-order codes). Device-evaluable as-is by
    the predicate-scan kernel."""
    if isinstance(pred, ColumnPred):
        leaves, combine = (pred,), "and"
    elif isinstance(pred, CompositePred):
        leaves, combine = pred.parts, pred.op
    else:
        raise TypeError(f"not a predicate: {pred!r}")
    terms = []
    for leaf in leaves:
        d = dictionaries.get(leaf.column)
        if d is None:
            raise KeyError(f"predicate column {leaf.column!r} not in plan "
                           f"({sorted(dictionaries)})")
        match = codes_matching(d, leaf.fn)
        k = d.cardinality
        if match.size == 0:
            terms.append(CompiledTerm(leaf.column, 0, lo=0, hi=-1,
                                      match=match))
        elif match.size == k or \
                int(match[-1]) - int(match[0]) + 1 == match.size:
            terms.append(CompiledTerm(leaf.column, 0, lo=int(match[0]),
                                      hi=int(match[-1]), match=match))
        else:
            lut = np.zeros(k, np.int32)
            lut[match] = 1
            terms.append(CompiledTerm(leaf.column, 1, lut=lut, match=match))
    return CompiledPredicate(tuple(terms), combine)


def predicate_mask_host(t: Table, pred: Predicate) -> np.ndarray:
    """Host reference for a compiled predicate: per-term IMCU-pruned masks
    combined with the predicate's combinator. The baseline the device
    pushdown path is benchmarked (and tested bit-exact) against."""
    cp = compile_predicate(pred, {c: t[c].dictionary for c in t.columns})
    acc = None
    for term in cp.terms:
        m = _mask_from_codes(t[term.column], term.match)
        if acc is None:
            acc = m
        else:
            acc = (acc & m) if cp.combine == "and" else (acc | m)
    return acc


# -- group-by aggregation ----------------------------------------------------------
def groupby_count(col: Column) -> tuple[np.ndarray, np.ndarray]:
    """GROUP BY col COUNT(*) — pure dictionary metadata, zero row access (§6.2)."""
    d = col.dictionary
    return d.values, d.counts.copy()


def groupby_agg(key: Column, value: Column, agg: str = "sum",
                mask: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """GROUP BY key AGG(value) over codes; one bincount, no value decode until tail."""
    kd, vd = key.dictionary, value.dictionary
    kc, vc = key.codes(), value.codes()
    if mask is not None:
        kc, vc = kc[mask], vc[mask]
    vals = vd.values.astype(np.float64)[vc]     # decode value column at tail
    if agg == "sum":
        out = np.bincount(kc, weights=vals, minlength=kd.cardinality)
    elif agg == "mean":
        s = np.bincount(kc, weights=vals, minlength=kd.cardinality)
        n = np.bincount(kc, minlength=kd.cardinality)
        out = s / np.maximum(n, 1)
    elif agg == "count":
        out = np.bincount(kc, minlength=kd.cardinality).astype(np.float64)
    else:
        raise ValueError(f"unknown agg {agg!r}")
    return kd.values, out


# -- join -------------------------------------------------------------------------
def join_codes(left: Column, right: Column) -> tuple[np.ndarray, np.ndarray]:
    """Inner equi-join on dictionary-encoded key columns.

    Builds a code-translation LUT between the two dictionaries (K_l × lookup),
    then joins in code space — the paper's 'simple calculations on small
    integers' join path. Returns (left_row_idx, right_row_idx).
    """
    ld, rd = left.dictionary, right.dictionary
    # translate: left code -> right code (or -1)
    r_index = {v: i for i, v in enumerate(rd.values.tolist())}
    trans = np.array([r_index.get(v, -1) for v in ld.values.tolist()],
                     dtype=np.int64)
    lc = left.codes()
    rc = right.codes()
    lr = trans[lc]                               # right-code per left row
    # bucket right rows by code
    order = np.argsort(rc, kind="stable")
    sorted_rc = rc[order]
    starts = np.searchsorted(sorted_rc, np.arange(rd.cardinality), side="left")
    ends = np.searchsorted(sorted_rc, np.arange(rd.cardinality), side="right")
    # expand matches without a per-row Python loop: each joining left row i
    # contributes cnt[lr[i]] output pairs, laid out by repeat + running offset
    li_idx = np.flatnonzero(lr >= 0)
    codes = lr[li_idx]
    cnt = ends[codes] - starts[codes]            # matches per joining left row
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    li = np.repeat(li_idx, cnt)
    out_starts = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    within = np.arange(total, dtype=np.int64) - np.repeat(out_starts, cnt)
    ri = order[np.repeat(starts[codes], cnt) + within]
    return li.astype(np.int64), ri.astype(np.int64)
