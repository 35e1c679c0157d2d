"""Declarative featurization specs (paper Table 6 as a config surface).

A :class:`FeatureSet` names which column gets which featurization(s) with which
parameters — the 'featurization methods stored and managed by the database'
of paper §7. ``build()`` materializes the ADVs on an AugmentedDictionary per
column and returns the pipeline-ready mapping.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.columnar.table import Table
from repro_torch.core.adv import AugmentedDictionary


@dataclass(frozen=True)
class FeatureSpec:
    column: str
    kind: str                    # one of repro_torch.core.adv._BUILDERS
    name: str | None = None      # ADV name; default f"{column}.{kind}"
    params: tuple = ()           # sorted (key, value) tuples for hashability

    @property
    def adv_name(self) -> str:
        return self.name or f"{self.column}.{self.kind}"

    def params_dict(self) -> dict[str, Any]:
        return dict(self.params)


def spec(column: str, kind: str, name: str | None = None, **params: Any) -> FeatureSpec:
    canon = tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, np.ndarray)) else
         (tuple(sorted(v.items())) if isinstance(v, dict) else v))
        for k, v in params.items()))
    return FeatureSpec(column=column, kind=kind, name=name, params=canon)


@dataclass
class FeatureSet:
    specs: list[FeatureSpec] = field(default_factory=list)

    def add(self, column: str, kind: str, name: str | None = None,
            **params: Any) -> "FeatureSet":
        self.specs.append(spec(column, kind, name, **params))
        return self

    def columns(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self.specs:
            seen.setdefault(s.column)
        return list(seen)

    def build(self, table: Table) -> dict[str, AugmentedDictionary]:
        """Create/extend AugmentedDictionaries for every spec'd column."""
        out: dict[str, AugmentedDictionary] = {}
        for s in self.specs:
            col = table[s.column]
            aug = out.setdefault(s.column, AugmentedDictionary(col.dictionary))
            params = {k: (np.asarray(v) if isinstance(v, tuple) and k == "boundaries"
                          else (dict(v) if k == "mapping" else v))
                      for k, v in s.params_dict().items()}
            aug.add(s.adv_name, s.kind, **params)
        return out
