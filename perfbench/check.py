"""The judgement that decides ``correct``: each number a cell's driver
reads (its ``readings``, the program's outputs from the timed path held
against the plain reference run after the window on the same inputs; the
numbers are defined in each ``perfbench/drivers/<kind>.py``) against its
limit in ``perfbench/limits/<workload>.json``."""
from __future__ import annotations

import math


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    compared = {k: {"value": values.get(k, float("nan")), "limit": lim}
                for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
