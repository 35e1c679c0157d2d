"""Everything the harness knows of a cell, found by name: the cell and its
metrics in ``BENCHMARK.json``, the configuration's file that names, the
traffic mix ``perfbench/traffic/<traffic>.json``, the driver of the mix's
kind ``perfbench/drivers/<kind>.py``, the reference of the configuration's
family ``perfbench/reference/<family>.py``, the limits
``perfbench/limits/<workload>.json`` and each metric's reader
``perfbench/metrics/<metric>.py``. Adding any of them is adding a file
(and an entry in ``BENCHMARK.json``); no code names one."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Cell:
    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_file = json.loads(
            (self.root / configs[self.entry["config"]]["file"]).read_text())
        self.model = dict(self.config_file["model"])
        self.mix = _json(self.root, "traffic", self.entry["traffic"])
        self.limits = _json(self.root, "limits", name)
        self.driver = load(self.root, "drivers", self.mix["kind"])
        self.reference = load(self.root, "reference", self.model["family"])
        self.end_to_end = [m for m in bench["end_to_end"] if self.has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.has(m)]

    def has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _json(root: Path, kind: str, name: str) -> dict:
    return json.loads((root / HERE.name / kind / f"{name}.json").read_text())


_LOADED: dict = {}


def load(root: Path, folder: str, name: str):
    """``perfbench/<folder>/<name>.py`` under ``root`` as a module, loaded
    from its file once."""
    path = (Path(root) / HERE.name / folder / f"{name}.py").resolve()
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{folder}_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(root: Path, metric: str):
    """The ``read(run)`` function of ``perfbench/metrics/<metric>.py``."""
    return load(root, "metrics", metric).read
