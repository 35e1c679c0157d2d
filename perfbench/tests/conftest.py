"""The benchmark's CPU tests: the checkout's root and ``src`` on the path,
and a tiny copy of the benchmark's tree that a test can run end to end."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# widths a CPU test run holds: two layers, four heads, an odd vocabulary,
# float32 (the program then agrees with the reference to rounding, so the
# cells' limits, set from bf16 at full width, hold a sound run)
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=96,
            vocab=519, vocab_pad_multiple=64, dtype="float32")
TINY_TRAFFIC = {
    "train.s2048": dict(corpus_tokens=50_000),
    "serve.azure-code": dict(batch=2, new_tokens=4, checked_requests=4),
}


def tiny_model(config: str, **over) -> dict:
    """A configuration file's ``model`` at :data:`TINY` widths (its KV
    heads cut in the same ratio)."""
    m = json.loads((ROOT / "perfbench" / "configs" /
                    f"{config}.json").read_text())["model"]
    kv = TINY["n_heads"] if m["n_kv"] == m["n_heads"] else 2
    m.update(TINY, n_kv=kv)
    m.update(over)
    return m


def make_tiny_root(dst: Path, traffic: dict | None = None, **over) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``dst`` whose
    configurations and traffic are cut to :data:`TINY` sizes (``over``
    and ``traffic``, {mix: {key: value}}, on top)."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        f["model"] = tiny_model(c["name"], **over)
        (dst / c["file"]).write_text(json.dumps(f))
    for name, upd in TINY_TRAFFIC.items():
        upd = dict(upd, **(traffic or {}).get(name, {}))
        p = dst / "perfbench" / "traffic" / f"{name}.json"
        p.write_text(json.dumps(dict(json.loads(p.read_text()), **upd)))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)
