"""The harness's own rules: BENCHMARK.json keeps to the contract, every
name it uses is found as a file, a new cell, configuration or metric is
found by name with no code edited, the run refuses to run without a card,
and nothing it imports is JAX or the JAX package."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, make_tiny_root
from perfbench import harness, spec, weights

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [w["traffic"] for w in BENCH["workloads"]] + \
        [m["name"] for m in METRICS] + \
        [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    lines = [c["why"] for c in BENCH["configs"]] + \
        [w["why"] for w in BENCH["workloads"]] + \
        [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s
               for s in lines)


def test_every_name_is_a_file():
    for c in BENCH["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench/limits" / f"{w['name']}.json").exists()
        assert w["chips"] == 1
    for m in METRICS:
        assert callable(spec.reader(ROOT, m["name"]))


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
    for w in cells:
        cell = spec.Cell(ROOT, w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """Files and a BENCHMARK.json entry added to a copy: the harness runs
    the new cell through the new traffic kind's driver and reports the new
    metric, no code edited."""
    root = make_tiny_root(tmp_path)
    cfg = json.loads((root / "perfbench/configs/glm4-9b.json").read_text())
    cfg["name"] = cfg["model"]["name"] = "glm4-9b-twin"
    (root / "perfbench/configs/glm4-9b-twin.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/serve.azure-code.json")
                     .read_text())
    mix.update(kind="serve_counted", batch=3, prompt_len=5, new_tokens=3,
               max_len=8)
    (root / "perfbench/traffic/serve.tiny.json").write_text(json.dumps(mix))
    (root / "perfbench/drivers/serve_counted.py").write_text(
        "from perfbench.drivers.serve_batch import control, faults, "
        "readings\n"
        "from perfbench.drivers.serve_batch import run as batches\n\n\n"
        "def run(cell, *a, **k):\n"
        "    out = batches(cell, *a, **k)\n"
        "    out.counted = out.units\n"
        "    return out\n")
    (root / "perfbench/limits/glm4-9b-twin.serve.tiny.json").write_text(
        json.dumps({"served_logit_gap": 1.0}))
    (root / "perfbench/metrics/batches_done.py").write_text(
        "def read(run):\n    return float(run.counted)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="glm4-9b-twin",
                                 file="perfbench/configs/glm4-9b-twin.json"))
    bench["workloads"].append({"name": "glm4-9b-twin.serve.tiny",
                               "config": "glm4-9b-twin",
                               "traffic": "serve.tiny", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_tok_per_s", "request_p95_ms"):
            m["workloads"].append("glm4-9b-twin.serve.tiny")
    bench["end_to_end"].append({"name": "batches_done", "unit": "batches",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["glm4-9b-twin.serve.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, log = harness.run_cell(root, "glm4-9b-twin.serve.tiny", 3, 0.0,
                                   False, torch.device("cpu"),
                                   time.perf_counter())
    assert result["correct"] and result["attempted"] == 6   # 4 checked
    assert set(result["metrics"]) == {"setup_s", "serve_tok_per_s",
                                      "request_p95_ms", "batches_done"}
    assert result["metrics"]["batches_done"]["value"] == 2.0
    assert list(result)[-1] == "compared"
    assert log[-1].startswith("served_logit_gap ")


def test_a_new_family_finds_its_reference_by_name(tmp_path):
    """A configuration of a family the benchmark has not had: its cell
    takes the reference ``perfbench/reference/<family>.py`` and the weights'
    layout that file lists."""
    root = make_tiny_root(tmp_path)
    (root / "perfbench/reference/dense_twin.py").write_text(
        "from perfbench.reference.dense import *  # noqa: F401,F403\n"
        "from perfbench.reference.dense import shapes as dense_shapes\n\n"
        "\n"
        "def shapes(model):\n"
        "    return dense_shapes(model) + [('extra', (3,), 'ones')]\n")
    cfg_file = root / "perfbench/configs/glm4-9b.json"
    cfg = json.loads(cfg_file.read_text())
    cfg["model"]["family"] = "dense_twin"
    cfg_file.write_text(json.dumps(cfg))
    cell = spec.Cell(root, "glm4-9b.serve.azure-code")
    assert cell.reference.__file__ == str(
        (root / "perfbench/reference/dense_twin.py").resolve())
    params = weights.make(cell.reference, cell.model, 5,
                          torch.device("cpu"))
    assert params["extra"].tolist() == [1.0, 1.0, 1.0]
    assert set(params["blocks"][0]["attn"]) == {"wq", "wk", "wv", "wo",
                                                "bq", "bk", "bv"}


def test_no_card_exits_nonzero_with_a_clear_line(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
         "glm4-9b.serve.azure-code", "--seed", "2147483701", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_nothing_imported_is_jax_or_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import perfbench.harness, perfbench.drivers.train, "
            "perfbench.drivers.serve_batch, perfbench.check, "
            "perfbench.calibrate, perfbench.reference.dense; "
            "import repro_torch.models.lm, repro_torch.serve.engine, "
            "repro_torch.train.trainer, repro_torch.data; "
            "from perfbench import harness; print(harness.forbidden_modules())"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert out.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
