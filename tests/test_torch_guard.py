"""Guards on the port's boundaries.

The port never imports JAX or the reference package — not even a jax-free
module of it — so it runs where JAX does not exist; only these tests import
both. And a plan asked for the default device runs on CUDA or refuses: no
quiet CPU fallback.
"""
import ast
import pathlib

import pytest
import torch

import repro_torch
from repro_torch.columnar import Table
from repro_torch.core import FeaturePipeline, FeaturePlan, FeatureSet
from repro_torch.core.pipeline import resolve_device

ROOT = pathlib.Path(repro_torch.__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "repro")
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_never_imports_jax_or_the_reference(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _tiny():
    return (Table.from_data({"a": [1, 2, 3, 2]}),
            FeatureSet().add("a", "onehot"))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table, fs = _tiny()
    for make in (lambda: FeaturePlan(table, fs),
                 lambda: FeaturePlan(table, fs, packed=True),
                 lambda: FeaturePipeline(table, fs),
                 lambda: FeaturePlan(table, fs, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_entry_points_default_to_cuda(monkeypatch):
    """Wide&Deep's entry points make tensors on ``cuda`` unless the caller
    names another device, and raise without CUDA."""
    from repro_torch.core.cycle import analytics_cycle
    from repro_torch.models import widedeep as wd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = wd.WideDeepConfig(wide_cards=(3,), deep_dim=2, hidden=(4,))
    params = wd.init_widedeep(cfg, torch.Generator(), device="cpu")
    for make in (lambda: wd.init_widedeep(cfg, torch.Generator()),
                 lambda: wd.params_from_reference(wd.params_to_numpy(params)),
                 lambda: analytics_cycle(steps=(1, 1))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.cuda
def test_default_device_is_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert resolve_device().type == "cuda"
