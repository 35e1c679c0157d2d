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


def test_guard_walks_every_port_package():
    """The import walk above covers every package of the port, the serve
    placement rules of ``distributed/`` included."""
    walked = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
              for p in PORT_FILES if p.name != "chip_smoke.py"}
    packages = {p.name for p in (ROOT / "src" / "repro_torch").iterdir()
                if (p / "__init__.py").exists()}
    assert packages <= walked
    assert {"columnar", "configs", "core", "data", "distributed", "kernels",
            "launch", "models", "serve"} <= packages
    assert ROOT / "src" / "repro_torch" / "data" / "tokenstore.py" \
        in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "distributed" / "sharding.py" \
        in PORT_FILES


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


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """The LM's entry points make tensors on ``cuda`` unless the caller
    names another device, and raise without CUDA: no CPU fallback."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("glm4-9b"))
    params = lm.init_params(cfg, 0, device="cpu")
    for make in (lambda: lm.init_params(cfg, 0),
                 lambda: lm.params_from_reference(lm.params_to_numpy(params)),
                 lambda: lm.init_serve_state(cfg, 1, 8),
                 lambda: ServeEngine(cfg, params, batch_size=1, max_len=8),
                 lambda: launch_serve.main(["--preset", "smoke"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_audio_and_data_entry_points_default_to_cuda(monkeypatch):
    """seamless's serve state and the loader's batches go to ``cuda``
    unless a device is named, and raise without CUDA."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    store = TokenStore(synthetic_corpus(1_000, cfg.vocab), cfg.vocab)
    for make in (lambda: lm.init_params(cfg, 0),
                 lambda: lm.init_serve_state(cfg, 1, 8, enc_len=4),
                 lambda: token_batches(store, cfg, batch=1, seq=8),
                 lambda: launch_serve.main(["--arch", cfg.name,
                                            "--preset", "smoke"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.cuda
def test_default_device_is_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert resolve_device().type == "cuda"
