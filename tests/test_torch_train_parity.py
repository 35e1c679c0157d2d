"""``repro_torch.train.parity``, the train step's card-against-CPU check
(``chip_smoke.py`` phase 9A), run on the CPU.

Here the "card" is the CPU itself, so every gap is 0; a stand-in card
whose gradients are moved by a stated number of each leaf's std must pass
under the arch's atol and fail past it, and a leaf whose CPU gradient has
no spread admits no difference past rtol at all.
"""
import math

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config, reduced
from repro_torch.train import parity


@pytest.mark.parametrize("arch", ["glm4-9b", "hymba-1.5b"])
def test_check_passes_a_card_equal_to_the_cpu(arch):
    line = parity.check_train_card_matches_cpu(reduced(get_config(arch)),
                                               "cpu", seed=0)
    assert "(worst 0.00e+00 std)" in line
    assert "adamw (max rel 0.00e+00, 0 codes one apart)" in line


def _stand_in(monkeypatch, leaf: str, times: float):
    """Every card step returns the CPU's gradients with ``leaf``'s first
    entry moved ``times`` x the arch's atol of the leaf's std past rtol."""
    real = parity._routed_step

    def routed(cfg, params, batch, cpu_calls, what):
        loss, metrics, grads, note = real(cfg, params, batch, cpu_calls, what)
        g = dict(parity._paths(grads))[leaf].view(-1)
        std = float(g.double().std(correction=0))
        atol = parity.ATOL_BY_ARCH.get(cfg.name, parity.ATOL)
        g[0] += times * atol * std + parity.RTOL * abs(float(g[0]))
        return loss, metrics, grads, note
    monkeypatch.setattr(parity, "_routed_step", routed)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
@pytest.mark.parametrize("times", [0.5, 2.0])
def test_check_holds_each_leaf_to_its_arch_atol(monkeypatch, arch, times):
    _stand_in(monkeypatch, "/embed", times)
    cfg = reduced(get_config(arch))
    if times < 1:
        line = parity.check_train_card_matches_cpu(cfg, "cpu", seed=0)
        atol = parity.ATOL_BY_ARCH.get(arch, parity.ATOL)
        worst = float(line.split("(worst ")[1].split(" std")[0])
        assert worst == pytest.approx(times * atol, rel=0.02)
    else:
        with pytest.raises(AssertionError, match=r"gradient /embed"):
            parity.check_train_card_matches_cpu(cfg, "cpu", seed=0)


def test_gradient_gaps_units_and_zero_spread():
    want = {"a": torch.tensor([1.0, -1.0, 1.0, -1.0]),
            "z": torch.zeros(3)}
    got = pytree.tree_map(torch.clone, want)
    got["a"][0] += 2e-4 + 1e-4 * 1.0       # 2e-4 past rtol, std 1
    got["z"][1] = 1e-30
    gaps = {p: g for p, g, _, _ in parity.gradient_gaps(want, got)}
    assert gaps["/a"] == pytest.approx(2e-4, rel=1e-3)   # float32 near 1
    assert math.isinf(gaps["/z"])
    got["z"][1] = 0.0
    gaps = {p: g for p, g, _, _ in parity.gradient_gaps(want, got)}
    assert gaps["/z"] == 0.0


def test_main_reports_each_seed(capsys):
    parity.main(["--arch", "hymba-1.5b", "--seeds", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "hymba-1.5b seed 0", "hymba-1.5b seed 1"]
    assert all("within atol 1e-05 std" in line for line in out)
