"""``chip_smoke.py``'s train parity check (phase 5), run on the CPU.

The check holds each of the card's train steps to the CPU's step from the
same parameters. Here the "card" is the CPU itself, its deep features
scaled row by row by 1 + noise x a fixed pattern of the row, a stand-in
for another device's rounding. The check must pass a card equal to the
CPU; pass one whose steps miss the tolerances only through rows whose ReLU
branch differs (it steps them again without those rows); and fail one
whose steps differ on every row.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.columnar import Table  # noqa: E402
from repro_torch.core import FeaturePipeline, FeatureSet  # noqa: E402
from repro_torch.core.pipeline import to_device  # noqa: E402
from repro_torch.kernels.adv_gather import ops  # noqa: E402
from repro_torch.kernels.onehot_wide import ops as wide_ops  # noqa: E402
from repro_torch.models import widedeep as wd  # noqa: E402

STEPS = 40


class CheckFailed(Exception):
    pass


@pytest.fixture(scope="module")
def train_data():
    raw = cs.serving_data(np.random.default_rng(0), 1 << 16)
    table = Table.from_data(raw)
    y = cs.bench_labels(raw, np.random.default_rng(5))
    pipe = FeaturePipeline(table, cs.bench_features(FeatureSet), device="cpu")
    wide_codes = {c: table[c].codes() for c in ("state", "device")}
    return table, y, pipe, wide_codes


def run_check(train_data, noise, monkeypatch):
    table, y, pipe, wide_codes = train_data

    def fail(msg):
        raise CheckFailed(msg)

    clean = pipe.batch

    def card_batch(idx):
        f = clean(idx)
        pattern = np.sin(idx[:, None] * 12.9898 + np.arange(f.shape[1]) * 78.233)
        return f * (1 + noise * torch.from_numpy(pattern).float())

    monkeypatch.setattr(cs, "fail", fail)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(pipe, "batch", card_batch)
    kernels = {k: {"ms": 0.0} for k in
               ("gather_fused_parts", "onehot_wide", "onehot_wide_backward")}
    parity = cs.train_path(wd, to_device, ops, wide_ops, pipe, table,
                           wide_codes, y, 0, torch.device("cpu"), kernels,
                           steps=STEPS, drift_steps=STEPS)
    parity()


@pytest.mark.parametrize("noise,restepped", [(0.0, 0), (1e-5, None)])
def test_parity_check_passes(train_data, noise, restepped, monkeypatch,
                             capsys):
    run_check(train_data, noise, monkeypatch)
    out = capsys.readouterr().out
    n = int(re.search(r"ReLU branches differ: (\d+) of %d" % STEPS,
                      out).group(1))
    if restepped is None:
        # every step that missed was held again without its split rows
        assert n >= 1 and "rows left out" in out
    else:
        assert n == restepped
        assert "largest parameter difference 0.0 " in out


def test_parity_check_fails_on_a_real_difference(train_data, monkeypatch):
    with pytest.raises(CheckFailed, match="train parity"):
        run_check(train_data, 1e-2, monkeypatch)
