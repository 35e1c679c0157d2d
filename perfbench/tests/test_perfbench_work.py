"""The yardstick's arithmetic: the operations behind ``mfu.*`` and the
least times behind ``gemm_roofline.*``, against counts worked by hand
(PERF.md, section 4, for the full-size cells)."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT
from perfbench import peaks, work


def _model(name):
    return json.loads((ROOT / "perfbench" / "configs" /
                       f"{name}.json").read_text())["model"]


# d 4, 2 heads of 2 over 1 KV head, d_ff 6, one layer, 10 ids
SMALL = dict(d_model=4, n_heads=2, n_kv=1, d_head=2, d_ff=6, n_layers=1,
             vocab=10)


def test_small_counts_by_hand():
    # wq 4x4, wk 4x2, wv 4x2, wo 4x4, wg/wu 4x6, wd 6x4; head 4x10
    assert work.matmul_params(SMALL) == 16 + 8 + 8 + 16 + 72 + 40
    # one row of 3 tokens: 6 x 160 x 3, and six products of 2 x 2 heads
    # x 2 dims over the 6 causal pairs
    assert work.train_flops(SMALL, 1, 3) == 6 * 160 * 3 + 6 * 2 * 2 * 2 * 6
    # serve 2 prompts of 3, 2 new: 4 tokens fed through the stack (120
    # weights), the head at 2 x 2 sampled tokens, QK^T and p.v over 2 x
    # (3 x 4 / 2 + 4) pairs
    assert work.serve_flops(SMALL, 2, 3, 2) == \
        2 * 120 * 2 * 4 + 2 * 40 * 2 * 2 + 4 * 2 * 2 * 2 * 10
    # a (3, 2) by (2, 4) product in bf16: 48 operations, 26 elements
    assert work._product(3, 4, 2, 2) == (48, 52)


@pytest.mark.parametrize("args", [("train", 1, 3), ("serve", 2, 3, 2),
                                  ("train", 2, 17), ("serve", 3, 5, 4)])
def test_products_sum_to_the_work(args):
    kind, *shape = args
    prods = (work.train_products if kind == "train" else
             work.serve_products)(SMALL, *shape)
    flops = (work.train_flops if kind == "train" else
             work.serve_flops)(SMALL, *shape)
    assert sum(ops for ops, _ in prods) == flops


def test_least_time_is_the_larger_bound():
    assert work.least_seconds([(peaks.BF16_FLOPS, 1)]) == 1.0
    assert work.least_seconds([(1, peaks.HBM_BYTES_PER_S * 2)]) == 2.0


def test_full_size_counts_by_hand():
    m, g = _model("minicpm-2b"), _model("glm4-9b")
    assert work.matmul_params(m) == 2_724_694_272
    assert work.matmul_params(g) == 8_778_678_272
    assert work.train_flops(m, 2, 2048) == 71_602_916_032_512
    # glm4-9b.serve.azure-code: 8 prompts of 1,500, 13 new; the stack
    # (8,157,921,280 weights) at 8 x 1,512 fed tokens, the head
    # (620,756,992) at 8 x 13 sampled, QK^T and p.v over 8 x 1,143,828
    # causal pairs (1,500 x 1,501 / 2, then 1,501 ... 1,512 keys)
    assert work.serve_flops(g, 8, 1500, 13) == \
        2 * 8_157_921_280 * 8 * 1512 + 2 * 620_756_992 * 8 * 13 + \
        40 * 4 * 32 * 128 * 8 * 1_143_828 == 203_482_502_004_736
    # the least times PERF.md quotes (bf16 peak, memory peak)
    assert work.least_seconds(work.train_products(m, 2, 2048)) == \
        pytest.approx(0.07312, rel=1e-3)
    assert work.least_seconds(work.serve_products(g, 8, 1500, 13)) == \
        pytest.approx(0.2715, rel=1e-3)
