"""The work a step or a batch asks of the chip, counted from the
configuration's shapes, whatever implements it: the operations behind the
``mfu`` metrics, and each dense product's least time behind the
``gemm_roofline`` ones. Kept with the benchmark so that no change to the
program can change its yardstick.

A product is (operations, bytes): 2 m n k operations, and its operands
and result read or written once in the configuration's dtype. Its least
time is the larger of operations at the bf16 tensor-core peak and bytes at
the memory peak (:mod:`perfbench.peaks`).
"""
from __future__ import annotations

from perfbench import peaks


def matmul_params(model: dict) -> int:
    """Weights a token multiplies in the dense family (SwiGLU MLPs): every
    block matrix and the head (the embedding is gathered, not
    multiplied)."""
    d, hd, f = model["d_model"], model["d_head"], model["d_ff"]
    attn = 2 * d * model["n_heads"] * hd + 2 * d * model["n_kv"] * hd
    mlp = 3 * d * f
    return model["n_layers"] * (attn + mlp) + d * model["vocab"]


def train_flops(model: dict, b: int, s: int) -> int:
    """A training step's own work: 6 per weight per token (the forward
    product and the backward's two), and attention's six products (the
    forward's scores and p.v, the backward's dv, dp, dq, dk) over the
    causal pairs only. Recomputation is the design's, not the step's.
    (chip_smoke.py's lm_train_flops_causal, frozen here, with the head
    over the vocabulary's ids rather than its padded rows.)"""
    pairs = b * s * (s + 1) // 2
    return 6 * matmul_params(model) * b * s + \
        model["n_layers"] * 6 * 2 * model["n_heads"] * model["d_head"] * pairs


def serve_flops(model: dict, b: int, plen: int, new: int) -> int:
    """A served batch's own work: 2 per block weight per token through the
    stack (the prompt, then each generated token but the last, which is
    never fed back), the head only where a token is sampled (b x new
    tokens), and QK^T and p.v over the causal pairs of prompt and cache."""
    d, v = model["d_model"], model["vocab"]
    stack = matmul_params(model) - d * v
    fed = plen + new - 1
    pairs = b * fed * (fed + 1) // 2
    return 2 * stack * b * fed + 2 * d * v * b * new + \
        model["n_layers"] * 4 * model["n_heads"] * model["d_head"] * pairs


def _product(m: int, n: int, k: int, nbytes: int, times: int = 1):
    """A product of (m, k) by (k, n), ``times`` over: (ops, bytes)."""
    return (2 * m * n * k * times, (m * k + k * n + m * n) * nbytes * times)


def _layer_products(model: dict, tokens: int) -> list:
    d, hd, f = model["d_model"], model["d_head"], model["d_ff"]
    h, kv = model["n_heads"], model["n_kv"]
    mats = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d),
            (d, f), (d, f), (f, d)]
    return [(tokens, n, k) for k, n in mats]


def train_products(model: dict, b: int, s: int, nbytes: int = 2) -> list:
    """(ops, bytes) of each dense product of one training step: every
    weight product forward and its two backward products, the head's
    three, and attention's six over the causal pairs (a product of S x T
    over dh counted at its causal share of operations, its operands
    once)."""
    t = b * s
    out = []
    for m, n, k in _layer_products(model, t):
        for shape in ((m, n, k), (m, k, n), (k, n, m)):   # y, dx, dw
            out.append(_product(*shape, nbytes, model["n_layers"]))
    v, d = model["vocab"], model["d_model"]
    for shape in ((t, v, d), (t, d, v), (d, v, t)):
        out.append(_product(*shape, nbytes))
    out += _attention_products(model, b, s, s, 6, nbytes)
    return out


def _attention_products(model, b, s, t, count, nbytes, causal=True):
    """``count`` products of S queries over T keys a head and layer:
    operations over the causal pairs (all S x T pairs if not causal), bytes
    of q, k, v and the output once."""
    h, kv, hd, n = (model["n_heads"], model["n_kv"], model["d_head"],
                    model["n_layers"])
    pairs = b * (s * t - s * (s - 1) // 2) if causal else b * s * t
    ops = 2 * h * hd * pairs * n
    by = (2 * b * s * h * hd + 2 * b * t * kv * hd) * nbytes * n
    return [(ops, by)] * count


def serve_products(model: dict, b: int, plen: int, new: int,
                   nbytes: int = 2) -> list:
    """(ops, bytes) of each dense product of one served batch: the prefill
    over the prompt (its head at the last position only), then new - 1
    decode steps of one token a request over a cache of plen + j keys."""
    out = [_product(*shape, nbytes, model["n_layers"])
           for shape in _layer_products(model, b * plen)]
    d, v = model["d_model"], model["vocab"]
    out.append(_product(b, v, d, nbytes))
    out += _attention_products(model, b, plen, plen, 2, nbytes)
    step = [_product(*shape, nbytes, model["n_layers"])
            for shape in _layer_products(model, b)]
    step.append(_product(b, v, d, nbytes))
    for j in range(1, new):
        out += step
        out += _attention_products(model, b, 1, plen + j, 2, nbytes,
                                   causal=False)
    return out


def least_seconds(products: list) -> float:
    """The sum over products of max(ops at the bf16 peak, bytes at the
    memory peak)."""
    return sum(max(ops / peaks.BF16_FLOPS, by / peaks.HBM_BYTES_PER_S)
               for ops, by in products)
