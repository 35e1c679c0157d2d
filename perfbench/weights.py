"""The model's weights, made from the run's seed on the device, in the
layout the configuration's family takes: the leaves its reference module
lists (``shapes(model)``: dotted path, shape, init), nested as the path
says, with ``blocks`` a list.

Each leaf is drawn by one ``torch.randn`` call in the configuration's
dtype, from a generator of its own on the device seeded from (seed, leaf
number), so a leaf can be made again alone (:func:`leaf`): the reference
and the check of the parameters' change read the same numbers without a
copy being kept. Inits: ``embed`` N(0, 1), ``dense`` N(0, 1/fan_in) (the
second-to-last dimension), ``bias`` N(0, 1/4), ``ones`` 1; as
``repro_torch.models.layers`` draws them, but for the biases, which the
port starts at zero: drawn, a bias left out or added twice shows.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
BIAS_STD = 0.5


def leaf(ref, model: dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf number ``index`` of ``ref.shapes(model)``, drawn as
    :func:`make` draws it."""
    _, shape, init = ref.shapes(model)[index]
    dt = DTYPES[model["dtype"]]
    if init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + index) % (1 << 63))
    t = torch.randn(shape, generator=gen, dtype=dt, device=device)
    if init == "dense":
        t.mul_(1.0 / math.sqrt(shape[-2]))
    elif init == "bias":
        t.mul_(BIAS_STD)
    return t


def make(ref, model: dict, seed: int, device) -> dict:
    """Every leaf, nested as the program takes them."""
    tree: dict = {}
    for i, (path, _, _) in enumerate(ref.shapes(model)):
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf(ref, model, seed, i, device)
    tree["blocks"] = [tree["blocks"][k] for k in sorted(tree["blocks"],
                                                         key=int)]
    return tree
