"""The analytics CYCLE (paper §7, Fig 2): learn -> write back -> reuse.

The port of the JAX package's ``examples/analytics_cycle.py``, as a function
that runs on a device. Round 1 trains a Wide&Deep model on hand-designed ADV
features of a column whose true structure is hidden (a scrambled categorical
where the label depends on a latent grouping). The trained per-code
embedding is stored back as a learned ADV, and the round-1 model's logit
for each dictionary code is distilled into a *learned bucketization*
written back into the dictionary (the 'ML G1' column of Table 5). Round 2
trains a smaller model on the learned ADV alone and should match round 1.

The data, seeds, sizes and learning rates are the example's. The models
have no wide columns (``wide_cards=()``), so the wide kernel computes a
zero term and launches nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.columnar import Dictionary
from repro_torch.core.adv import AugmentedDictionary
from repro_torch.core.feedback import learn_bucketization, store_embedding
from repro_torch.core.pipeline import resolve_device, to_device
from repro_torch.models.widedeep import (WideDeepConfig, forward_widedeep,
                                         init_widedeep,
                                         make_widedeep_train_step)

N, K, LATENT, BATCH = 30_000, 200, 4, 512


def analytics_cycle(device=None, steps=(800, 400), init=None) -> dict:
    """Run both rounds on ``device`` (``cuda`` by default) for
    ``steps = (round 1, round 2)`` SGD steps.

    ``init(cfg, seed) -> params`` makes each round's initial parameters
    (default :func:`init_widedeep` from a generator seeded with ``seed``).
    Returns the per-step losses of both rounds (``l1``, ``l2``), their
    means over the last 20 steps (``r1``, ``r2``), the round-1 scores per
    dictionary code, the learned buckets, their purity against the
    decision grouping, the ADVs written back, and the trained parameters
    (``p1``, ``p2``). The example's own checks are ``r2 < 1.2 * r1`` and
    ``purity > 0.75``.
    """
    device = resolve_device(device)
    if init is None:
        def init(cfg, seed):
            return init_widedeep(cfg, torch.Generator().manual_seed(seed),
                                 device)

    rng = np.random.default_rng(7)
    # hidden structure: each of the K codes belongs to one of LATENT groups
    latent_group = rng.integers(0, LATENT, K)
    codes_raw = rng.integers(0, K, N)
    y = (latent_group[codes_raw] >= 2).astype(np.float32)
    noise = rng.random(N) < 0.1
    y = np.where(noise, 1 - y, y)

    d, codes = Dictionary.from_data(codes_raw)
    aug = AugmentedDictionary(d)
    aug.add("hash8", "hash_bucket", n_buckets=8)      # round-1 guess feature

    def train(deep_fn, embed_card, n_steps, dim=8, lr=0.15, seed=0):
        cfg = WideDeepConfig(
            wide_cards=(), deep_dim=deep_fn(codes[:1]).shape[1],
            embed_cols=((embed_card, dim),) if embed_card else (),
            hidden=(16,))
        params = init(cfg, seed)
        step = make_widedeep_train_step(cfg, lr=lr)
        r = np.random.default_rng(seed)
        wide = torch.zeros((0, BATCH), dtype=torch.int32, device=device)
        losses = []
        for _ in range(n_steps):
            idx = r.integers(0, N, BATCH)
            deep = to_device(deep_fn(codes[idx]), device)
            emb = [to_device(codes[idx], device)] if embed_card else None
            params, loss = step(params, wide, deep, to_device(y[idx], device),
                                emb)
            losses.append(loss)
        return params, torch.stack(losses).tolist() if losses else []

    # round 1: hash feature + per-code embedding
    p1, l1 = train(lambda c: aug.featurize("hash8", c), embed_card=K,
                   n_steps=steps[0], lr=0.25)

    # feedback: the round-1 model's logit for each dictionary code, distilled
    # into a count-weighted bucketization
    store_embedding(aug, "emb.round1", p1["embeds"][0].cpu().numpy(),
                    analysis="round1")
    all_codes = np.arange(K, dtype=np.int32)
    cfg1 = WideDeepConfig(wide_cards=(), deep_dim=1, embed_cols=((K, 8),),
                          hidden=(16,))
    with torch.no_grad():
        scores = forward_widedeep(
            cfg1, p1, torch.zeros((0, K), dtype=torch.int32, device=device),
            to_device(aug.featurize("hash8", all_codes), device),
            [to_device(all_codes, device)]).cpu().numpy()
    buckets = learn_bucketization(aug, "ml_g1", scores, n_buckets=LATENT,
                                  analysis="round1-distilled")

    # purity against the decision-relevant grouping: the label exposes only
    # the binary split latent_group >= 2, aligned to dictionary code order
    binary_group = (latent_group[d.values.astype(int)] >= 2).astype(int)
    purity = 0.0
    for b in range(LATENT):
        mask = buckets.astype(int) == b
        if mask.sum():
            purity += max(np.bincount(binary_group[mask], minlength=2)) / K

    # round 2: no embedding, the learned bucketization as a one-hot
    onehot = np.eye(LATENT, dtype=np.float32)

    def deep2(c):
        return onehot[aug.featurize("ml_g1", c)[:, 0].astype(int)]

    p2, l2 = train(deep2, embed_card=0, n_steps=steps[1])
    return {"l1": l1, "l2": l2, "r1": float(np.mean(l1[-20:])),
            "r2": float(np.mean(l2[-20:])), "scores": scores,
            "buckets": buckets, "purity": purity, "advs": sorted(aug.advs),
            "p1": p1, "p2": p2}
