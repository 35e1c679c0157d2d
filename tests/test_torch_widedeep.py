"""Port parity, Wide&Deep and the analytics cycle: ``repro_torch`` against
``repro``.

The reference's parameters (``init_widedeep`` from a JAX key) are carried
into the port with ``params_from_reference``, and the same numpy batches go
through both packages on the CPU. JAX trains with ``use_kernel=False``, the
only setting it can differentiate, so its wide gradient is autodiff through
the jnp gather; the port's runs through ``OneHotWide`` (the plain versions
of its CUDA kernels here). Tolerances: forward, loss and parameters within
rtol 1e-5 / atol 1e-6 (float32 matmuls and sums in another order); per-step
losses of the whole loops within 1e-5; the feedback functions (host numpy
in both packages) exactly equal.
"""
import io
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.columnar import Dictionary as JDictionary, Table as JTable
from repro.core import (AugmentedDictionary as JAug,
                        FeaturePipeline as JPipeline, FeatureSet as JFS)
from repro.core import feedback as jfb
from repro.models import widedeep as jwd
from repro_torch.columnar import Dictionary, Table
from repro_torch.core import AugmentedDictionary, FeaturePipeline, FeatureSet
from repro_torch.core import feedback as fb
from repro_torch.core.cycle import analytics_cycle
from repro_torch.kernels.onehot_wide import ops as wide_ops
from repro_torch.models import widedeep as wd

TOL = dict(rtol=1e-5, atol=1e-6)
VARIANTS = {
    "wide_deep": dict(wide_cards=(5, 3), embed_cols=((5, 4),), n_out=1),
    "n_out_2": dict(wide_cards=(5, 3), embed_cols=((5, 4),), n_out=2),
    "no_wide": dict(wide_cards=(), embed_cols=((5, 4),), n_out=1),
}


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _carry(jparams):
    return wd.params_from_reference(_numpy_tree(jparams), device="cpu")


def _jcfg(cfg):
    """The reference config of a port config (use_kernel stays False)."""
    return jwd.WideDeepConfig(**asdict(cfg))


def _setup(variant, seed=0):
    """``test_widedeep_query._wd_setup`` with the variant's columns."""
    v = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    cfg = wd.WideDeepConfig(wide_cards=v["wide_cards"], deep_dim=4,
                            embed_cols=v["embed_cols"], hidden=(8,),
                            n_out=v["n_out"])
    jparams = jwd.init_widedeep(_jcfg(cfg), jax.random.PRNGKey(seed))
    n = 64
    wide = np.stack([rng.integers(0, card, n)
                     for card in cfg.wide_cards]).astype(np.int32) \
        if cfg.wide_cards else np.zeros((0, n), np.int32)
    deep = rng.standard_normal((n, 4)).astype(np.float32)
    emb = [rng.integers(0, 5, n).astype(np.int32)]
    y = rng.integers(0, 2, n).astype(np.float32)
    # nonzero wide tables and bias, so both terms are exercised
    jparams["wide"] = jnp.asarray(
        rng.standard_normal(jparams["wide"].shape), jnp.float32)
    jparams["bias"] = jnp.asarray(
        rng.standard_normal(jparams["bias"].shape), jnp.float32)
    return cfg, jparams, wide, deep, emb, y


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_loss_match_reference(variant):
    cfg, jparams, wide, deep, emb, y = _setup(variant)
    jcfg = _jcfg(cfg)
    want = jwd.forward_widedeep(jcfg, jparams, *_j(wide, deep), _j(*emb))
    params = _carry(jparams)
    got = wd.forward_widedeep(cfg, params, *_t(wide, deep), _t(*emb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cfg.n_out > 1:
        # the reference leaves the bias out for n_out > 1; so does the port
        params["bias"] = params["bias"] + 100.0
        assert torch.equal(
            wd.forward_widedeep(cfg, params, *_t(wide, deep), _t(*emb)), got)
        return
    jl = jwd.loss_widedeep(jcfg, jparams, *_j(wide, deep, y), _j(*emb))
    tl = wd.loss_widedeep(cfg, params, *_t(wide, deep, y), _t(*emb))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_init_shapes_match_reference():
    for variant in VARIANTS:
        cfg = _setup(variant)[0]
        want = _numpy_tree(jwd.init_widedeep(_jcfg(cfg),
                                             jax.random.PRNGKey(0)))
        got = wd.params_to_numpy(wd.init_widedeep(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype
        assert not got["wide"].any() and not got["bias"].any()


@pytest.mark.parametrize("variant", ["wide_deep", "no_wide"])
def test_train_steps_match_reference(variant):
    """20 SGD steps from carried parameters on fresh batches: per-step
    losses and the parameters after each step agree."""
    cfg, jparams, *_ = _setup(variant)
    rng = np.random.default_rng(1)
    jstep = jwd.make_widedeep_train_step(_jcfg(cfg), lr=0.3)
    step = wd.make_widedeep_train_step(cfg, lr=0.3)
    params = _carry(jparams)
    before = dict(wide_ops.LAUNCHES)
    for _ in range(20):
        n = 64
        wide = np.stack([rng.integers(0, c, n) for c in cfg.wide_cards]) \
            .astype(np.int32) if cfg.wide_cards else np.zeros((0, n),
                                                              np.int32)
        deep = rng.standard_normal((n, 4)).astype(np.float32)
        emb = [rng.integers(0, 5, n).astype(np.int32)]
        y = (rng.random(n) < 0.5).astype(np.float32)
        jparams, jl = jstep(jparams, *_j(wide, deep, y), _j(*emb))
        params, tl = step(params, *_t(wide, deep, y), _t(*emb))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        for g, w in zip(jax.tree.leaves(wd.params_to_numpy(params)),
                        jax.tree.leaves(_numpy_tree(jparams))):
            np.testing.assert_allclose(g, w, **TOL)
    assert wide_ops.LAUNCHES == before        # the CPU runs the plain versions


def test_widedeep_trains():
    """``test_widedeep_query.test_widedeep_trains``, through the port: labels
    that depend on wide code 0 are learned (loss < 0.2 after 120 steps)."""
    cfg, _, wide, deep, emb, _ = _setup("wide_deep")
    params = wd.init_widedeep(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    y = (wide[0] % 2).astype(np.float32)
    step = wd.make_widedeep_train_step(cfg, lr=0.5)
    for _ in range(120):
        params, loss = step(params, *_t(wide, deep, y), _t(*emb))
    assert float(loss) < 0.2


def test_step_leaves_its_input_parameters_alone():
    cfg, jparams, wide, deep, emb, y = _setup("wide_deep")
    params = _carry(jparams)
    kept = wd.params_to_numpy(params)
    new, _ = wd.make_widedeep_train_step(cfg)(params, *_t(wide, deep, y),
                                             _t(*emb))
    for a, b in zip(jax.tree.leaves(wd.params_to_numpy(params)),
                    jax.tree.leaves(kept)):
        assert np.array_equal(a, b)
    assert not np.array_equal(wd.params_to_numpy(new)["wide"], kept["wide"])
    assert not any(t.requires_grad for t in jax.tree.leaves(new))


# -- feedback ----------------------------------------------------------------------


def _augs(seed=2):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 60, 5000) * 7
    return (JAug(JDictionary.from_data(data)[0]),
            AugmentedDictionary(Dictionary.from_data(data)[0]))


def test_feedback_equals_reference():
    jaug, aug = _augs()
    k = aug.dictionary.cardinality
    rng = np.random.default_rng(3)
    scores = rng.standard_normal(k)
    scores[:5] = scores[5]                    # ties sort the same way
    for n_buckets in (1, 4, 7):
        name = f"b{n_buckets}"
        want = jfb.learn_bucketization(jaug, name, scores, n_buckets, "x")
        got = fb.learn_bucketization(aug, name, scores, n_buckets, "x")
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(aug[name].table, jaug[name].table)
        assert aug[name].params == jaug[name].params
    emb = rng.standard_normal((k, 3)).astype(np.float32)
    jfb.store_embedding(jaug, "emb", emb, analysis="r1")
    fb.store_embedding(aug, "emb", emb, analysis="r1")
    assert np.array_equal(aug["emb"].table, jaug["emb"].table)
    assert aug["emb"].params == jaug["emb"].params and aug["emb"].learned
    with pytest.raises(ValueError):
        fb.learn_bucketization(aug, "bad", scores[:-1], 4)
    grads = {f"f{i}": rng.standard_normal((i + 1, 4)) for i in range(6)}
    assert fb.rank_features(grads) == jfb.rank_features(grads)


# -- the slice as a whole --------------------------------------------------------


def _bench_dataset(rng, n):
    """``benchmarks/bench_pipeline._dataset``."""
    age = rng.integers(18, 90, n)
    state = rng.integers(0, 50, n)
    income = rng.integers(20, 250, n) * 1000
    device = rng.integers(0, 4, n)
    y = ((age > 40).astype(float) * 0.5 +
         (income > 100_000).astype(float) * 0.8 +
         (state % 4 == 0).astype(float) * 0.3 +
         rng.standard_normal(n) * 0.3 > 0.8).astype(np.float32)
    return {"age": age, "state": state, "income": income,
            "device": device}, y


def _bench_features(fs_cls):
    return (fs_cls().add("age", "zscore")
            .add("age", "bucketize", boundaries=(30.0, 45.0, 65.0))
            .add("income", "minmax").add("income", "log"))


def test_fig2_train_loop_matches_reference():
    """``bench_pipeline``'s ADV loop at its smoke size (4,000 rows, batch
    128, 3 steps) in both packages from carried parameters and the same
    batches: deep features equal bit for bit, losses within 1e-5. Then the
    traditional loop's CSV round trip feeds the port the same features."""
    n, batch = 4000, 128
    raw, y = _bench_dataset(np.random.default_rng(4), n)
    jpipe = JPipeline(JTable.from_data(raw), _bench_features(JFS))
    table = Table.from_data(raw)
    pipe = FeaturePipeline(table, _bench_features(FeatureSet), device="cpu")
    cfg = wd.WideDeepConfig(wide_cards=(50, 4), deep_dim=pipe.out_dim,
                            embed_cols=((50, 8),), hidden=(32, 16))
    jparams = jwd.init_widedeep(_jcfg(cfg), jax.random.PRNGKey(0))
    jstep = jwd.make_widedeep_train_step(_jcfg(cfg), lr=0.1)
    step = wd.make_widedeep_train_step(cfg, lr=0.1)
    params = _carry(jparams)
    codes = {c: table[c].codes() for c in ("state", "device")}
    rng = np.random.default_rng(5)
    for _ in range(3):
        idx = rng.integers(0, n, batch)
        jdeep = np.asarray(jpipe.batch(idx))
        deep = pipe.batch(idx)
        assert np.array_equal(deep.numpy(), jdeep)
        wide = np.stack([codes["state"][idx], codes["device"][idx]])
        emb = codes["state"][idx]
        jparams, jl = jstep(jparams, *_j(wide, jdeep, y[idx]), _j(emb))
        params, tl = step(params, torch.from_numpy(wide), deep,
                          torch.from_numpy(y[idx]), _t(emb))
        assert abs(float(tl) - float(jl)) <= 1e-5
    # traditional path: decode -> CSV -> parse -> row transforms
    rows = {c: table[c].decode()[idx] for c in ("age", "income")}
    buf = io.StringIO("".join(f"{a},{i}\n" for a, i in
                              zip(rows["age"], rows["income"])))
    parsed = np.loadtxt(buf, delimiter=",", dtype=np.float64)
    a_all = table["age"].decode().astype(np.float64)
    i_all = table["income"].decode().astype(np.float64)
    trad = np.stack([
        (parsed[:, 0] - a_all.mean()) / a_all.std(),
        np.searchsorted([30., 45., 65.], parsed[:, 0], side="right"),
        (parsed[:, 1] - i_all.min()) / (i_all.max() - i_all.min()),
        np.log1p(parsed[:, 1])], axis=1).astype(np.float32)
    np.testing.assert_allclose(trad, deep.numpy(), rtol=1e-5, atol=1e-5)


def _jax_cycle(steps):
    """``examples/analytics_cycle.py`` through the reference, at ``steps``;
    returns the per-step losses, the scores, the buckets and a dict of the
    initial parameters by (deep_dim, embed_cols) for carrying across."""
    rng = np.random.default_rng(7)
    N, K, LATENT = 30_000, 200, 4
    latent_group = rng.integers(0, LATENT, K)
    codes_raw = rng.integers(0, K, N)
    y = (latent_group[codes_raw] >= 2).astype(np.float32)
    noise = rng.random(N) < 0.1
    y = np.where(noise, 1 - y, y)
    d, codes = JDictionary.from_data(codes_raw)
    aug = JAug(d)
    aug.add("hash8", "hash_bucket", n_buckets=8)
    inits = {}

    def train(deep_fn, embed_card, n_steps, dim=8, lr=0.15, seed=0):
        cfg = jwd.WideDeepConfig(
            wide_cards=(), deep_dim=deep_fn(codes[:1]).shape[1],
            embed_cols=((embed_card, dim),) if embed_card else (),
            hidden=(16,))
        params = jwd.init_widedeep(cfg, jax.random.PRNGKey(seed))
        inits[(cfg.deep_dim, cfg.embed_cols)] = _numpy_tree(params)
        step = jwd.make_widedeep_train_step(cfg, lr=lr)
        r = np.random.default_rng(seed)
        wide = jnp.zeros((0, 512), jnp.int32)
        losses = []
        for _ in range(n_steps):
            idx = r.integers(0, N, 512)
            emb = [jnp.asarray(codes[idx])] if embed_card else None
            params, loss = step(params, wide, jnp.asarray(deep_fn(codes[idx])),
                                jnp.asarray(y[idx]), emb)
            losses.append(float(loss))
        return params, losses

    p1, l1 = train(lambda c: aug.featurize("hash8", c), K, steps[0], lr=0.25)
    all_codes = np.arange(K, dtype=np.int32)
    cfg1 = jwd.WideDeepConfig(wide_cards=(), deep_dim=1,
                              embed_cols=((K, 8),), hidden=(16,))
    scores = np.asarray(jwd.forward_widedeep(
        cfg1, p1, jnp.zeros((0, K), jnp.int32),
        jnp.asarray(aug.featurize("hash8", all_codes)),
        [jnp.asarray(all_codes)]))
    buckets = jfb.learn_bucketization(aug, "ml_g1", scores, n_buckets=LATENT)
    onehot = np.eye(LATENT, dtype=np.float32)
    _, l2 = train(lambda c: onehot[aug.featurize("ml_g1", c)[:, 0]
                                   .astype(int)], 0, steps[1])
    return l1, l2, scores, buckets, inits


def test_analytics_cycle_matches_reference():
    """The §7 cycle at 40 + 20 steps in both packages, each round from the
    reference's initial parameters and on the same batches: per-step losses
    within 1e-5, the same learned buckets."""
    l1, l2, scores, buckets, inits = _jax_cycle((40, 20))
    got = analytics_cycle(
        "cpu", steps=(40, 20),
        init=lambda cfg, seed: wd.params_from_reference(
            inits[(cfg.deep_dim, cfg.embed_cols)], device="cpu"))
    np.testing.assert_allclose(got["l1"], l1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["l2"], l2, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"], scores, **TOL)
    assert np.array_equal(got["buckets"], buckets)
    assert got["advs"] == ["emb.round1", "hash8", "ml_g1"]
