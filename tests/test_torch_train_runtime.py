"""Port parity, the training runtime: ``repro_torch.train`` (optimizers,
schedules, checkpoints, fault tolerance) on the CPU.

Every test of ``tests/test_train_runtime.py`` runs on the port (the
gradient compression's on both packages, the port's codes and scales
equal to the reference's bit for bit), plus:
one ``apply_updates`` of each optimizer against the reference's from the
same parameters, gradients and state (rtol 1e-6 / atol 1e-8: the same
float32 operations, rounded once each, the global norm summed in another
order; AdamW8's codes at most 8 a leaf one apart); the schedules at every
step, WSD and constant equal float32 for float32, cosine within rtol 1e-6
(XLA's float32 cos is its own approximation); and a checkpoint
written by the reference restored by the port and the reverse, bfloat16
leaves included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.utils import _pytree as pytree

from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro_torch.models import lm
from repro_torch.train import checkpoint as ck
from repro_torch.train.fault import (FaultLog, StragglerDetector,
                                     plan_elastic_mesh)
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         clip_by_global_norm,
                                         dequantize_blockwise, global_norm,
                                         init_opt_state,
                                         opt_state_from_reference,
                                         opt_state_to_numpy,
                                         quantize_blockwise)
from repro_torch.train.schedule import SCHEDULES, warmup_cosine, wsd

UPD = dict(rtol=1e-6, atol=1e-8)


def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 16))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((16,))
                                  .astype(np.float32))}


def _quadratic_grads(params, target):
    return pytree.tree_map(lambda x, t: 2 * (x - t), params, target)


def _sumsq(params):
    return float(sum(float((x ** 2).sum())
                     for x in pytree.tree_leaves(params)))


@pytest.mark.parametrize("name", ["adamw", "adamw8", "adafactor"])
def test_optimizer_descends(name):
    params = _toy_params()
    target = pytree.tree_map(torch.zeros_like, params)
    opt = OptConfig(name=name, lr=0.05, weight_decay=0.0)
    state = init_opt_state(opt, params)
    loss0 = _sumsq(params)
    for _ in range(60):
        grads = _quadratic_grads(params, target)
        params, state = apply_updates(opt, grads, state, params, 0.05)
    loss1 = _sumsq(params)
    assert loss1 < 0.2 * loss0, (name, loss0, loss1)


def test_adamw8_tracks_adamw():
    """Quantized states follow full-precision trajectory closely."""
    p1 = _toy_params(1)
    p2 = pytree.tree_map(torch.clone, p1)
    target = pytree.tree_map(torch.zeros_like, p1)
    o1, o2 = OptConfig("adamw", weight_decay=0), OptConfig("adamw8",
                                                           weight_decay=0)
    s1, s2 = init_opt_state(o1, p1), init_opt_state(o2, p2)
    for _ in range(20):
        g1 = _quadratic_grads(p1, target)
        g2 = _quadratic_grads(p2, target)
        p1, s1 = apply_updates(o1, g1, s1, p1, 0.01)
        p2, s2 = apply_updates(o2, g2, s2, p2, 0.01)
    for a, b in zip(pytree.tree_leaves(p1), pytree.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.15,
                                   atol=0.10)
    l1, l2 = _sumsq(p1), _sumsq(p2)
    assert abs(l1 - l2) / max(l1, 1e-9) < 0.15


@given(st.integers(0, 10_000), st.integers(64, 600))
@settings(max_examples=25, deadline=None)
def test_quantize_roundtrip_error_bound(seed, rows):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((rows, 512)) * 10)
                         .astype(np.float32))
    d = quantize_blockwise(x)
    if not isinstance(d, dict):          # below QUANT_MIN_SIZE stays f32
        assert torch.equal(d, x)
        return
    y = dequantize_blockwise(d)
    err = (x - y).abs().numpy()
    bound = d["scale"].numpy()[:, None] * 0.5 * (1 + 1e-4) + 1e-6
    assert (err <= bound).all()
    assert d["q"].shape == x.shape and d["q"].dtype == torch.int8
    # and the reference's codes and scales, bit for bit
    want = jopt.quantize_blockwise(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(d["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(d["scale"].numpy(),
                                  np.asarray(want["scale"]))


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_global_norm_squares_in_the_gradient_dtype():
    """bf16 gradients: squared in bf16, summed in float32, as the
    reference's jnp.sum(jnp.square(g), dtype=f32)."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 48)).astype(np.float32)
    t = torch.from_numpy(g).to(torch.bfloat16)
    j = jnp.asarray(g, jnp.bfloat16)
    np.testing.assert_allclose(float(global_norm({"g": t})),
                               float(jopt.global_norm({"g": j})), rtol=1e-6)
    clipped, _ = clip_by_global_norm({"g": t}, 1.0)
    assert clipped["g"].dtype == torch.bfloat16


# -- the reference's update from the same state -------------------------------------
def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 64, 400), "e": (300, 256), "b": (16,),
              "s": (2, 40, 30), "h": (2, 128, 600)}
    return {k: (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in sorted(shapes.items())}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(port, ref):
    flat_p = jax.tree_util.tree_flatten_with_path(port)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_p] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:
            # a code whose float32 input lies within rounding of a half
            # step may round the other way (the int8 KV quantizer's rule)
            d = np.abs(a.astype(np.int16) - b)
            assert d.max() <= 1 and (d > 0).sum() <= 8, (path, d.sum())
        else:
            np.testing.assert_allclose(a, b, err_msg=str(path), **UPD)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["adamw", "adamw8", "adafactor"])
def test_apply_updates_matches_reference(name, steps):
    """The reference takes ``steps`` updates; the port then takes the next
    one from the reference's parameters and state, beside the reference's
    own next one. At 3 steps AdamW8's stacked leaves under QUANT_MIN_SIZE
    a group have come back unquantized, as the reference's do."""
    cfg = jopt.OptConfig(name=name, lr=1e-2)
    params = _j(_tree(0))
    state = jopt.init_opt_state(cfg, params)
    for i in range(steps):
        params, state = jopt.apply_updates(cfg, _j(_tree(10 + i, 0.3)),
                                           state, params, jnp.float32(1e-2))
    grads = _tree(20, 0.3)
    lr = jnp.float32(3e-3)
    want = jax.tree.map(np.asarray, jopt.apply_updates(cfg, _j(grads), state,
                                                       params, lr))
    p = lm.params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    s = opt_state_from_reference(jax.tree.map(np.asarray, state), "cpu")
    assert s["step"] == steps
    p, s = apply_updates(OptConfig(name=name, lr=1e-2),
                         lm.params_from_reference(grads, "cpu"), s, p,
                         torch.tensor(3e-3))
    _assert_tree_close((lm.params_to_numpy(p), opt_state_to_numpy(s)), want)


def test_apply_updates_bf16_params_round_once():
    """A bf16 parameter is updated in float32 and rounded once, as the
    reference's (p - lr * update).astype(p.dtype)."""
    rng = np.random.default_rng(6)
    p = rng.standard_normal((64, 32)).astype(np.float32)
    g = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    cfg = jopt.OptConfig(name="adamw", lr=1e-2)
    jp = {"p": jnp.asarray(p, jnp.bfloat16)}
    jg = {"p": jnp.asarray(g, jnp.bfloat16)}
    want, _ = jopt.apply_updates(cfg, jg, jopt.init_opt_state(cfg, jp), jp,
                                 jnp.float32(1e-2))
    tp = {"p": torch.from_numpy(p).to(torch.bfloat16)}
    tg = {"p": torch.from_numpy(g).to(torch.bfloat16)}
    got, _ = apply_updates(OptConfig(name="adamw", lr=1e-2), tg,
                           init_opt_state(OptConfig(), tp), tp,
                           torch.tensor(1e-2))
    assert got["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["p"].float().numpy(),
        np.asarray(jnp.asarray(want["p"], jnp.float32)))


# -- schedules ---------------------------------------------------------------------
def test_wsd_shape():
    lr = [float(wsd(s, peak_lr=1.0, warmup=10, total=100, decay_frac=0.2))
          for s in range(100)]
    assert lr[0] == 0.0
    assert lr[9] == pytest.approx(0.9)
    assert lr[40] == pytest.approx(1.0)          # stable phase
    assert lr[79] == pytest.approx(1.0)
    assert lr[99] < 0.05                          # decayed
    d = np.diff(lr[80:])
    assert (d <= 1e-6).all()                      # monotone decay


def test_cosine_shape():
    lr = [float(warmup_cosine(s, peak_lr=1.0, warmup=10, total=100))
          for s in range(100)]
    assert lr[9] == pytest.approx(0.9)
    assert max(lr) <= 1.0 + 1e-6
    assert lr[-1] < 0.2


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak_lr=1e-2, warmup=10, total=100)),
    ("cosine", dict(peak_lr=3e-3, warmup=2, total=12, final_frac=0.05)),
    ("wsd", dict(peak_lr=3e-3, warmup=2, total=12)),
    ("wsd", dict(peak_lr=1.0, warmup=10, total=100, decay_frac=0.2)),
    ("constant", dict(peak_lr=3e-4, warmup=5, total=50))])
def test_schedules_equal_reference_at_every_step(name, kw):
    for step in range(kw["total"] + 3):
        got = SCHEDULES[name](step, **kw)
        want = np.asarray(jsched.SCHEDULES[name](step, **kw))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        if name == "cosine":
            # XLA's float32 cos is its own approximation (about 1% of
            # arguments a ulp off the correctly rounded value, torch's
            # elsewhere); 1 + cos near -1 magnifies that ulp a few times
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=str(step))
        else:
            assert got.numpy() == want, (name, step, float(got),
                                         float(want))


# -- checkpoint --------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = {"params": _toy_params(), "step": torch.tensor(7)}
    ck.save(str(tmp_path), 10, tree, extra={"note": "x"})
    ck.save(str(tmp_path), 20, tree)
    assert ck.latest_steps(str(tmp_path)) == [10, 20]
    step, restored, extra = ck.restore_latest(str(tmp_path), tree,
                                              device="cpu")
    assert step == 20
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])


def test_checkpoint_async_and_gc(tmp_path):
    saver = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _toy_params()
    for step in (1, 2, 3, 4):
        saver.save_async(step, tree)
    saver.wait()
    assert ck.latest_steps(str(tmp_path)) == [3, 4]


def test_checkpoint_structure_mismatch(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(str(tmp_path), 1, {"b": torch.zeros(3)}, device="cpu")


def _mixed_tree(seed):
    """Parameters in bf16 and float32, an AdamW8 state with int8 codes, a
    step counter: every kind of leaf a train checkpoint holds."""
    rng = np.random.default_rng(seed)
    p = {"embed": rng.standard_normal((40, 8)), "blocks": [
        {"wq": rng.standard_normal((2, 8, 8)), "ln": np.ones((2, 8))}]}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    params["router"] = jnp.asarray(rng.standard_normal((8, 4)), jnp.float32)
    opt = jopt.init_opt_state(jopt.OptConfig(name="adamw8"), params)
    return {"params": params, "opt": opt}


def test_checkpoint_reference_written_port_restores(tmp_path):
    tree = _mixed_tree(0)
    jck.save(str(tmp_path), 5, tree, extra={"who": "reference"})
    like = {"params": lm.params_from_reference(
        jax.tree.map(np.asarray, tree["params"]), "cpu"),
        "opt": opt_state_from_reference(jax.tree.map(np.asarray,
                                                     tree["opt"]), "cpu")}
    step, got, extra = ck.restore_latest(str(tmp_path), like, device="cpu")
    assert step == 5 and extra == {"who": "reference"}
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"] == 0
    _assert_tree_close(
        (lm.params_to_numpy(got["params"]), opt_state_to_numpy(got["opt"])),
        (jax.tree.map(np.asarray, tree["params"]),
         jax.tree.map(np.asarray, tree["opt"])))


def test_checkpoint_port_written_reference_restores(tmp_path):
    tree = _mixed_tree(1)
    port = {"params": lm.params_from_reference(
        jax.tree.map(np.asarray, tree["params"]), "cpu"),
        "opt": opt_state_from_reference(jax.tree.map(np.asarray,
                                                     tree["opt"]), "cpu")}
    port["opt"]["step"] = 3
    ck.save(str(tmp_path), 7, port, extra={"who": "port"})
    step, got, extra = jck.restore_latest(str(tmp_path), tree)
    assert step == 7 and extra == {"who": "port"}
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        assert __import__("json").load(f)["names"] == names
    # the reference's np.load gives the raw 2-byte records of a bf16 leaf,
    # as it does for its own checkpoints: their bits are the port's
    emb = got["params"]["embed"]
    assert emb.dtype == np.dtype("V2")
    np.testing.assert_array_equal(
        emb.view(np.int16),
        port["params"]["embed"].view(torch.int16).numpy())
    assert int(got["opt"]["step"]) == 3
    np.testing.assert_array_equal(
        got["params"]["router"], port["params"]["router"].numpy())


# -- fault tolerance ---------------------------------------------------------------------
def test_straggler_detector_flags_outliers():
    det = StragglerDetector(warmup=3)
    flagged = [det.observe(i, 1.0 + 0.01 * (i % 3)) for i in range(20)]
    assert not any(flagged)
    assert det.observe(20, 5.0) is True
    assert det.straggler_fraction > 0
    assert det.mean < 1.1


def test_plan_elastic_mesh():
    p = plan_elastic_mesh(256, model_parallel=16)
    assert p.shape == (16, 16)
    p = plan_elastic_mesh(240, model_parallel=16)   # lost a host of 16
    assert p.shape == (15, 16) and p.n_devices == 240
    p = plan_elastic_mesh(512, model_parallel=16, multi_pod=True)
    assert p.shape == (2, 16, 16)
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, model_parallel=16)


# -- gradient compression (test_train_runtime.py:168-184) ----------------------------
@given(st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_compression_roundtrip_property(seed):
    """The reference's property on both packages, and the port's codes,
    scales and round trip equal to the reference's bit for bit."""
    from repro.distributed import compression as jcomp
    from repro_torch.distributed import compression as comp
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * rng.uniform(0.1, 10)).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    y_ref = np.asarray(jcomp.compress_decompress(jnp.asarray(x)))
    y = comp.compress_decompress(torch.from_numpy(x)).numpy()
    for got in (y_ref, y):
        assert float(np.abs(x - got).max()) <= scale * 0.51 + 1e-6
    np.testing.assert_array_equal(y, y_ref)
    q_ref, s_ref = jcomp.quantize(jnp.asarray(x))
    q, s = comp.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_compression_ratio():
    from repro.distributed import compression as jcomp
    from repro_torch.distributed import compression as comp
    r = comp.compression_ratio({"w": torch.zeros(1024, 1024)})
    assert 3.5 < r < 4.01
    assert r == jcomp.compression_ratio({"w": jnp.zeros((1024, 1024))})


def test_fault_log_summary():
    log = FaultLog()
    log.record(3, "straggler", "1.2s")
    log.record(4, "straggler")
    log.record(10, "restart", "resumed from step 10")
    assert log.summary() == {"straggler": 2, "restart": 1}
    assert log.events[2].step == 10 and log.events[2].kind == "restart"
