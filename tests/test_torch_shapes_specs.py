"""Port parity: the dry-run's input shapes and the sharding rules.

``repro_torch.configs.shapes`` against ``repro.configs.shapes`` (the same
four shapes, the same skip rule, ``meta`` tensors of the reference's
``ShapeDtypeStruct`` shapes and dtypes), and the sharding rules of
``repro_torch.distributed.sharding`` (parameters, batches, serve states,
ZeRO-1 optimizer states) equal to the reference's, leaf by leaf, for all
ten archs at full size on the meshes (2, 4), (16, 16), (2, 16, 16),
(32, 8) and (2, 32, 8). The rules read only a mesh's axis sizes, so both
run on ``SimpleNamespace(shape=...)`` with no device. ``fsdp`` is passed
to both, so the port's auto-FSDP threshold (30e9 bf16 bytes a model
shard, 3/8 of an 80 GB H100, against the reference's 6e9 for a 16 GB
chip) is compared on its own; so is ``pick_optimizer``'s. Then the H100
meshes, the placements, and the activation constraints' no-op without a
mesh.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as rconfigs
from repro.distributed import sharding as rshd
from repro.models import lm as rlm
from repro.train.optimizer import OptConfig as ROptConfig
from repro.train.optimizer import init_opt_state as rinit_opt_state
from repro.train.trainer import _opt_pspecs
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import (activation_mesh,
                                             constrain_last,
                                             constrain_residual, local_call,
                                             residual_add, seq_whole)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     probe_shape)
from repro_torch.models import lm
from repro_torch.train.optimizer import OptConfig, init_opt_state

ARCHS = configs.ARCH_IDS
MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}
KEY = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _mesh(name):
    return types.SimpleNamespace(shape=MESHES[name])


def _ref_specs(tree):
    """The reference's spec tree -> {path: entries, padded to the leaf's
    rank by None}: jax's key paths print as torch's do."""
    return {jax.tree_util.keystr(k): tuple(v) for k, v in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _port_specs(tree):
    return {pytree.keystr(k): tuple(v)
            for k, v in pytree.tree_leaves_with_path(tree)}


def _padded(ref: dict, shapes: dict) -> dict:
    return {k: v + (None,) * (len(shapes[k]) - len(v)) if k in shapes else v
            for k, v in ref.items()}


def _shapes(tree, port: bool) -> dict:
    if port:
        return {pytree.keystr(k): tuple(v.shape)
                for k, v in pytree.tree_leaves_with_path(tree)
                if isinstance(v, torch.Tensor)}
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)
            if hasattr(v, "shape")}


def _assert_same(ref_tree, port_tree, ref_shapes):
    ref = _padded(_ref_specs(ref_tree), ref_shapes)
    got = _port_specs(port_tree)
    assert set(ref) == set(got)
    bad = {k: (ref[k], got[k]) for k in ref if ref[k] != got[k]}
    assert not bad, bad


def _configs(arch, variant):
    rc, tc = rconfigs.get_config(arch), configs.get_config(arch)
    if variant == "pure_dp":
        import dataclasses
        rc = dataclasses.replace(rc, pure_dp=True)
        tc = dataclasses.replace(tc, pure_dp=True)
    return rc, tc


# -- input shapes -------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    rc, tc = rconfigs.get_config(arch), configs.get_config(arch)
    rs, ts = rconfigs.SHAPES[shape], configs.SHAPES[shape]
    assert (ts.name, ts.seq_len, ts.global_batch, ts.kind) == \
        (rs.name, rs.seq_len, rs.global_batch, rs.kind)
    assert configs.applicable(tc, ts) == rconfigs.applicable(rc, rs)
    want = rconfigs.input_specs(rc, rs)
    got = configs.input_specs(tc, ts)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape)
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype)


def test_shape_applicability():
    ok, _ = configs.applicable(configs.get_config("xlstm-1.3b"),
                               configs.SHAPES["long_500k"])
    assert ok
    ok, why = configs.applicable(configs.get_config("qwen2-7b"),
                                 configs.SHAPES["long_500k"])
    assert not ok and "full-attention" in why
    for s in ("train_4k", "prefill_32k", "decode_32k"):
        assert configs.applicable(configs.get_config("seamless-m4t-large-v2"),
                                  configs.SHAPES[s])[0]


# -- parameter, batch, serve-state and optimizer rules --------------------------------
@pytest.mark.parametrize("variant", ["fsdp", "no_fsdp", "pure_dp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, variant):
    rc, tc = _configs(arch, variant)
    fsdp = variant == "fsdp"
    rp = rlm.param_specs(rc)
    _assert_same(rshd.param_pspecs(rc, rp, _mesh(mesh), fsdp=fsdp),
                 shd.param_pspecs(tc, lm.param_specs(tc), _mesh(mesh),
                                  fsdp=fsdp), _shapes(rp, False))


@pytest.mark.parametrize("variant", ["plain", "pure_dp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, mesh, variant):
    rc, tc = _configs(arch, variant)
    for kind in ("train", "prefill", "decode"):
        rb = rconfigs.input_specs(rc, rconfigs.SHAPES[KEY[kind]])
        tb = configs.input_specs(tc, configs.SHAPES[KEY[kind]])
        _assert_same(rshd.batch_pspecs(rc, rb, _mesh(mesh)),
                     shd.batch_pspecs(tc, tb, _mesh(mesh)),
                     _shapes(rb, False))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch, mesh, kv):
    import dataclasses
    rc = dataclasses.replace(rconfigs.get_config(arch), kv_cache_dtype=kv)
    tc = dataclasses.replace(configs.get_config(arch), kv_cache_dtype=kv)
    enc = 4096 if rc.family == "audio" else 0
    rs = jax.eval_shape(lambda: rlm.init_serve_state(rc, 128, max_len=32768,
                                                     enc_len=enc))
    ts = lm.init_serve_state(tc, 128, max_len=32768, device="meta",
                             enc_len=enc)
    _assert_same(rshd.state_pspecs(rc, rs, _mesh(mesh)),
                 shd.state_pspecs(tc, ts, _mesh(mesh)), _shapes(rs, False))


@pytest.mark.parametrize("opt", ["adamw", "adamw8", "adafactor"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_reference(arch, mesh, opt):
    """ZeRO-1 moments, AdamW8's {"q", "scale"} bundles, Adafactor's
    replicated factors. The reference derives its parameter specs with its
    own auto-FSDP rule; the port's are given the same decision."""
    rc, tc = rconfigs.get_config(arch), configs.get_config(arch)
    m = MESHES[mesh]["model"]
    fsdp = rc.force_fsdp or rc.param_count() * 2 / m > 6e9
    r_shapes = rlm.param_specs(rc)
    r_state = jax.eval_shape(lambda: rinit_opt_state(ROptConfig(name=opt),
                                                     r_shapes))
    want = _opt_pspecs(rc, r_state, _mesh(mesh))
    t_shapes = lm.param_specs(tc)
    t_state = init_opt_state(OptConfig(name=opt), t_shapes)
    got = shd.opt_pspecs(tc, t_state, _mesh(mesh),
                         shd.param_pspecs(tc, t_shapes, _mesh(mesh),
                                          fsdp=fsdp), t_shapes)
    _assert_same(want, got, _shapes(r_state, False))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible_everywhere(arch):
    """Every axis a spec names divides its dim on (2, 4) (the reference's
    tests/test_distributed.py:72)."""
    cfg = configs.get_config(arch)
    tree = lm.param_specs(cfg)
    specs = shd.param_pspecs(cfg, tree, _mesh("2x4"))
    sizes = MESHES["2x4"]
    for (path, spec), leaf in zip(pytree.tree_leaves_with_path(specs),
                                  pytree.tree_leaves(tree)):
        assert len(spec) == leaf.ndim
        for i, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else \
                (entry,) if entry else ()
            n = int(np.prod([sizes[a] for a in axes])) if axes else 1
            assert leaf.shape[i] % n == 0, (arch, path, spec, leaf.shape)


def test_stacked_group_axis_never_split():
    """``lm._unstack`` takes each group's slice: no rule splits a block
    parameter's leading group axis, nor a cache's."""
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        for mesh in MESHES:
            specs = shd.param_pspecs(cfg, lm.param_specs(cfg), _mesh(mesh),
                                     fsdp=True)
            for blk in specs["blocks"] + ([specs["enc_blocks"]]
                                         if "enc_blocks" in specs else []):
                assert all(s[0] is None for s in pytree.tree_leaves(blk))
            state = lm.init_serve_state(cfg, 128, 64, device="meta")
            for c in shd.state_pspecs(cfg, state, _mesh(mesh))["blocks"]:
                assert all(s[0] is None for s in pytree.tree_leaves(c))


# -- the H100 budgets (deliberate differences from the reference's v5e ones) -----------
def test_fsdp_threshold_is_an_h100s():
    """Auto-FSDP: bf16 parameters a model shard past 30e9 B (3/8 of 80 GB).
    On (32, 8) only llama4-maverick passes it; moonshot forces FSDP."""
    mesh = _mesh("32x8")
    auto = {}
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        specs = shd.param_pspecs(cfg, lm.param_specs(cfg), mesh)
        auto[arch] = any(shd._has_axis(s, "data")
                         for s in pytree.tree_leaves(specs))
    assert {a for a, f in auto.items() if f} == {
        "llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b"}
    assert shd.FSDP_SHARD_BYTES == 30e9
    cfg = configs.get_config("qwen2-7b")           # ~7.6e9 parameters
    n = cfg.param_count()
    for m, want in ((1, False), (2, False)):
        specs = shd.param_pspecs(cfg, lm.param_specs(cfg),
                                 {"data": 4, "model": m})
        assert any(shd._has_axis(s, "data") for s in
                   pytree.tree_leaves(specs)) == (n * 2 / m > 30e9) == want


def test_pick_optimizer():
    picked = {a: dryrun.pick_optimizer(configs.get_config(a)).name
              for a in ARCHS}
    assert {a for a, n in picked.items() if n == "adamw8"} == \
        {"llama4-maverick-400b-a17b"}
    assert set(picked.values()) <= {"adamw", "adamw8"}


def test_production_meshes():
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (32, 8)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 32, 8)
    # the reference's probe rule: model 8, 4, 2 or 1, the first dividing n
    for n, want in ((1, (1, 1)), (2, (1, 2)), (6, (3, 2)), (8, (1, 8)),
                    (12, (3, 4)), (24, (3, 8)), (7, (7, 1))):
        assert probe_shape(n) == want


# -- placements -----------------------------------------------------------------------
def test_placements_round_trip():
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        cases = {shd.Spec(("pod", "data"), None, "model"):
                 (Shard(0), Shard(0), Shard(2)),
                 shd.Spec(None, "model"): (Replicate(), Replicate(),
                                           Shard(1)),
                 shd.Spec("data", None): (Replicate(), Shard(0),
                                          Replicate()),
                 shd.Spec(None, None, None): (Replicate(),) * 3}
        for spec, want in cases.items():
            assert shd.placements(spec, mesh) == want
            assert shd.spec_of(want, mesh, len(spec)) == spec
        with pytest.raises(ValueError, match="mesh order"):
            shd.placements(shd.Spec(("data", "pod")), mesh)
        t = shd.distribute({"w": torch.arange(64.).reshape(8, 8)},
                           {"w": shd.Spec("data", "model")}, mesh)["w"]
        assert tuple(t.placements) == (Replicate(), Shard(0), Shard(1))
        assert t.to_local().shape == (4, 4)


# -- activation constraints: nothing without a mesh -----------------------------------
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_constraints_are_no_ops_without_a_mesh():
    x = torch.randn(4, 8, 16)
    y = torch.randn(4, 8, 16)
    with _Ops() as rec:
        for prefer in ("seq", "channel", "dp"):
            assert constrain_residual(x, prefer) is x
        assert constrain_last(x) is x
        assert seq_whole(x) is x
        out = local_call(lambda a: a, (x,), ((0, 2),), (0, 2))
        assert out is x
    assert rec.ops == []
    with _Ops() as rec:
        residual_add(x, y)
    assert rec.ops == [torch.ops.aten.add.Tensor]
    # an active mesh leaves plain tensors alone too
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        with activation_mesh(mesh), _Ops() as rec:
            assert constrain_residual(x) is x
            assert constrain_last(x) is x
        assert rec.ops == []
