"""The dry-run (``repro_torch.launch.dryrun``) on the CPU, under a fake
process group and ``FakeTensorMode``: the reference's dry-run tests
(``tests/test_widedeep_query.py:69-115``) on the port's counterparts, and
the port's own:

- the collective recorder on known redistributions (an all-gather of a
  (32, 128) float32 tensor over 4 ranks records 32 x 128 x 4 B of result);
- the roofline with the H100's published figures, and no v5e figure left
  in the port;
- one reduced cell of every family on a fake (2, 4) ``cpu`` mesh returns
  ``status == "ok"`` with every key, and its extrapolation from depth-1
  and depth-2 traces equals the full-depth trace exactly, FLOPs and
  collective bytes;
- the memory terms add up, and the trace counts what runs on one device.

The reference's module sets ``XLA_FLAGS`` when imported, so its
``VARIANTS`` are read from its source, not imported.
"""
import ast
import dataclasses
import pathlib

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor import DTensor

import repro_torch
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import fake_world

ROOT = pathlib.Path(repro_torch.__file__).resolve().parents[2]
FAMILY_ARCHS = {"dense": "glm4-9b", "vlm": "llava-next-mistral-7b",
                "moe": "moonshot-v1-16b-a3b", "ssm": "xlstm-1.3b",
                "hybrid": "hymba-1.5b", "audio": "seamless-m4t-large-v2"}
SMALL = {"train": ShapeSpec("train_s", 16, 8, "train"),
         "prefill": ShapeSpec("prefill_s", 16, 8, "prefill"),
         "decode": ShapeSpec("decode_s", 16, 8, "decode")}
KEYS = {"arch", "shape", "mesh", "variant", "status", "n_chips", "times",
        "raw", "extrapolated", "roofline", "model_flops", "wall_s"}


# -- the collective recorder (test_widedeep_query.py:69) ------------------------------
def test_collective_recorder():
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        x = distribute_tensor(torch.randn(32, 128), mesh, [Shard(0)],
                              src_data_rank=None)
        p = DTensor.from_local(torch.randn(32, 128), mesh, [Partial()],
                               run_check=False)
        tr = dr.StepTrace(dr.mesh_groups(mesh))
        with tr:
            x.redistribute(mesh, [Replicate()])
        got = tr.collectives()
        assert got["bytes"] == {"all-gather": 32 * 128 * 4}
        assert got["counts"] == {"all-gather": 1}
        assert got["total_bytes"] == 32 * 128 * 4
        assert got["axis_bytes"] == {"model": 32 * 128 * 4}
        tr = dr.StepTrace(dr.mesh_groups(mesh))
        with tr:
            p.redistribute(mesh, [Shard(0)])
            p.redistribute(mesh, [Replicate()])
        got = tr.collectives()
        assert got["bytes"] == {"reduce-scatter": 8 * 128 * 4,
                                "all-reduce": 32 * 128 * 4}
        assert got["counts"] == {"reduce-scatter": 1, "all-reduce": 1}
        assert got["total_bytes"] == sum(got["bytes"].values())


def test_trace_counts_one_device():
    """A (64, 32) @ (32, 48) product split 4 ways on its rows: one rank's
    FLOPs (2 x 16 x 32 x 48) and bytes (its operands and result), its
    result's storage live at the peak beside the arguments'. DTensor's
    shape propagation ran the product at its global shapes too (a shape
    no other test propagates, so its cache is cold), and the trace let
    that pass uncounted."""
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        a = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0)],
                              src_data_rank=None)
        b = distribute_tensor(torch.randn(32, 48), mesh, [Replicate()],
                              src_data_rank=None)
        tr = dr.StepTrace(dr.mesh_groups(mesh))
        args = tr.track((a, b))
        with tr:
            c = a @ b
        assert tr.skipped > 0
        assert tr.flops == 2 * 16 * 32 * 48
        assert tr.bytes_accessed == (16 * 32 + 32 * 48 + 16 * 48) * 4
        assert tr.collectives()["total_bytes"] == 0
        assert args == (16 * 32 + 32 * 48) * 4   # multiples of 512 B
        assert tr.peak == args + 16 * 48 * 4 == tr.live
        del c


# -- roofline and variants (test_widedeep_query.py:89-105) ----------------------------
def test_roofline_terms_dominance():
    t = dr.roofline_terms(flops=989e12, hbm_bytes=3.35e12 * 2,
                          nvlink_bytes=450e9 * 0.25, n_chips=1,
                          net_bytes=50e9 * 0.25)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "memory_s"
    assert t["bound_s"] == pytest.approx(2.0)
    assert dr.link_bytes({"model": 3, "data": 4, "pod": 5}) == (3.0, 9.0)


def test_no_v5e_figures_in_the_port():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for figure in ("197e12", "819e9", "ICI_BW"):
            assert figure not in text, (path, figure)


def _reference_variants() -> set:
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "VARIANTS" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no VARIANTS in the reference's dryrun.py")


def test_variant_registry():
    assert set(dr.VARIANTS) == _reference_variants()
    assert "baseline" in dr.VARIANTS and "naive" in dr.VARIANTS
    cfg = get_config("glm4-9b")
    sp, fn = dr.VARIANTS["remat_dots"]
    assert sp and fn(cfg).remat == "dots"
    assert dr.VARIANTS["naive"] == (False, None)


def test_shape_applicability():
    r = dr.run_cell("qwen2-7b", "long_500k", "single")
    assert r["status"] == "skipped(full-attention)"


# -- one reduced cell per family ----------------------------------------------------
CELLS = [(fam, kind) for fam in FAMILY_ARCHS
         for kind in (("train",) if fam == "ssm" else
                      ("train", "prefill", "decode"))]


@pytest.mark.parametrize("family,kind", CELLS)
def test_reduced_cell(family, kind):
    """status ok with the reference's keys; the extrapolation from depth 1
    and 2 equals the full-depth trace (FLOPs and collective bytes
    exactly); the memory terms add up. One microbatch: the extrapolation
    traces take one, as the reference's do."""
    arch = FAMILY_ARCHS[family]
    cfg = dataclasses.replace(reduced(get_config(arch)), grad_accum=1)
    r = dr.run_cell(arch, kind, "single", cfg_override=cfg,
                    shape=SMALL[kind], mesh_shape=(2, 4), device_type="cpu")
    assert r["status"] == "ok", r
    assert KEYS <= set(r)
    assert r["n_chips"] == 8
    raw, ex = r["raw"], r["extrapolated"]
    assert raw["flops"] > 0 and raw["bytes_accessed"] > 0
    assert ex["flops"] == raw["flops"]
    assert ex["collective_total_bytes"] == raw["collectives"]["total_bytes"]
    assert ex["collective_bytes"] == raw["collectives"]["bytes"]
    assert ex["collective_axis_bytes"] == raw["collectives"]["axis_bytes"]
    mem = raw["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + \
        mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    if kind == "train":          # parameters and states updated in place
        assert mem["alias_bytes"] > 0
    roof = r["roofline"]
    assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert roof["bound_s"] == roof[roof["dominant"]]
    assert r["model_flops"] > 0


@pytest.mark.parametrize("arch", ["qwen2-7b", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b"])
def test_stored_splits_cell(arch):
    """Width 1,024 (leaves past ``sharding.SMALL_LEAF``): qwen2 and
    moonshot with FSDP, hymba's pure_dp, on a fake (2, 2, 2) mesh. The
    weights stored split over ``data`` (over ``model`` under pure_dp) are
    gathered on that axis; the extrapolation still equals the trace."""
    cfg = dataclasses.replace(reduced(get_config(arch)), d_model=1024,
                              d_head=256, grad_accum=1,
                              d_ff=1024 if get_config(arch).d_ff else 0)
    if not cfg.pure_dp:
        cfg = dataclasses.replace(cfg, force_fsdp=True)
    r = dr.run_cell(arch, "train", "single", cfg_override=cfg,
                    shape=SMALL["train"], mesh_shape=(2, 2, 2),
                    device_type="cpu")
    assert r["status"] == "ok", r
    axis = "model" if cfg.pure_dp else "data"
    assert r["raw"]["collectives"]["axis_bytes"][axis] > 0
    assert r["extrapolated"]["flops"] == r["raw"]["flops"]
    assert r["extrapolated"]["collective_axis_bytes"] == \
        r["raw"]["collectives"]["axis_bytes"]


def test_cli_writes_results(tmp_path, capsys):
    dr.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out",
             str(tmp_path), "--device-type", "cpu"])
    path = tmp_path / "qwen2-7b__long_500k__single__baseline.json"
    assert path.exists()
    assert "skipped(full-attention)" in capsys.readouterr().out
    dr.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out",
             str(tmp_path), "--skip-existing"])
    assert "[skip]" in capsys.readouterr().out
