"""Port parity, the distributed layer on the CPU: ``tests/test_distributed.py``
on gloo ranks, plus the port's own sharper checks.

Ranks are spawned by ``tests/_torch_ranks.py`` (a ``FileStore`` in the
test's temporary directory, no TCP port); each program runs once for the
module and the tests read what it wrote:

- 8 ranks: one step of the small qwen2 (d_model 64, vocab 256) on a
  (4, 2) (data, model) mesh against the meshless step, to phase 9A's
  bounds (loss 1e-5 x max(1, loss); each gradient leaf rtol 1e-4 / atol
  1e-5 x its std, or the case's own :data:`MESH_ATOL`, read over seeds);
  one step of every arch, reduced, on a (2, 4) mesh, the same way, and
  of qwen2 with FSDP and hymba (pure_dp) at width 1,024;
  one ``make_train_step`` step's grad norm against the meshless one's;
  50 steps at lr 5e-2 (the loss falls by more than 0.5 and
  ``blocks[0].mlp.wu`` stays split: the reference's own asserts, whose
  run fails on jax 0.9.0); ``Trainer(mesh=)`` and its resume; and the
  elastic re-mesh, saved on (4, 2) and restored onto (2, 2) over ranks
  0-3, each rank holding only its own part.
- 4 ranks: the GPipe forward against the sequential chain (2e-4) and the
  reference's ``pipelined_forward`` (1e-6, 4 host devices in a
  subprocess); the compressed psum against the sum of the reference's
  ``quantize``/``dequantize`` of each rank's gradient (the reference's own
  test fails on jax 0.9.0 at ``compression.py:66``), each rank's new error
  bit for bit.

And in this process, a one-rank gloo mesh changes nothing: every arch at
``reduced()``, two AdamW steps, the loss and every parameter bit for bit
against the meshless steps.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils import _pytree as pytree

import _torch_ranks as ranks
from repro.distributed.compression import compression_ratio as jratio
from repro.distributed.compression import dequantize as jdequantize
from repro.distributed.compression import quantize as jquantize
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.distributed.compression import compression_ratio
from repro_torch.distributed.pipeline_par import bubble_fraction
from repro_torch.models import lm
from repro_torch.train import parity
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import TrainConfig, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE = dict(s=4, m=6, mb=8, d=16)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_training"))
    ranks.spawn(ranks.mesh_training, 8, out)
    return out


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("stages"))
    ranks.spawn(ranks.stages_and_compression, 4, out, *PIPE.values())
    return out


# The gradient atol of a mesh step against the meshless one, in units of
# each leaf's std, by case (``_torch_ranks.CASES``): the mesh sums each
# gradient in another order (per-rank partial sums, then the all-reduce or
# reduce-scatter). Calibrated over seeds 0-7 by ``python
# tests/_torch_ranks.py --first-seed 0 --seeds 8``: twice the case's
# largest reading, rounded up on the 1-3-10 ladder, never under 9A's 1e-5
# (largest readings: small qwen2 3.09e-06, moonshot 3.69e-06, maverick
# 1.088e-05 (router), glm4 3.51e-06, qwen2 3.09e-06, minicpm 2.06e-06,
# starcoder2 3.40e-06, xlstm 3.951e-05 (wq), hymba 1.06e-06, llava
# 3.73e-06, seamless 5.057e-06, wide qwen2 1.382e-05 (embed), wide hymba
# 6.478e-05 (embed; w_in 3.20e-05, w_bc 2.44e-05: at width 1,024 the
# pure_dp batch is split 8 ways and every leaf's sum reordered)); fixed
# before seeds 8-15 were read.
MESH_ATOL = {"llama4-maverick-400b-a17b": 3e-5, "xlstm-1.3b": 1e-4,
             "seamless-m4t-large-v2": 3e-5, "wide-qwen2-7b": 3e-5,
             "wide-hymba-1.5b": 3e-4}


def _hold_to_meshless(case: str, path: str):
    """The mesh step written at ``path`` against the meshless one: the
    loss within phase 9A's 1e-5 x max(1, loss), each gradient leaf within
    its rtol 1e-4 and the case's :data:`MESH_ATOL` (1e-5, 9A's, where it
    has none) x the leaf's std."""
    cfg, _ = ranks.case_config(case)
    want, grads = ranks.step_grads(cfg, 0)
    got = np.load(path)
    assert abs(float(got["loss"]) - want) <= \
        parity.LOSS_RTOL * max(1.0, abs(want))
    atol = MESH_ATOL.get(case, parity.ATOL)
    for k, w in grads.items():
        assert ranks.gap(got[k], w) <= atol, (k, ranks.gap(got[k], w))


def test_mesh_step_matches_meshless(trained):
    _hold_to_meshless("small-qwen", os.path.join(trained, "grads.npz"))


@pytest.mark.parametrize("arch", ranks.SPLIT_ARCHS)
def test_split_mesh_step_matches_meshless(trained, arch):
    _hold_to_meshless(arch, os.path.join(trained, f"grads_{arch}.npz"))


@pytest.mark.parametrize("arch", ranks.WIDE_ARCHS)
def test_stored_splits_mesh_step_matches_meshless(trained, arch):
    """Weights stored split for storage only (FSDP over data; ZeRO-3 over
    model under pure_dp) are gathered for the products and their
    gradients reduce-scattered back: the step is still the meshless
    one's."""
    _hold_to_meshless(f"wide-{arch}",
                      os.path.join(trained, f"grads_wide-{arch}.npz"))


def test_mesh_train_step_grad_norm(trained):
    """The sharded step's global norm (the clip's) sums each gradient once:
    the meshless step's within 1e-5."""
    cfg = ranks.small_qwen()
    opt = OptConfig(lr=5e-2)
    step, _ = make_train_step(cfg, opt, TrainConfig(steps=60, warmup=2))
    params = lm.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             parity.train_batch(cfg, np.random.default_rng(0), 8, 16).items()}
    _, _, m = step(params, init_opt_state(opt, params), batch, 0)
    with open(os.path.join(trained, "descent.json")) as f:
        got = json.load(f)["grad_norm"]
    assert got == pytest.approx(float(m["grad_norm"]), rel=1e-5)


def test_pjit_train_step_descends_on_mesh(trained):
    with open(os.path.join(trained, "descent.json")) as f:
        got = json.load(f)
    losses = got["losses"]
    assert len(losses) == 50 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses
    assert got["wu_split"], got["wu_placements"]


def test_elastic_remesh_checkpoint_restore(trained):
    """Saved on (4, 2), restored onto (2, 2): the arrays are equal, and
    each rank's part is its own (4, 4), cut on the host, with nothing
    whole behind it."""
    for rank in range(4):
        got = np.load(os.path.join(trained, f"elastic_{rank}.npz"))
        np.testing.assert_array_equal(
            got["w"], np.arange(64, dtype=np.float32).reshape(8, 8))
        np.testing.assert_array_equal(
            got["rows"], np.arange(32, dtype=np.float32).reshape(8, 4))
        assert list(got["w_local"]) == [4, 4]
        assert list(got["rows_local"]) == [4, 4]
        assert bool(got["owns"])


def test_mesh_trainer_places_only_each_ranks_part(trained):
    """``Trainer(mesh=).fit``, and its resume from the checkpoint: every
    rank's parts of the states own their storages (they are made a part
    at a time), and on the resume the parameters' too (the restore cuts
    on the host)."""
    for rank in range(8):
        with open(os.path.join(trained, f"owns_{rank}.json")) as f:
            got = json.load(f)
        assert got == {"owns": [True, True], "restarts": 1}, (rank, got)


def _jax_pipeline() -> str:
    """The reference's ``pipelined_forward`` on 4 host devices, in a
    subprocess (the device count is fixed when JAX starts): its code."""
    return textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline_par import pipelined_forward
        s, m, mb, d = {PIPE['s']}, {PIPE['m']}, {PIPE['mb']}, {PIPE['d']}
        rng = np.random.default_rng(0)
        w = jnp.asarray(rng.standard_normal((s, d, d)) * 0.3, jnp.float32)
        x = jnp.asarray(rng.standard_normal((m, mb, d)), jnp.float32)
        mesh = jax.make_mesh((4,), ("stage",))
        got = pipelined_forward(lambda p, x: jnp.tanh(x @ p), mesh)(w, x)
        np.save(sys.argv[1], np.asarray(got))
    """)


def test_pipeline_parallel_matches_sequential(staged, tmp_path):
    s, m, mb, d = PIPE.values()
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((s, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    want = x
    for i in range(s):
        want = np.tanh(want @ w[i])
    path = str(tmp_path / "jax_pipe.npy")
    r = subprocess.run([sys.executable, "-c", _jax_pipeline(), path],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(path)
    for rank in range(4):
        got = np.load(os.path.join(staged, f"pipe_{rank}.npy"))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-9


def test_compressed_psum_error_feedback(staged):
    g_all = np.random.default_rng(0).standard_normal((4, 64, 32)) \
        .astype(np.float32)
    decoded = []
    for r in range(4):
        q, s = jquantize(jnp.asarray(g_all[r]))
        decoded.append(np.asarray(jdequantize(q, s, (64, 32), 64 * 32)))
    want = np.sum(decoded, axis=0)
    exact = g_all.sum(0)
    for r in range(4):
        got = np.load(os.path.join(staged, f"comp_{r}.npz"))
        np.testing.assert_allclose(got["red"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["err"], g_all[r] - decoded[r])
        assert np.abs(got["err"]).max() > 0
        rel = np.abs(got["red"] - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel
    tree = {"w": torch.zeros(4, 64, 32)}
    assert compression_ratio(tree) > 3.5
    assert compression_ratio(tree) == jratio({"w": jnp.zeros((4, 64, 32))})


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_rank_mesh_changes_nothing(one_rank, arch):
    """Two AdamW steps through ``make_train_step(mesh=)`` on a (1, 1) mesh
    against two meshless steps: the losses and every parameter bit for
    bit."""
    cfg = reduced(get_config(arch))
    opt = OptConfig(name="adamw", lr=1e-2)
    train = TrainConfig(steps=4, warmup=1)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(v) for k, v in
                parity.train_batch(cfg, rng, 2, 16).items()}
               for _ in range(2)]
    runs = []
    for mesh in (None, one_rank):
        params = lm.init_params(cfg, 0, device="cpu")
        state = init_opt_state(opt, params)
        step, specs = make_train_step(cfg, opt, train, mesh=mesh)
        assert (specs is None) == (mesh is None)
        losses = []
        for i, b in enumerate(batches):
            params, state, m = step(params, state, b, i)
            losses.append(m["loss"])
        runs.append((losses, [t.full_tensor() if hasattr(t, "full_tensor")
                              else t for t in pytree.tree_leaves(params)]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1)), (l0, l1)
    assert len(p0) == len(p1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
