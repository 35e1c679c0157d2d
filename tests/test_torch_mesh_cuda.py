"""The sharded training step and the dry-run on a card: a one-rank NCCL
mesh, (1, 1) ("data", "model") on cuda:0, against no mesh (two AdamW steps
of reduced archs in float32, the losses and every parameter bit for bit),
and a dry-run cell traced with ``device_type="cuda"`` (fake tensors on the
card's device type under a fake process group of 8 ranks).

Every test skips without a card. Imports neither JAX nor the reference
package:

    python -m pytest tests/test_torch_mesh_cuda.py -q -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ShapeSpec, get_config, reduced


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "moonshot-v1-16b-a3b",
                                  "hymba-1.5b"])
def test_one_rank_nccl_mesh_step_matches_meshless(cuda, nccl_mesh, arch):
    from repro_torch.models import lm
    from repro_torch.train import parity
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = reduced(get_config(arch))
    opt = OptConfig(name="adamw", lr=1e-2)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in
                parity.train_batch(cfg, rng, 2, 16).items()}
               for _ in range(2)]
    runs = []
    for mesh in (None, nccl_mesh):
        params = lm.init_params(cfg, 0, device=cuda)
        state = init_opt_state(opt, params)
        step, _ = make_train_step(cfg, opt, TrainConfig(steps=4, warmup=1),
                                  mesh=mesh)
        losses = []
        for i, b in enumerate(batches):
            params, state, m = step(params, state, b, i)
            losses.append(m["loss"])
        runs.append((losses, [t.full_tensor() if hasattr(t, "full_tensor")
                              else t for t in pytree.tree_leaves(params)]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.cuda
def test_dryrun_cell_traces_with_cuda_device_type(cuda):
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(reduced(get_config("glm4-9b")), grad_accum=1)
    r = dryrun.run_cell("glm4-9b", "train_s", "single", cfg_override=cfg,
                        shape=ShapeSpec("train_s", 16, 8, "train"),
                        mesh_shape=(2, 4), device_type="cuda")
    assert r["status"] == "ok"
    assert r["extrapolated"]["flops"] == r["raw"]["flops"] > 0
    assert r["raw"]["memory"]["peak_bytes"] > 0
