"""Rank programs for the port's multi-rank tests on the CPU: gloo ranks
spawned by ``torch.multiprocessing``, meeting through a ``FileStore`` in
the test's temporary directory (no TCP port, so test files can run side by
side). Each program writes what the parent checks as ``.npz``/``.json``
files there. Imports no JAX: the parent compares with the reference.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

QWEN_SMALL = dict(d_model=64, vocab=256, vocab_pad_multiple=64)
# every arch, reduced, one step on a (2, 4) mesh
SPLIT_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "glm4-9b",
               "qwen2-7b", "minicpm-2b", "starcoder2-15b", "xlstm-1.3b",
               "hymba-1.5b", "llava-next-mistral-7b",
               "seamless-m4t-large-v2")


def spawn(fn, world: int, out: str, *args) -> None:
    """Runs ``fn(rank, world, out, *args)`` on ``world`` gloo ranks."""
    mp.start_processes(_run, args=(fn, world, out, args), nprocs=world,
                       join=True, start_method="spawn")


def _run(rank, fn, world, out, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, out, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _full(tree):
    from torch.utils import _pytree as pytree
    return {pytree.keystr(k): (v.full_tensor() if hasattr(v, "full_tensor")
                               else v).detach().numpy()
            for k, v in pytree.tree_leaves_with_path(tree)}


# archs at width 1,024, so their leaves pass sharding.SMALL_LEAF: qwen2
# with FSDP (its weights stored split over data), hymba's pure_dp (stored
# split over model, the batch over both axes)
WIDE_ARCHS = ("qwen2-7b", "hymba-1.5b")


def wide(arch: str):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, d_model=1024, d_head=256,
                               d_ff=1024 if cfg.d_ff else 0, vocab=1000,
                               force_fsdp=not cfg.pure_dp)


def small_qwen():
    import dataclasses

    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("qwen2-7b")), **QWEN_SMALL)


# the cases whose mesh step is held to the meshless one: the small qwen2
# on a (4, 2) mesh, the rest on (2, 4)
CASES = ("small-qwen",) + SPLIT_ARCHS + tuple(f"wide-{a}" for a in WIDE_ARCHS)


def case_config(case: str):
    """-> (config, mesh shape) of a case of :data:`CASES`."""
    from repro_torch.configs import get_config, reduced
    if case == "small-qwen":
        return small_qwen(), (4, 2)
    if case.startswith("wide-"):
        return wide(case[5:]), (2, 4)
    return reduced(get_config(case)), (2, 4)


def step_grads(cfg, seed: int, mesh=None):
    """One step's loss and gradients of ``cfg`` from seed ``seed``'s
    parameters and batch (B 8 x S 16), on ``mesh`` or without one:
    (loss, {leaf path: array})."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.models import lm
    from repro_torch.train.parity import train_batch
    from repro_torch.train.trainer import loss_and_grads

    params = lm.init_params(cfg, seed, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             train_batch(cfg, np.random.default_rng(seed), 8, 16).items()}
    if mesh is not None:
        params = shd.distribute(params, shd.param_pspecs(cfg, params, mesh),
                                mesh)
        batch = shd.distribute(batch, shd.batch_pspecs(cfg, batch, mesh),
                               mesh)
    with activation_mesh(mesh):
        loss, _, grads = loss_and_grads(cfg, params, batch)
    return float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss), _full(grads)


def mesh_gaps(rank, world, out, seeds):
    """Each case of :data:`CASES` on its mesh at each of ``seeds``
    (``g_<case>_<seed>.npz``: the loss and the gradients)."""
    from torch.distributed.device_mesh import init_device_mesh
    meshes = {s: init_device_mesh("cpu", s, mesh_dim_names=("data", "model"))
              for s in ((4, 2), (2, 4))}
    for seed in seeds:
        for case in CASES:
            cfg, shape = case_config(case)
            loss, grads = step_grads(cfg, seed, meshes[shape])
            if rank == 0:
                np.savez(os.path.join(out, f"g_{case}_{seed}.npz"),
                         loss=loss, **grads)


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """The mesh's gradient leaf against the meshless one: its excess over
    rtol ``parity.RTOL`` in units of the meshless leaf's std."""
    from repro_torch.train.parity import RTOL
    w, g = want.astype(np.float64), got.astype(np.float64)
    excess = np.maximum(np.abs(g - w) - RTOL * np.abs(w), 0).max()
    return float(excess / w.std()) if w.std() else \
        (0.0 if excess == 0 else float("inf"))


def main(argv=None) -> None:
    """``PYTHONPATH=src python tests/_torch_ranks.py --first-seed 0
    --seeds 8 --out DIR``: each case's mesh step against the meshless one
    over seeds, on 8 gloo ranks; prints each case's largest gradient gap
    (std units), its leaf and seed, and the loss's largest relative gap,
    and writes every reading to ``DIR/gaps.json``."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    os.makedirs(args.out, exist_ok=True)
    spawn(mesh_gaps, 8, args.out, seeds)
    readings = {}
    for case in CASES:
        cfg, _ = case_config(case)
        for seed in seeds:
            loss, grads = step_grads(cfg, seed)
            got = np.load(os.path.join(args.out, f"g_{case}_{seed}.npz"))
            r = readings.setdefault(case, {"loss": [], "leaves": {}})
            r["loss"].append(abs(float(got["loss"]) - loss) / max(1.0,
                                                                  abs(loss)))
            for k, v in grads.items():
                r["leaves"].setdefault(k, []).append(gap(got[k], v))
        worst = max((max(v), k, seeds[v.index(max(v))])
                    for k, v in readings[case]["leaves"].items())
        print(f"{case}: largest gap {worst[0]:.3e} std ({worst[1]}, seed "
              f"{worst[2]}); loss {max(readings[case]['loss']):.3e}")
    with open(os.path.join(args.out, "gaps.json"), "w") as f:
        json.dump({"seeds": seeds, "readings": readings}, f)


def mesh_training(rank, world, out):
    """On a (4, 2) (data, model) mesh: one step's loss and gradients of
    the small qwen2 (``grads.npz``); on a (2, 4) mesh one step of each of
    :data:`SPLIT_ARCHS` reduced and of :data:`WIDE_ARCHS` at width 1,024
    (``grads_<arch>.npz``, ``grads_wide-<arch>.npz``); one
    ``make_train_step`` step of the small qwen2, its grad norm; 50 AdamW
    steps at lr 5e-2
    (``descent.json``: the losses and whether ``blocks[0].mlp.wu`` is
    still split); two ``Trainer(mesh=)`` steps and a resume of them
    (``owns_<rank>.json``: whether every local part of the states, and
    on the resume of the parameters, owns a storage of its own size,
    nothing whole behind it);
    then (8, 8) and (8, 4) arrays saved from the (4, 2) mesh and
    restored onto the (2, 2) mesh ``plan_elastic_mesh(4,
    model_parallel=2)`` gives, over ranks 0-3 (``elastic_<rank>.npz``,
    with the local parts' shapes and storages)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import Shard

    from torch.utils import _pytree as pytree

    from repro_torch.data import TokenStore, synthetic_corpus, token_batches
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.fault import plan_elastic_mesh
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.parity import train_batch
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           make_train_step)

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    # glm4-9b's 2 KV heads on a 4-way model axis, the MoE archs' 8 experts
    # split 4 ways, xlstm and hymba with the batch over both axes (pure_dp)
    for case in CASES:
        cfg, shape = case_config(case)
        loss, grads = step_grads(cfg, 0, mesh if shape == (4, 2) else mesh24)
        if rank == 0:
            name = "grads" if case == "small-qwen" else f"grads_{case}"
            np.savez(os.path.join(out, f"{name}.npz"), loss=loss, **grads)

    cfg = small_qwen()
    params = lm.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             train_batch(cfg, np.random.default_rng(0), 8, 16).items()}
    opt = OptConfig(lr=5e-2)
    train = TrainConfig(steps=60, warmup=2, donate=False)
    step_fn, _ = make_train_step(cfg, opt, train, mesh=mesh)
    # one step from the qwen2 batch above: its grad norm (the clip's)
    p1, _, m1 = step_fn(lm.init_params(cfg, 0, device="cpu"),
                        init_opt_state(opt, params), batch, 0)
    step_norm = float(m1["grad_norm"])
    params = lm.init_params(cfg, 0, device="cpu")
    state = init_opt_state(opt, params)
    store = TokenStore(synthetic_corpus(100_000, cfg.vocab), cfg.vocab)
    data = token_batches(store, cfg, batch=8, seq=16, device="cpu")
    losses = []
    for i in range(50):
        params, state, m = step_fn(params, state, next(data), i)
        losses.append(float(m["loss"]))
    wu = params["blocks"][0]["mlp"]["wu"]
    split = any(isinstance(p, Shard) for p in wu.placements)
    if rank == 0:
        with open(os.path.join(out, "descent.json"), "w") as f:
            json.dump({"losses": losses, "wu_split": split,
                       "wu_placements": str(wu.placements),
                       "grad_norm": step_norm}, f)

    # Trainer(mesh=): two steps, then a resume of them from the checkpoint
    ckpt_dir = os.path.join(out, "trainer")
    owns = []
    for steps in (2, 3):
        trainer = Trainer(cfg, opt, TrainConfig(steps=steps, warmup=1,
                                                ckpt_dir=ckpt_dir), mesh=mesh)
        p, _ = trainer.fit(lm.init_params(cfg, 0, device="cpu"),
                           token_batches(store, cfg, batch=8, seq=16,
                                         device="cpu"))
        # the states always; the parameters once restored (the first fit
        # cuts them from the whole ones it is given)
        owns.append(all(_owns(t.to_local()) for t in pytree.tree_leaves(
            (trainer.opt_state, p if steps == 3 else None))
            if isinstance(t, torch.Tensor)))
        dist.barrier()                    # rank 0's write is done
    with open(os.path.join(out, f"owns_{rank}.json"), "w") as f:
        json.dump({"owns": owns, "restarts":
                   trainer.fault_log.summary().get("restart", 0)}, f)

    specs = {"rows": shd.Spec("data", None), "w": shd.Spec("data", "model")}
    tree = shd.distribute({"rows": torch.arange(32, dtype=torch.float32)
                           .reshape(8, 4),
                           "w": torch.arange(64, dtype=torch.float32)
                           .reshape(8, 8)}, specs, mesh)
    ck.save(os.path.join(out, "ckpt"), 5, tree)
    plan = plan_elastic_mesh(4, model_parallel=2)
    mesh2 = DeviceMesh("cpu", torch.arange(plan.n_devices)
                       .reshape(plan.shape), mesh_dim_names=plan.axes)
    if rank < plan.n_devices:
        step, got, _ = ck.restore_latest(os.path.join(out, "ckpt"), tree,
                                         mesh=mesh2, specs=specs)
        assert step == 5
        assert all(tuple(t.device_mesh.shape) == plan.shape
                   for t in got.values())
        np.savez(os.path.join(out, f"elastic_{rank}.npz"),
                 **{k: t.full_tensor().numpy() for k, t in got.items()},
                 **{f"{k}_local": np.array(t.to_local().shape)
                    for k, t in got.items()},
                 owns=all(_owns(t.to_local()) for t in got.values()))


def _owns(local: torch.Tensor) -> bool:
    """A local part whose storage holds it and nothing more: not a view
    of a whole tensor."""
    return local.untyped_storage().nbytes() == \
        local.numel() * local.element_size()


def stages_and_compression(rank, world, out, s, m, mb, d):
    """4 ranks. A ``stage`` mesh: the pipelined forward of ``tanh(x @
    w[i])`` over S stages, M microbatches (``pipe_<rank>.npy``). A ``pod``
    mesh: ``psum_compressed`` of rank r's (64, 32) gradient
    (``comp_<rank>.npz``: the sum and r's new error)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.compression import psum_compressed
    from repro_torch.distributed.pipeline_par import pipelined_forward

    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((s, d, d)) * 0.3)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, mb, d)).astype(np.float32))
    stages = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    got = pipelined_forward(lambda p, x: torch.tanh(x @ p), stages)(w, x)
    np.save(os.path.join(out, f"pipe_{rank}.npy"), got.numpy())

    g_all = np.random.default_rng(0).standard_normal((world, 64, 32)) \
        .astype(np.float32)
    pods = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    red, err = psum_compressed({"w": torch.from_numpy(g_all[rank])},
                               pods.get_group("pod"),
                               {"w": torch.zeros(64, 32)})
    np.savez(os.path.join(out, f"comp_{rank}.npz"), red=red["w"].numpy(),
             err=err["w"].numpy())


if __name__ == "__main__":
    main()
