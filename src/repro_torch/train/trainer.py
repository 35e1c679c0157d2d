"""Trainer: the train step, schedules, checkpoint/restart and straggler
detection — the loop the reference's ``repro.train.trainer`` runs, on one
device.

``make_train_step`` builds the (params, opt_state, batch, step) ->
(params, opt_state, metrics) function: the loss and the gradients of
``lm.train_loss`` by autograd, the scheduled ``lr(step)``, and
``apply_updates``, which updates the parameters and the state in place
(the reference donates its buffers to the same end). ``Trainer`` owns the
loop, the fault log and the checkpoints. The device is the parameters';
a mesh (pjit, sharded optimizer states) is not ported, and ``Trainer``
refuses one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Iterator

import torch
from torch.utils import _pytree as pytree

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import FaultLog, StragglerDetector
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.schedule import SCHEDULES

NO_MESH = ("a mesh (pjit, sharded parameters and optimizer states) is not "
           "ported: ROADMAP 5(e)")


@dataclass
class TrainConfig:
    steps: int = 100
    warmup: int = 10
    schedule: str = "cosine"
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = ""
    keep_ckpts: int = 3
    donate: bool = True          # kept for the reference's signature: the
                                 # port's updates are in place regardless


def make_train_step(cfg: ModelConfig, opt: OptConfig, train: TrainConfig,
                    mesh=None):
    """Returns (step_fn, None). ``step_fn(params, opt_state, batch, step)``
    -> (params, opt_state, metrics): ``train_loss``'s metrics with ``loss``,
    ``lr`` (float32) and ``grad_norm`` (before clipping), each detached.
    ``step`` is a host int."""
    if mesh is not None:
        raise NotImplementedError(NO_MESH)
    sched = partial(SCHEDULES[train.schedule], peak_lr=opt.lr,
                    warmup=train.warmup, total=train.steps)

    def step_fn(params, opt_state, batch, step):
        loss, metrics, grads = loss_and_grads(cfg, params, batch)
        lr = sched(step)
        stats: dict = {}
        params, opt_state = apply_updates(opt, grads, opt_state, params, lr,
                                          stats)
        metrics.update(loss=loss, lr=lr, grad_norm=stats["grad_norm"])
        return params, opt_state, metrics

    return step_fn, None


def loss_and_grads(cfg: ModelConfig, params, batch: dict):
    """-> (loss, metrics, grads): ``train_loss`` and its gradients by
    autograd on ``params``' device, detached (a leaf with no gradient
    gets zeros, as ``jax.grad`` gives)."""
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = lm.train_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.tree_unflatten(grads, pytree.tree_structure(params)))


def _sync(params) -> None:
    dev = pytree.tree_leaves(params)[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Trainer:
    cfg: ModelConfig
    opt: OptConfig
    train: TrainConfig
    mesh: Any = None
    fault_log: FaultLog = field(default_factory=FaultLog)
    opt_state: Any = None        # the optimizer state after ``fit``

    def fit(self, params, data_iter: Iterator[dict], *,
            resume: bool = True) -> tuple[Any, list[dict]]:
        """Trains ``params`` (updated in place; a resume replaces them by
        the checkpoint's, on their device) for the steps left to
        ``train.steps``. Returns (params, history): one record every
        ``log_every`` steps and at the last, with float ``loss``, ``ce``,
        ``lr``, ``grad_norm`` and ``dt``, the step's seconds to the end of
        its device work."""
        if self.mesh is not None:
            raise NotImplementedError(NO_MESH)
        step_fn, _ = make_train_step(self.cfg, self.opt, self.train)
        device = pytree.tree_leaves(params)[0].device
        opt_state = init_opt_state(self.opt, params)
        start = 0
        saver = None
        if self.train.ckpt_dir:
            saver = ckpt_lib.AsyncCheckpointer(self.train.ckpt_dir,
                                               keep=self.train.keep_ckpts)
            if resume:
                got = ckpt_lib.restore_latest(
                    self.train.ckpt_dir, {"params": params, "opt": opt_state},
                    device=device)
                if got[0] is not None:
                    start, tree, _ = got
                    params, opt_state = tree["params"], tree["opt"]
                    self.fault_log.record(start, "restart",
                                          f"resumed from step {start}")
        detector = StragglerDetector()
        history: list[dict] = []
        for step in range(start, self.train.steps):
            batch = next(data_iter)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            _sync(params)
            dt = time.perf_counter() - t0
            if detector.observe(step, dt):
                self.fault_log.record(step, "straggler", f"{dt:.3f}s")
            if step % self.train.log_every == 0 or \
                    step == self.train.steps - 1:
                history.append({"step": step,
                                "loss": float(metrics["loss"]),
                                "ce": float(metrics["ce"]),
                                "lr": float(metrics["lr"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "dt": dt})
            if saver and self.train.ckpt_every and \
                    (step + 1) % self.train.ckpt_every == 0:
                saver.save_async(step + 1, {"params": params,
                                            "opt": opt_state})
        if saver:
            saver.save_async(self.train.steps, {"params": params,
                                                "opt": opt_state})
            saver.wait()
        self.opt_state = opt_state
        return params, history
