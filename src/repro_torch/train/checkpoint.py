"""Step-granular checkpointing: a tree of tensors -> npz + JSON manifest, in
the reference's on-disk format, so each package restores the other's.

Fault-tolerance contract:
- atomic: write to ``step_<n>.tmp/`` then rename — a crash mid-write never
  corrupts the latest checkpoint;
- async: ``save_async`` snapshots to host memory on the caller's thread,
  then writes on a daemon thread so the train loop keeps going;
- restart: ``restore_latest`` finds the newest complete step; ``restore``
  puts the arrays on ``device`` (moving them onto another mesh is not
  ported).

Leaves are named by their key paths (``['blocks'][0]['wq']``), a dict's
keys in sorted order, as the reference's ``tree_flatten_with_path`` names
and orders them; ``arrays_p0.npz`` holds leaf i as ``"i"``, and
``manifest.json`` has ``step``, ``names`` and ``extra``. A bfloat16 leaf
is stored as raw 2-byte records (numpy ``'<V2'``), as ``np.savez`` stores
the reference's bfloat16 arrays; a host int leaf (the port's optimizer
``step``) as an int32 scalar, and restored as an int.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.pipeline import resolve_device


def _flatten_with_names(tree, path: str = "") -> tuple[list, list]:
    if isinstance(tree, dict):
        names, leaves = [], []
        for k in sorted(tree):
            n, l = _flatten_with_names(tree[k], f"{path}[{k!r}]")
            names += n
            leaves += l
        return names, leaves
    if isinstance(tree, (list, tuple)):
        names, leaves = [], []
        for i, x in enumerate(tree):
            n, l = _flatten_with_names(x, f"{path}[{i}]")
            names += n
            leaves += l
        return names, leaves
    if tree is None:
        return [], []
    return [path], [tree]


def _unflatten(tree, values):
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], values) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, values) for x in tree)
    if tree is None:
        return None
    return next(values)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    return np.asarray(x)


def _from_host(a: np.ndarray, like, device):
    if not isinstance(like, torch.Tensor):
        return a.item() if isinstance(like, (int, float)) else a
    if a.dtype.kind == "V" and a.dtype.itemsize == 2 or \
            a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def _write(ckpt_dir: str, step: int, names: list, host: list,
           extra: dict | None) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step:08d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays_p0.npz"),
             **{str(i): a for i, a in enumerate(host)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "names": names, "n_processes": 1,
                   "extra": extra or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: Any,
         extra: dict | None = None) -> str:
    """Blocking save. Returns the final checkpoint path."""
    names, leaves = _flatten_with_names(tree)
    return _write(ckpt_dir, step, names, [_to_host(x) for x in leaves], extra)


class AsyncCheckpointer:
    """Snapshot on caller thread; write on a daemon thread; one in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        names, leaves = _flatten_with_names(tree)
        host = [_to_host(x) for x in leaves]

        def _run():
            _write(self.ckpt_dir, step, names, host, extra)
            self._gc()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(latest_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d[5:]))
    return sorted(out)


def restore(ckpt_dir: str, step: int, tree_like: Any,
            device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (values are ignored):
    each tensor leaf onto ``device`` (``cuda`` unless named), a bfloat16
    one from its raw records, a host int leaf as an int. A structure that
    differs from the checkpoint's raises ``ValueError``."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names, leaves = _flatten_with_names(tree_like)
    if names != manifest["names"]:
        raise ValueError("checkpoint tree structure mismatch: "
                         f"{set(names) ^ set(manifest['names'])}")
    with np.load(os.path.join(path, "arrays_p0.npz")) as data:
        arrays = [_from_host(data[str(i)], like, device)
                  for i, like in enumerate(leaves)]
    return _unflatten(tree_like, iter(arrays)), manifest["extra"]


def restore_latest(ckpt_dir: str, tree_like: Any, device=None):
    steps = latest_steps(ckpt_dir)
    if not steps:
        return None, None, None
    tree, extra = restore(ckpt_dir, steps[-1], tree_like, device)
    return steps[-1], tree, extra
