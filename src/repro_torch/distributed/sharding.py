"""Sharding rules: where each tensor of a model, its optimizer state, its
batch and its serve state lives on a device mesh, and the placement rules
of sharded feature serving.

The training half follows the reference's ``repro.distributed.sharding``
rule for rule (:func:`param_pspecs`, :func:`batch_pspecs`,
:func:`state_pspecs`). A rule returns a :class:`Spec` per tensor: one
entry per tensor dim, each a mesh-axis name, a tuple of names (major to
minor) or ``None``, as a ``PartitionSpec``'s entries are. The rules read
only ``mesh.shape`` (a mapping of axis name to size; see
:func:`mesh_shape`), so they run on the full-size configs' ``meta``
parameters with no device at all. :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh`` and :func:`distribute` puts a tree
there. Every rule checks the dim against the mesh axis and replicates
where it does not divide (qwen2's 28 heads on an 8-way model axis shard
the fused H*hd dim instead). The token dictionary (the embedding, the
paper's learned ADV) and the vocab head are row- and column-sharded over
``model``.

Serving: placement rules of sharded feature serving.

Each IMCU shard of a packed plan keeps its resident word stream on one
device of the serve pool, and a hot shard may keep replicas on others. The
helpers here decide where: the pool itself (:func:`serve_mesh`), the owner
of each shard (:func:`serve_devices`), the pool without dead devices
(:func:`surviving_devices`), a byte ledger per device
(:class:`DeviceBudget`) and the device a replica or a fresh tail shard goes
to (:func:`replica_device`).

Every load, byte and health map here is keyed by the ``torch.device``
itself, which is hashable and compares by value: two
``torch.device("cuda:0")`` objects are one key. Keying by ``id(device)``
would make one card several devices (each ``torch.device`` call builds a
new object), and shards on the card would each get their own copy of the
ADV tables with no error. Devices are made canonical first
(:func:`canonical_device`), so ``cuda`` and ``cuda:0`` are one key too.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import TYPE_CHECKING

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.launch import device_kind

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig

# Auto-FSDP when a model shard's bf16 parameters pass 3/8 of an H100's 80
# GB (the reference's 6e9 is the same 3/8 of a 16 GB chip).
FSDP_SHARD_BYTES = 30e9
SMALL_LEAF = 1 << 20          # leaves under this many entries stay whole


class Spec(tuple):
    """A ``PartitionSpec``: one entry per tensor dim, a mesh-axis name, a
    tuple of names (major to minor) or ``None``; a one-name tuple is that
    name, as ``PartitionSpec`` keeps it. A tuple subclass, so a pytree
    keeps it whole as a leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (its ``mesh_dim_names``) or of
    anything whose ``shape`` is already such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: dict, name: str) -> int:
    return shape.get(name, 1)


def batch_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') on multi-pod, ('data',)
    otherwise."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _div(size: int, n: int) -> bool:
    return n > 0 and size % n == 0


def _shard_if(shape: dict, size: int, axis: str):
    return axis if _div(size, _axis_size(shape, axis)) else None


def _batch_spec_axis(shape: dict, b: int, axes=None):
    """The DP axes if their product divides ``b``, else the first single
    one that does, else None."""
    axes = tuple(a for a in ("pod", "data") if a in shape) \
        if axes is None else axes
    total = math.prod(_axis_size(shape, a) for a in axes)
    if _div(b, total):
        return axes
    for a in axes:
        if _div(b, _axis_size(shape, a)):
            return (a,)
    return None


def _leaf_name(path) -> str:
    k = path[-1]
    return str(getattr(k, "key", getattr(k, "idx", "")))


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def _largest_free(entries: list, dims, n: int) -> int:
    """The largest dim with no entry that ``n`` divides, or -1 (the first
    of equal sizes)."""
    best, best_size = -1, 0
    for i, (e, sz) in enumerate(zip(entries, dims)):
        if e is None and sz % n == 0 and sz > best_size:
            best, best_size = i, sz
    return best


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
COLUMN = {"wq", "wk", "wv", "wu", "wg", "w_up", "w_in", "w", "head", "bq",
          "bk", "bv", "conv_w"}
ROW = {"wo", "wd", "w_down", "w_o_ssm", "w_bc", "w_dt", "wif"}
EXPERT = {"we_gate", "we_up", "we_down"}
REPLICATED = {"ln", "ln1", "ln2", "ln_x", "ln_heads", "final_norm",
              "enc_norm", "norm_attn", "norm_ssm", "router", "a_log", "b",
              "r", "vis_proj", "enc_proj"}


def param_pspecs(cfg: ModelConfig, params_tree, mesh,
                 fsdp: bool | None = None):
    """A :class:`Spec` per parameter (``meta`` tensors will do).

    ``fsdp``: also shard every large parameter over ``data`` (ZeRO-3; the
    per-layer all-gather follows from the placements). ``None`` turns it
    on when ``cfg.force_fsdp`` or when a model shard's bf16 parameters
    pass :data:`FSDP_SHARD_BYTES`. ``cfg.pure_dp`` (ZeRO-3 over
    ``model``): every large parameter sharded over ``model`` on its
    largest divisible dim, the batch over every axis."""
    shape = mesh_shape(mesh)
    m = _axis_size(shape, "model")
    d_ax = _axis_size(shape, "data")
    if fsdp is None:
        fsdp = cfg.force_fsdp or \
            cfg.param_count() * 2 / max(m, 1) > FSDP_SHARD_BYTES

    if cfg.pure_dp:
        def dp_rule(path, leaf):
            dims = tuple(leaf.shape)
            entries = [None] * len(dims)
            if math.prod(dims) >= SMALL_LEAF:
                best = _largest_free(entries, dims, m)
                if best >= 0:
                    entries[best] = "model"
            return Spec(*entries)
        return pytree.tree_map_with_path(dp_rule, params_tree)

    def fsdp_extend(spec: list, dims) -> Spec:
        if fsdp and d_ax > 1 and math.prod(dims) >= SMALL_LEAF:
            best = _largest_free(spec, dims, d_ax)
            if best >= 0:
                spec[best] = "data"
        return Spec(*spec)

    def rule(path, leaf) -> Spec:
        name = _leaf_name(path)
        dims = tuple(leaf.shape)
        nd = len(dims)

        def at(i):
            spec = [None] * nd
            spec[i] = _shard_if(shape, dims[i], "model")
            return spec

        if name == "embed":
            return fsdp_extend(at(0), dims)           # vocab rows
        if name in REPLICATED:
            return Spec(*([None] * nd))
        if name in EXPERT:
            return fsdp_extend(at(1), dims)           # expert parallel
        if name in COLUMN:
            return fsdp_extend(at(nd - 1), dims)      # column parallel
        if name in ROW:
            return fsdp_extend(at(nd - 2), dims)      # row parallel
        return Spec(*([None] * nd))

    return pytree.tree_map_with_path(rule, params_tree)


# ---------------------------------------------------------------------------
# batch rules
# ---------------------------------------------------------------------------
def batch_pspecs(cfg: ModelConfig, batch_tree, mesh):
    """The batch dim over the DP axes (every axis under ``pure_dp`` where
    their product divides it), the rest whole."""
    shape = mesh_shape(mesh)

    def rule(leaf) -> Spec:
        dims = tuple(leaf.shape)
        if cfg.pure_dp:
            axes = tuple(a for a in ("pod", "data", "model") if a in shape)
            ba = axes if _div(dims[0], math.prod(
                _axis_size(shape, a) for a in axes)) else \
                _batch_spec_axis(shape, dims[0])
        else:
            ba = _batch_spec_axis(shape, dims[0])
        return Spec(ba, *([None] * (len(dims) - 1)))

    return pytree.tree_map(rule, batch_tree)


# ---------------------------------------------------------------------------
# serve-state rules
# ---------------------------------------------------------------------------
def state_pspecs(cfg: ModelConfig, state_tree, mesh):
    """Caches: the batch over the DP axes, the cache length or a state dim
    over ``model``. Every block cache leads with the group axis (never
    sharded), then the batch. An attention cache (G,B,T,KV,hd) shards T
    (sequence-sharded decode attention); a recurrent state its ``dk``,
    else ``dv``; a conv history its channels; sLSTM's h and c their head
    dim. ``pos`` (a host int) gets ``Spec()``."""
    shape = mesh_shape(mesh)

    def rule(path, leaf) -> Spec:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                        for k in path)
        if name == "pos" or not isinstance(leaf, torch.Tensor):
            return Spec()
        dims = tuple(leaf.shape)
        if name == "memory":                       # (B, S_enc, D)
            return Spec(_batch_spec_axis(shape, dims[0]),
                        _shard_if(shape, dims[1], "model"), None)
        nd = len(dims)
        if nd < 3:
            return Spec(*([None] * nd))
        spec: list = [None, _batch_spec_axis(shape, dims[1])] + \
            [None] * (nd - 2)
        if name.endswith((".k", ".v", ".ks", ".vs")):
            spec[2] = _shard_if(shape, dims[2], "model")     # cache length
        elif "state" in name:                  # (G,B,H,dk,dv): dk, else dv
            if _shard_if(shape, dims[3], "model"):
                spec[3] = "model"
            elif nd > 4 and _shard_if(shape, dims[4], "model"):
                spec[4] = "model"
        elif "conv" in name:
            spec[3] = _shard_if(shape, dims[3], "model")     # d_inner
        elif name.endswith((".h", ".c")):
            spec[3] = _shard_if(shape, dims[3], "model")     # head dim
        return Spec(*spec)

    return pytree.tree_map_with_path(rule, state_tree)


# ---------------------------------------------------------------------------
# optimizer-state rules (ZeRO-1)
# ---------------------------------------------------------------------------
def _has_axis(spec, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


def opt_pspecs(cfg: ModelConfig, opt_state, mesh, p_specs, p_shapes):
    """Optimizer-state specs, as the reference's ``trainer._opt_pspecs``:

    - AdamW's moments take their parameter's spec plus ``data`` on its
      largest free dim that divides (ZeRO-1; a parameter that already
      carries ``data`` under FSDP keeps its spec);
    - AdamW8's ``{"q", "scale"}`` bundles: ``q`` that extended spec,
      ``scale`` the same without its last entry (one value per row);
    - Adafactor's factored statistics are small and replicated.

    ``p_specs``/``p_shapes``: the parameters' specs and shapes, the same
    tree; ``step`` (a host int) gets ``Spec()``."""
    data = _axis_size(mesh_shape(mesh), "data")

    def zero1(spec, dims) -> Spec:
        entries = list(spec) + [None] * (len(dims) - len(spec))
        if data > 1 and not _has_axis(entries, "data"):
            best = _largest_free(entries, dims, data)
            if best >= 0:
                entries[best] = "data"
        return Spec(*entries)

    spec_leaves, spec_tree = pytree.tree_flatten(p_specs)
    shape_leaves = spec_tree.flatten_up_to(p_shapes)
    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v"):
            built = []
            for sp, p, st in zip(spec_leaves, shape_leaves,
                                 spec_tree.flatten_up_to(sub)):
                ext = zero1(sp, tuple(p.shape))
                if isinstance(st, dict):
                    built.append({"q": ext, "scale": Spec(*ext[:-1])})
                else:
                    built.append(ext)
            out[key] = pytree.tree_unflatten(built, spec_tree)
        elif key == "f":
            out[key] = pytree.tree_map(lambda t: Spec(*([None] * t.ndim)),
                                       sub)
        else:
            out[key] = Spec()
    return out


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def placements(spec, mesh) -> tuple:
    """A spec -> one DTensor placement per mesh dim: ``Shard(d)`` on the
    mesh dims that tensor dim ``d`` names, ``Replicate()`` on the rest.
    Where two mesh axes shard one dim, the spec names them major to minor
    in mesh order, which is the order DTensor splits them in; another
    order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(placements_, mesh, ndim: int) -> Spec:
    """The inverse of :func:`placements`: the spec a DTensor's
    placements stand for (a ``Partial`` counts as not sharded)."""
    from torch.distributed.tensor import Shard
    entries: list = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements_):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(name)
    return Spec(*(None if not e else e[0] if len(e) == 1 else tuple(e)
                  for e in entries))


def local_range(size: int, placements_, mesh, dim: int) -> tuple[int, int]:
    """(first, length) of this rank's part of a dim of ``size`` split by
    ``placements_`` (``torch.chunk``'s rule: ceil-sized parts, the last
    ones short or empty), nested in mesh order."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    first = 0
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard) and pl.dim == dim:
            step = -(-size // mesh.size(i))
            cut = min(step * coord[i], size)
            first, size = first + cut, min(step, size - cut)
    return first, size


def _cuts(shape, placements_, mesh) -> dict:
    """{dim: (first, length)} of this rank's part, for each split dim."""
    from torch.distributed.tensor import Shard
    return {d: local_range(shape[d], placements_, mesh, d)
            for d in {p.dim for p in placements_ if isinstance(p, Shard)}}


def _from_local(local: torch.Tensor, like, placements_, mesh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=like.shape,
                              stride=_contiguous(like.shape))


def zeros_placed(tree, specs, mesh, device):
    """DTensors of zeros shaped as ``tree``'s (``meta``) tensors, placed by
    ``specs``, each rank allocating only its own part (nothing whole is
    made first). Other leaves stay as they are."""
    def put(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(spec, mesh)
        local = list(t.shape)
        for d, (_, n) in _cuts(t.shape, pl, mesh).items():
            local[d] = n
        return _from_local(torch.zeros(local, dtype=t.dtype, device=device),
                           t, pl, mesh)

    return pytree.tree_map(put, specs, tree, is_leaf=_is_spec)


def split_placed(tree, specs, mesh, device):
    """DTensors cut from ``tree``'s whole host tensors by ``specs``: each
    rank copies only its own part to ``device`` (the reference's
    ``device_put`` of host arrays), so nothing whole reaches a device.
    Other leaves stay as they are."""
    def put(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(spec, mesh)
        part = t
        for d, (first, n) in _cuts(t.shape, pl, mesh).items():
            part = part.narrow(d, first, n)
        return _from_local(part.to(device, copy=True,
                                   memory_format=torch.contiguous_format),
                           t, pl, mesh)

    return pytree.tree_map(put, specs, tree, is_leaf=_is_spec)


def _contiguous(shape) -> tuple:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def distribute(tree, specs, mesh):
    """``tree``'s tensors put on ``mesh`` by ``specs`` (the same tree): a
    plain tensor is cut from the whole one every rank holds (no data
    moves; ``distribute_tensor`` with no source rank), a DTensor is
    redistributed. Other leaves (a host int) stay as they are. The
    reference's ``to_shardings`` and ``device_put`` in one."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def put(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(spec, mesh)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else \
                t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return pytree.tree_map(put, specs, tree, is_leaf=_is_spec)


def canonical_device(device) -> torch.device:
    """``device`` as the one key the serve maps use: ``cuda`` with no index
    is ``cuda:0`` (the only card the launchers use), ``cpu`` carries no
    index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    if device.type == "cpu":
        return torch.device("cpu")
    return device


def serve_mesh(devices) -> list[torch.device]:
    """The serve pool: ``devices`` made canonical, in order (a device may
    repeat; it is still one key). Raises on an empty pool and on a device
    the kernels cannot launch on (:func:`repro_torch.kernels.launch.
    device_kind`: CUDA devices other than ``cuda:0`` are refused), before
    anything is put there."""
    devices = [canonical_device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to build a serve pool over")
    for d in devices:
        device_kind(d)
    return devices


def serve_devices(n_shards: int, devices) -> list[torch.device]:
    """Owning device for each of ``n_shards`` IMCU shards, round-robin over
    the pool, so fresh IMCUs land on successive devices. With fewer devices
    than shards several shards share a device: their resident streams stay
    distinct, only the placement coincides."""
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to place shards on")
    return [devices[i % len(devices)] for i in range(n_shards)]


def surviving_devices(devices, lost=frozenset()) -> list[torch.device]:
    """The pool minus the devices in ``lost`` (dead ones). Unlike
    :func:`replica_device`'s ``unhealthy`` set, a lost device is never
    picked: an empty list is returned as it is and the caller decides."""
    return [d for d in devices if d not in lost]


class DeviceBudget:
    """Per-device byte ledger of resident word streams, keyed by device,
    against an optional uniform per-device budget (``None``: no cap, every
    :meth:`fits` succeeds). The ADV tables are not charged: they are K-row
    constants shared by every stream on a device, while the budget governs
    what grows with table rows."""

    def __init__(self, budget_bytes: int | None = None):
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._bytes: dict[torch.device, int] = {}

    def bytes(self, device) -> int:
        return self._bytes.get(device, 0)

    def charge(self, device, n: int) -> None:
        self._bytes[device] = self._bytes.get(device, 0) + int(n)

    def release(self, device, n: int) -> None:
        left = self._bytes.get(device, 0) - int(n)
        if left < 0:
            raise ValueError(
                f"release of {n}B underflows device {device} "
                f"({self._bytes.get(device, 0)}B charged)")
        if left:
            self._bytes[device] = left
        else:
            self._bytes.pop(device, None)

    def fits(self, device, n: int) -> bool:
        return (self.budget_bytes is None
                or self.bytes(device) + int(n) <= self.budget_bytes)

    def headroom(self, device) -> int | None:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.bytes(device)

    def over_budget(self) -> dict:
        """Devices above the cap -> bytes over (empty when uncapped)."""
        if self.budget_bytes is None:
            return {}
        return {d: b - self.budget_bytes for d, b in self._bytes.items()
                if b > self.budget_bytes}


def replica_device(devices, load: dict | None = None, exclude=frozenset(),
                   unhealthy=frozenset()):
    """Where an adaptive stream (a replica or a fresh tail shard) goes: the
    pool device with the fewest resident launch streams (``load`` maps
    device -> streams, missing = 0). Devices in ``exclude`` already hold a
    stream of the same shard and those in ``unhealthy`` have failing
    streams; both are taken only when nothing else is left. Ties break on
    pool order, so placement is deterministic."""
    devices = list(devices)
    if not devices:
        raise ValueError("no devices to place a replica on")
    load = load or {}
    pool = ([d for d in devices if d not in exclude and d not in unhealthy]
            or [d for d in devices if d not in exclude]
            or devices)
    return min(pool, key=lambda d: load.get(d, 0))
