"""Dry-run: trace every (arch x shape x mesh) cell on the production H100
mesh and read the per-device memory, FLOPs, bytes and collectives for the
roofline.

Each cell builds the train, prefill or serve step with DTensor
parameters, state and batch on the production mesh
(``launch.mesh.make_production_mesh``) under a fake process group of the
mesh's size (this process is rank 0) and ``FakeTensorMode`` (no tensor
holds memory), runs it once, and counts what rank 0's device would do
(:class:`StepTrace`): each operation on a local tensor, its FLOPs by
``torch.utils.flop_counter``'s formulas and the bytes of its inputs and
outputs; each collective DTensor issues, its result bytes by kind and by
mesh axis; and the live storages, whose peak is the device's. The trace
goes op by op, so a full-depth trace is exact;
:func:`extrapolated_costs` recovers the same totals from depth-1 and
depth-2 traces, as the reference does from its unrolled compiles.

The roofline (:func:`roofline_terms`) uses an H100 SXM's published
figures. Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>__
<variant>.json`` under the reference's keys.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, applicable,
                                 get_config, input_specs)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import activation_mesh
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.blocks import block_pattern, n_groups
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.trainer import loss_and_grads

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# NVIDIA H100 SXM, published figures (data sheet; not measured here)
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per GPU
HBM_BW = 3.35e12             # HBM3 B/s per GPU
NVLINK_BW = 450e9            # NVLink B/s a direction per GPU: 'model' axis
NET_BW = 50e9                # 400 Gb/s NDR per GPU: 'data' and 'pod' axes
ALLOC_ROUND = 512            # the CUDA caching allocator's block granule

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "send": "collective-permute", "recv_": "collective-permute"}
_NO_COST = {"wait_tensor"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
class StepTrace(TorchDispatchMode):
    """Counts, per device, what the operations run inside it do.

    A DTensor operation is passed on (``NotImplemented``) so that DTensor
    runs it as local operations and collectives, which come back here;
    every count is therefore rank 0's. FLOPs use
    ``torch.utils.flop_counter``'s formulas and fall back to an
    operation's decomposition where it has none, as ``FlopCounterMode``
    does, so the two agree on a one-rank mesh. Bytes accessed: each
    operation's tensor inputs and outputs (an in-place one's too), views
    (outputs on an input's storage), ``prim`` queries and collectives
    excepted. What DTensor's shape propagation runs (each operation on
    the global fake shapes, to learn its output's) is not counted: the
    trace wraps that propagation while it is entered, and ``skipped``
    counts what it let pass. Collectives: result bytes by kind and by
    mesh axis
    (``groups`` maps a process group's name to its axis). Memory: every
    storage an operation makes is live (its size rounded up to
    :data:`ALLOC_ROUND`) until it is freed; :meth:`track` adds the
    arguments' storages first."""

    def __init__(self, groups: dict | None = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.groups = groups or {}
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.axis_bytes: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.skipped = 0
        self._storages: dict[int, int] = {}
        self._entered = 0
        self._propagating = 0
        self._undo = None

    def __enter__(self):
        if self._entered == 0:
            self._undo = _mark_propagation(self)
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        if self._entered == 0:
            self._undo()
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return key
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)
        return key

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def track(self, tree) -> int:
        """Counts the local storages of ``tree``'s tensors as live (the
        step's arguments). Returns their bytes."""
        keys = {self._hold(t) for t in _locals(tree)}
        return sum(self._storages[k] for k in keys)

    def storages(self, tree) -> set:
        return {id(t.untyped_storage()) for t in _locals(tree)}

    def bytes_of(self, keys) -> int:
        return sum(self._storages.get(k, 0) for k in keys)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._propagating:
            self.skipped += 1
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                _on_meta(args, kwargs):
            return func(*args, **kwargs)
        if func not in self._flops_of and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ns, name = packet._qualified_op_name.split("::")
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            b = sum(_nbytes(t) for t in outs) if name != "send" else \
                sum(_nbytes(t) for t in pytree.tree_leaves(args)
                    if isinstance(t, torch.Tensor))
            group = next((a for a in pytree.tree_leaves((args, kwargs))
                          if isinstance(a, str) and a in self.groups), None)
            axis = self.groups.get(group, "other")
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + b
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + b
        elif ns != "prim" and name not in _NO_COST:
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if func._schema.is_mutable or not _aliases(outs, ins):
                self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out

    def collectives(self) -> dict:
        return {"bytes": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values()),
                "axis_bytes": dict(self.axis_bytes)}


def _aliases(outs, ins) -> bool:
    """Every output shares a storage with an input (a view, however the
    schema names it)."""
    held = {id(t.untyped_storage()) for t in ins}
    return bool(outs) and all(id(t.untyped_storage()) in held for t in outs)


def _on_meta(args, kwargs) -> bool:
    """An operation no device runs: one on ``meta`` tensors."""
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in pytree.tree_leaves((args, kwargs)))


def _mark_propagation(trace: StepTrace):
    """Wraps DTensor's shape propagation (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, in torch 2.11 and 2.13) so that
    ``trace`` knows while it runs; returns the undo. A torch without it
    raises here: a trace that could not tell would count each operation
    twice, once at its global shapes."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    inner = ShardingPropagator._propagate_tensor_meta_non_cached

    def propagate(self, *args, **kwargs):
        trace._propagating += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            trace._propagating -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = propagate
    return lambda: setattr(ShardingPropagator,
                           "_propagate_tensor_meta_non_cached", inner)


def _locals(tree):
    from torch.distributed.tensor import DTensor
    for t in pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            yield t.to_local()
        elif isinstance(t, torch.Tensor):
            yield t


def mesh_groups(mesh) -> dict:
    """Process-group name -> mesh axis name, for each axis of ``mesh``."""
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def pick_optimizer(cfg: ModelConfig) -> OptConfig:
    """AdamW8 past 5e10 parameters, AdamW under. AdamW keeps 12 B a
    parameter (bf16 weight and gradient, two float32 moments); spread
    over a 256-GPU mesh (8 model-parallel x 32 ZeRO-1 data ranks, which
    FSDP puts on the weights too) 5e10 parameters come to about 6 GB a
    GPU of state alone at the 40 GB a GPU the full state would take on 8
    GPUs of one node, the budget of an 80 GB H100 that must also hold the
    activations. The reference's 5e10 ("fits 16 GB a chip") keeps the
    same two MoE giants on AdamW8."""
    if cfg.param_count() > 5e10:
        return OptConfig(name="adamw8")
    return OptConfig(name="adamw")


def _microbatches(batch: dict, n: int):
    """The batch cut into ``n`` along each rank's local batch (DTensor
    leaves keep their placements)."""
    from torch.distributed.tensor import DTensor
    if n <= 1:
        return [batch]
    out = [dict() for _ in range(n)]
    for k, v in batch.items():
        loc = v.to_local() if isinstance(v, DTensor) else v
        step = loc.shape[0] // n
        for i in range(n):
            part = loc[i * step:(i + 1) * step]
            out[i][k] = DTensor.from_local(part, v.device_mesh, v.placements,
                                           run_check=False) \
                if isinstance(v, DTensor) else part
    return out


def serve_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """The serve cells' config: the int8 dictionary-quantized KV cache (the
    production serving default; ``kv_bf16`` keeps bf16 through its
    sentinel dtype), and ``pure_dp`` off for decode (ZeRO-3 weight
    gathers would dominate a token's latency)."""
    if cfg.kv_cache_dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if cfg.pure_dp and shape.kind == "decode":
        cfg = dataclasses.replace(cfg, pure_dp=False)
    return cfg


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, device):
    """-> (step, args): the cell's step on ``mesh`` and its
    placed arguments (parameters, state, batch), zeros of each rank's
    part on ``device`` (fake ones under ``FakeTensorMode``, for a trace;
    :func:`fill` gives a real run values)."""
    batch = input_specs(cfg, shape)
    batch = shd.zeros_placed(batch, shd.batch_pspecs(cfg, batch, mesh), mesh,
                             device)
    if shape.kind == "train":
        p_shape = lm.param_specs(cfg)
        p_specs = shd.param_pspecs(cfg, p_shape, mesh)
        params = shd.zeros_placed(p_shape, p_specs, mesh, device)
        opt = pick_optimizer(cfg)
        o_specs = shd.opt_pspecs(cfg, init_opt_state(opt, p_shape), mesh,
                                 p_specs, p_shape)
        state = shd.distribute(init_opt_state(opt, params), o_specs, mesh)
        accum = max(1, cfg.grad_accum)

        def train_step(params, state, batch):
            grads, loss = None, 0.0
            for mb in _microbatches(batch, accum):
                l, _, g = loss_and_grads(cfg, params, mb)
                grads = g if grads is None else pytree.tree_map(
                    torch.add, grads, g)
                loss = loss + l
            if accum > 1:
                grads = pytree.tree_map(lambda g: g / accum, grads)
                loss = loss / accum
            lr = torch.tensor(3e-4, dtype=torch.float32)
            params, state = apply_updates(opt, grads, state, params, lr)
            return params, state, loss

        return train_step, (params, state, batch)

    cfg = serve_config(cfg, shape)
    p_shape = lm.param_specs(cfg)
    params = shd.zeros_placed(p_shape, shd.param_pspecs(cfg, p_shape, mesh),
                              mesh, device)
    enc_len = shape.seq_len if cfg.family == "audio" else 0
    state = lm.init_serve_state(cfg, shape.global_batch, max_len=shape.seq_len,
                                device="meta", enc_len=enc_len)
    state = shd.zeros_placed(state, shd.state_pspecs(cfg, state, mesh), mesh,
                             device)

    if shape.kind == "prefill":
        def prefill_step(params, state, batch):
            logits, state = lm.prefill(cfg, params, state, batch)
            return logits[:, -1], state         # the last token's logits
        return prefill_step, (params, state, batch)

    def serve_step(params, state, batch):
        # one token against a full cache: the state enters at seq_len - 1
        state = dict(state, pos=shape.seq_len - 1)
        logits, state = lm.decode_step(cfg, params, state, batch["tokens"])
        return logits[:, -1], state
    return serve_step, (params, state, batch)


def fill(args, cfg: ModelConfig, seed: int = 0) -> None:
    """Values for a cell built from real (not fake) tensors, in place:
    parameters N(0, 0.02), token ids in [0, vocab), other batch inputs
    N(0, 1); states stay the zeros they were built as. For running a
    cell's step for real (its FLOPs, memory and time do not depend on
    these values, a MoE's routing aside)."""
    gen = torch.Generator(device=next(_locals(args)).device)
    gen.manual_seed(seed)
    for t in _locals(args[0]):
        t.normal_(0.0, 0.02, generator=gen)
    for t in _locals(args[2]):
        if t.dtype.is_floating_point:
            t.normal_(generator=gen)
        else:
            t.random_(0, cfg.vocab, generator=gen)


def step_context(kind: str):
    """What a cell's step runs under: ``implicit_replication`` (the
    model's own tables and masks are plain tensors, the same on every
    rank), and no autograd to serve."""
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    if kind != "train":
        stack.enter_context(torch.no_grad())
    return stack


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, device="cpu",
               seq_parallel: bool = True) -> dict:
    """One step of the cell traced on ``mesh`` (its process group must be
    running) under ``FakeTensorMode`` (no memory, no values): rank 0's
    FLOPs, bytes accessed, memory and collectives."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build_cell(cfg, shape, mesh, device)
        tr = StepTrace(mesh_groups(mesh))
        arg_keys = tr.storages(args)
        argument_bytes = tr.track(args)
        t1 = time.perf_counter()
        with activation_mesh(mesh if seq_parallel else None), \
                step_context(shape.kind), tr:
            out = step(*args)
        out_keys = tr.storages(out)
        output_bytes = tr.bytes_of(out_keys)
        alias_bytes = tr.bytes_of(out_keys & arg_keys)
        mem = {"argument_bytes": argument_bytes,
               "output_bytes": output_bytes,
               "alias_bytes": alias_bytes,
               "temp_bytes": tr.peak - argument_bytes - output_bytes +
               alias_bytes,
               "peak_bytes": tr.peak}
        del out, args, step
    t2 = time.perf_counter()
    return {"flops": float(tr.flops), "bytes_accessed": float(
        tr.bytes_accessed), "memory": mem, "collectives": tr.collectives(),
        "times": {"build_s": t1 - t0, "trace_s": t2 - t1}}


def _with_depth(cfg: ModelConfig, groups: int) -> ModelConfig:
    """The config cut to ``groups`` pattern groups (and as many encoder
    layers, at most its own), one microbatch: totals are the same for any
    count of microbatches."""
    pat_len = len(block_pattern(cfg))
    enc = min(cfg.enc_layers, groups) if cfg.enc_layers else 0
    return dataclasses.replace(cfg, n_layers=groups * pat_len,
                               enc_layers=enc, grad_accum=1)


def extrapolated_costs(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                       device="cpu", seq_parallel: bool = True) -> dict:
    """Totals at full depth from depth-1 and depth-2 traces: total(G) =
    outside + G x per_group, each cost affine in the group count G (an
    encoder's depth moves with the decoder's)."""
    g_full = n_groups(cfg)
    stats = {g: trace_cell(_with_depth(cfg, g), shape, mesh, device=device,
                           seq_parallel=seq_parallel)
             for g in (1, 2)}
    out: dict = {}
    for key in ("flops", "bytes_accessed"):
        per_group = stats[2][key] - stats[1][key]
        outside = stats[1][key] - per_group
        out[key] = outside + per_group * g_full
        out[key + "_per_group"] = per_group
        out[key + "_outside"] = outside

    def extra(field: str) -> dict:
        a, b = (stats[g]["collectives"][field] for g in (1, 2))
        got = {}
        for k in set(a) | set(b):
            per = max(b.get(k, 0) - a.get(k, 0), 0)
            got[k] = max(a.get(k, 0) - per + per * g_full, 0)
        return got

    out["collective_bytes"] = extra("bytes")
    out["collective_total_bytes"] = float(sum(out["collective_bytes"]
                                              .values()))
    out["collective_axis_bytes"] = extra("axis_bytes")
    out["note"] = ("enc+dec depths differenced together"
                   if cfg.enc_layers else "")
    return out


def roofline_terms(flops: float, hbm_bytes: float, nvlink_bytes: float,
                   n_chips: int, net_bytes: float = 0.0) -> dict:
    """Seconds at the H100's published rates: compute, HBM, and the
    collectives (``nvlink_bytes`` per device over NVLink, ``net_bytes``
    over the network); the dominant term is the bound."""
    terms = {"compute_s": flops / (n_chips * PEAK_FLOPS),
             "memory_s": hbm_bytes / (n_chips * HBM_BW),
             "collective_s": nvlink_bytes / NVLINK_BW + net_bytes / NET_BW}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    return terms


def link_bytes(axis_bytes: dict) -> tuple[float, float]:
    """(NVLink bytes, network bytes): ``model`` stays inside a node."""
    nv = float(axis_bytes.get("model", 0))
    return nv, float(sum(axis_bytes.values())) - nv


# ---------------------------------------------------------------------------
# variants (knobs; 'baseline' is the production default)
# ---------------------------------------------------------------------------
def _replace(**kw):
    return lambda cfg: dataclasses.replace(cfg, **kw)


VARIANTS = {
    # name: (seq_parallel, cfg_transform)
    "baseline": (True, None),           # production default: Megatron-SP
    "naive": (False, None),             # plain tensor parallelism
    "remat_dots": (True, _replace(remat="dots")),
    "no_remat": (True, _replace(remat="none")),
    "accum2": (True, _replace(grad_accum=2)),
    "accum4": (True, _replace(grad_accum=4)),
    # the sentinel dtype skips the int8 upgrade; init_serve_state treats
    # anything but 'int8' as bf16
    "kv_bf16": (True, _replace(kv_cache_dtype="bf16_forced")),
    "dp": (True, _replace(pure_dp=True)),
    "fsdp": (True, _replace(force_fsdp=True)),
    "dp_dots": (True, _replace(pure_dp=True, remat="dots")),
    "accum4_dots": (True, _replace(grad_accum=4, remat="dots")),
    "accum8": (True, _replace(grad_accum=8)),
    "fsdp_accum2": (True, _replace(force_fsdp=True, grad_accum=2)),
    "cap10": (True, _replace(capacity_factor=1.0)),
}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6 N D to train (forward and backward), 2 N D to serve, N the
    active parameters, D the tokens."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 3 if shape.kind == "train" else 1
    return 2.0 * cfg.active_param_count() * tokens * mult


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             variant: str = "baseline", cfg_override=None,
             shape: ShapeSpec | None = None, mesh_shape=None,
             device_type: str = "cuda") -> dict:
    """One cell under a fake process group of its mesh's size. The
    production mesh unless ``mesh_shape`` ((data, model) or (pod, data,
    model) sizes) is given; ``shape``/``cfg_override`` replace the named
    ones (reduced cells in tests)."""
    cfg = cfg_override or get_config(arch)
    seq_parallel, cfg_fn = VARIANTS.get(variant, (True, None))
    if cfg_fn is not None:
        cfg = cfg_fn(cfg)
    shape = shape or SHAPES[shape_name]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "variant": variant}
    ok, reason = applicable(cfg, shape)
    if not ok:
        result["status"] = reason
        return result
    multi = mesh_kind == "multi"
    n_chips = math.prod(mesh_shape) if mesh_shape else (512 if multi
                                                          else 256)
    t0 = time.perf_counter()
    with fake_world(n_chips):
        if mesh_shape:
            from torch.distributed.device_mesh import init_device_mesh
            axes = ("pod", "data", "model")[-len(mesh_shape):]
            mesh = init_device_mesh(device_type, tuple(mesh_shape),
                                    mesh_dim_names=axes)
        else:
            mesh = make_production_mesh(multi, device_type)
        raw = trace_cell(cfg, shape, mesh, device=device_type,
                         seq_parallel=seq_parallel)
        times = raw.pop("times")
        result.update(status="ok", n_chips=n_chips, times=times, raw=raw)
        if mesh_kind == "single":
            extra = extrapolated_costs(cfg, shape, mesh, device=device_type,
                                       seq_parallel=seq_parallel)
            result["extrapolated"] = extra
            nv, net = link_bytes(extra["collective_axis_bytes"])
            result["roofline"] = roofline_terms(
                extra["flops"], extra["bytes_accessed"], nv, 1, net)
            result["model_flops"] = model_flops(cfg, shape)
    result["wall_s"] = time.perf_counter() - t0
    return result


def save_result(res: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{res['arch']}__{res['shape']}__{res['mesh']}__{res['variant']}"
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=float)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (--arch all --shape all)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device-type", default="cuda",
                    help="the fake mesh's device type (cuda, or cpu)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape == "all" \
        else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                name = f"{arch}__{shape}__{mesh_kind}__{args.variant}"
                path = os.path.join(args.out, name + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {name}")
                    continue
                print(f"[cell] {name} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind, args.variant,
                                   device_type=args.device_type)
                except Exception as e:          # one cell's failure
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "variant": args.variant, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                save_result(res, args.out)
                extra = ""
                if res.get("status") == "ok" and "roofline" in res:
                    r = res["roofline"]
                    extra = (f" dom={r['dominant']} "
                             f"bound={r['bound_s'] * 1e3:.2f}ms")
                print(f"       -> {res.get('status')}{extra} "
                      f"({res.get('wall_s', 0):.0f}s)", flush=True)


if __name__ == "__main__":
    main()
