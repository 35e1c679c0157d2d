"""LM assembly: embedding (the token dictionary's learned ADV) -> block
stack (a loop over groups) -> head -> decode.

Public surface:
  init_params(cfg, generator_or_seed, device)   real tensors, drawn on device
  param_specs(cfg)                              the same on ``meta`` (no memory)
  params_from_reference(params, device)         the reference's pytree -> tensors
  forward(cfg, params, batch, caches)           logits, aux, new_caches
  forward_hidden(cfg, params, batch)            x_final, (aux, z)
  train_loss(cfg, params, batch)                scalar loss + metrics
  chunked_ce(cfg, x_final, head, labels, chunk) recomputed-logits CE
  init_serve_state(cfg, B, max_len, device, enc_len=0)  zeroed caches
  prefill / decode_step(cfg, params, state, ..) serve steps

Every family of the reference: ``dense``, ``vlm``, ``moe``, ``ssm``
(xLSTM's mLSTM and sLSTM blocks), ``hybrid`` (Hymba: attention beside SSD
heads) and ``audio`` (an encoder over the batch's ``frames``, whose
output, ``memory``, the decoder's cross-attention reads; a serve state
keeps it after prefill). A MoE layer's load-balance and z losses are
summed over the stack, as the reference sums them.

Training differentiates ``train_loss`` with autograd. Without a cache the
stack honours ``cfg.remat`` as the reference's ``jax.checkpoint`` does:
``"layer"`` recomputes each group's body in the backward, ``"dots"`` keeps
only the outputs of products without batch dimensions (``aten.mm``), and
``"none"`` keeps everything. The loss past ``cfg.loss_chunk`` tokens is
:func:`chunked_ce`, which recomputes each chunk's float32 logits in the
backward, so the (B, S, V) logits are never held.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.core.pipeline import resolve_device
from repro_torch.distributed.context import (constrain_residual,
                                             gather_weights, local_call)
from repro_torch.models import layers as L
from repro_torch.models.blocks import (APPLY, INIT, StepContext,
                                       block_pattern, n_groups)
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# =====================================================================
# meta (per-layer non-trained data, indexed alongside params)
# =====================================================================
def build_meta(cfg: ModelConfig) -> list[dict]:
    """One dict per pattern position; arrays have a leading n_groups dim
    (host numpy: a layer's window is a host int)."""
    pat = block_pattern(cfg)
    g = n_groups(cfg)
    metas: list[dict] = []
    for j, kind in enumerate(pat):
        m: dict = {}
        if cfg.family == "hybrid":
            # Hymba: first / middle / last layers keep full attention
            full = {0, cfg.n_layers // 2, cfg.n_layers - 1}
            layer_ids = np.array([gi * len(pat) + j for gi in range(g)])
            m["window"] = np.where(np.isin(layer_ids, list(full)), 0,
                                   cfg.sliding_window).astype(np.int32)
        metas.append(m)
    return metas


# =====================================================================
# params
# =====================================================================
def init_params(cfg: ModelConfig, generator_or_seed, device=None) -> dict:
    """Random parameters in the reference's layout, drawn in float32 from
    ``generator_or_seed`` (a ``torch.Generator``, or a seed for a generator
    on ``device``) a slice of each tensor at a time, cast to ``cfg.dtype``
    on ``device`` (``cuda`` unless named). The numbers differ from JAX's
    for the same seed: carry a reference's parameters with
    :func:`params_from_reference` to compare the two."""
    device = resolve_device(device)
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(
            device="cpu" if device.type == "meta" else device)
        gen.manual_seed(int(generator_or_seed))
    dt = L.dtype_of(cfg.dtype)
    g = n_groups(cfg)
    params: dict = {
        "embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dt,
                              device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "blocks": [INIT[kind](cfg, gen, g, device)
                   for kind in block_pattern(cfg)],
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                      dt, device)
    if cfg.family == "vlm":
        params["vis_proj"] = L.dense_init(gen, (cfg.frontend_dim,
                                                cfg.d_model), dt, device)
    if cfg.family == "audio":
        params["enc_proj"] = L.dense_init(gen, (cfg.frontend_dim,
                                                cfg.d_model), dt, device)
        params["enc_blocks"] = INIT["enc"](cfg, gen, cfg.enc_layers, device)
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=device)
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The parameters' shapes and dtypes on the ``meta`` device: nothing is
    drawn or allocated."""
    return init_params(cfg, 0, device="meta")


def param_count(params) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))


def params_from_reference(params, device=None) -> dict:
    """The reference's parameter pytree, its leaves as numpy arrays (bfloat16
    ones too), -> the port's tensors on ``device``, same layout and dtypes."""
    device = resolve_device(device)

    def leaf(a):
        a = np.array(a)                 # a writable copy
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return t.to(device)
        return torch.from_numpy(a).to(device)

    return pytree.tree_map(leaf, params)


def params_to_numpy(params) -> dict:
    """The port's parameters as the reference's pytree of numpy arrays
    (bfloat16 ones as ``ml_dtypes.bfloat16``, JAX's own numpy type)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return pytree.tree_map(leaf, params)


# =====================================================================
# embedding — the ADV path (paper §6.3): token code -> learned feature row
# =====================================================================
def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` by token id. An id outside [0, padded_vocab)
    raises ``IndexError`` (``jnp.take`` would fill NaN); each rank checks
    the ids it holds, and a fake tensor (a dry-run's trace) has none to
    check. A DTensor table goes through :func:`_embed_dtensor`."""
    ids = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    if ids.numel() and not is_fake(ids):
        with obs.host_read("embed_ids"):
            lo, hi = torch.aminmax(ids)
            lo, hi = torch.stack([lo, hi]).tolist()
        if lo < 0 or hi >= table.shape[0]:
            raise IndexError(f"token ids in [{lo}, {hi}] outside "
                             f"[0, {table.shape[0]})")
    if isinstance(table, DTensor):
        return _embed_dtensor(table, tokens)
    return table[tokens]


def _embed_dtensor(table, tokens):
    """A table whose rows are split over a mesh axis of more than one rank
    goes through ``F.embedding``: each rank looks up the ids in its rows
    and the ``model`` axis sums (DTensor's vocab-parallel path; indexing
    would gather the whole table). Otherwise each rank indexes its local
    table (the whole of it, gathered first where FSDP splits it) with its
    own ids, as the plain path does, and the table's gradient is a partial
    sum over the axes that split the batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    sizes = mesh.shape
    if any(isinstance(pl, Shard) and pl.dim == 0 and n > 1
           for pl, n in zip(table.placements, sizes)):
        out = F.embedding(tokens, table)
        return out.redistribute(mesh, [Replicate() if pl.is_partial() else
                                       pl for pl in out.placements])
    whole = [pl if n == 1 else Replicate()
             for pl, n in zip(table.placements, sizes)]
    if list(table.placements) != whole:
        table = table.redistribute(mesh, whole)
    split = [n > 1 and isinstance(pl, Shard)
             for pl, n in zip(tokens.placements, sizes)]
    local = table.to_local(grad_placements=[
        Partial() if s else pl for s, pl in zip(split, whole)])
    out = local[tokens.to_local()]
    return DTensor.from_local(out, mesh, [
        Shard(0) if s else Replicate() for s in split], run_check=False)


# =====================================================================
# block stack (a loop over groups)
# =====================================================================
def _unstack(tree, g: int) -> list:
    """A pytree of (g, ...) tensors -> g pytrees of views, one a group."""
    leaves, spec = pytree.tree_flatten(tree)
    per = [leaf.unbind(0) for leaf in leaves]
    return [pytree.tree_unflatten([p[gi] for p in per], spec)
            for gi in range(g)]


def _cache_keys(cache: dict, s: int) -> int:
    """T, the key length of one pattern position's cache: its K/V's
    (nested under "self" for xdec, "attn" for hymba), or ``s`` where the
    kind has none (the xLSTM kinds)."""
    kv = cache.get("self", cache.get("attn", cache))
    return kv["k"].shape[2] if "k" in kv else s


def run_stack(cfg: ModelConfig, params_blocks, metas, x, *, caches=None,
              pos: int = 0, memory=None, pattern=None):
    """-> (x, aux, z, caches). ``pattern`` is the config's decoder pattern
    unless given (the encoder passes ``["enc"]``); the group count is the
    stacked parameters' leading dimension. ``memory`` goes to each
    ``xdec`` block. The caches are updated in place: the returned ones are
    the stacked tensors passed in."""
    pat = block_pattern(cfg) if pattern is None else pattern
    g = pytree.tree_leaves(params_blocks[0])[0].shape[0]
    gp = [_unstack(p, g) for p in params_blocks]
    gc = [_unstack(c, g) for c in caches] if caches is not None else None
    s = x.shape[1]
    t = s if caches is None else _cache_keys(caches[0], s)
    ctx = StepContext(cfg, s, t, pos, None if caches is None else pos + s,
                      x.device)
    # the residual stream's placement on an active mesh (a no-op without)
    prefer = ("dp" if cfg.pure_dp else
              "channel" if cfg.family == "ssm" else "seq")
    x = constrain_residual(x, prefer)

    def group(x, gi, params, memory):
        # a mesh's storage-only splits gathered for the group's products
        # (inside the checkpoint: remat gathers again in the backward)
        params = gather_weights(params, keep_model=not cfg.pure_dp)
        losses = []
        for j, kind in enumerate(pat):
            meta = {k: v[gi] for k, v in metas[j].items()}
            kw = {"memory": memory} if kind == "xdec" else {}
            x, _, az = APPLY[kind](
                cfg, params[j], meta, x,
                cache=None if gc is None else gc[j][gi], pos=pos, ctx=ctx,
                **kw)
            losses.append(az)
        return constrain_residual(x, prefer), losses

    remat = cfg.remat if caches is None and torch.is_grad_enabled() and \
        any(isinstance(t, torch.Tensor) and t.requires_grad
            for t in pytree.tree_leaves((x, params_blocks, memory))) \
        else "none"
    aux = z = 0.0
    for gi in range(g):
        args = (x, gi, [p[gi] for p in gp], memory)
        if remat == "layer":
            x, losses = checkpoint(group, *args, use_reentrant=False)
        elif remat == "dots":
            x, losses = checkpoint(group, *args, use_reentrant=False,
                                   context_fn=_DOTS_CONTEXT)
        else:
            x, losses = group(*args)
        for a, zz in losses:          # summed layer by layer, as before
            aux = aux + a
            z = z + zz
    return x, aux, z, caches


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of products without batch dimensions (``x @ W`` reaches
    ``aten.mm``), recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


# =====================================================================
# forward
# =====================================================================
def _hidden(cfg: ModelConfig, params, batch, caches):
    """Shared trunk: embeddings + frontends (the vision projection, the
    audio encoder) + block stack + final norm. Returns (x_final, (aux, z),
    new_caches)."""
    tokens = batch["tokens"]
    pos = caches["pos"] if caches is not None else 0
    x = embed_tokens(cfg, _weight(cfg, params["embed"]), tokens)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pp = batch["patch_embeds"].to(x.dtype) @ _weight(cfg,
                                                         params["vis_proj"])
        x = torch.cat([pp, x[:, pp.shape[1]:, :]], dim=1)
    memory = None
    if cfg.family == "audio":
        if caches is not None and "memory" in caches and \
                "frames" not in batch:
            memory = caches["memory"]
        else:                 # encode: RoPE from 0 over the frames, no cache
            fr = batch["frames"].to(x.dtype) @ _weight(cfg,
                                                       params["enc_proj"])
            memory, _, _, _ = run_stack(cfg, [params["enc_blocks"]], [{}],
                                        fr, pattern=["enc"])
            memory = L.rms_norm(memory, params["enc_norm"], cfg.norm_eps)

    block_caches = caches["blocks"] if caches is not None else None
    x, aux, z, new_block_caches = run_stack(
        cfg, params["blocks"], build_meta(cfg), x, caches=block_caches,
        pos=pos, memory=memory)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)

    new_caches = None
    if caches is not None:
        new_caches = dict(caches)
        new_caches["blocks"] = new_block_caches
        new_caches["pos"] = pos + tokens.shape[1]
        if memory is not None:
            new_caches["memory"] = memory
    return x, (aux, z), new_caches


def forward_hidden(cfg: ModelConfig, params, batch):
    """The trunk without a cache: (x_final (B,S,D), (aux, z))."""
    x, auxz, _ = _hidden(cfg, params, batch, None)
    return x, auxz


def forward(cfg: ModelConfig, params, batch, caches=None):
    """batch: dict with 'tokens' (B,S) int; vlm: + 'patch_embeds'
    (B,P,frontend_dim); audio: + 'frames' (B,S_enc,frontend_dim), which a
    serve state's ``memory`` stands in for once it holds the encoder's
    output. caches: serve-state dict or None.
    Returns (logits (B,S,padded_vocab) float32, (aux, z), new_caches)."""
    x, (aux, z), new_caches = _hidden(cfg, params, batch, caches)
    with obs.span("lm.head"):
        logits = _mask_pad_vocab(cfg, (x @ _head(cfg, params)).float())
    return logits, (aux, z), new_caches


def _weight(cfg: ModelConfig, w):
    """A parameter as the products use it (``gather_weights``)."""
    return gather_weights(w, keep_model=not cfg.pure_dp)


def _head(cfg: ModelConfig, params) -> torch.Tensor:
    """The vocab head: ``head``, or the tied embedding transposed."""
    head = params.get("head")
    return _weight(cfg, params["embed"]).T if head is None else \
        _weight(cfg, head)


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab > cfg.vocab:
        vmask = torch.arange(cfg.padded_vocab, device=logits.device) < \
            cfg.vocab
        logits = torch.where(vmask, logits, NEG_INF)
    return logits


# =====================================================================
# training loss
# =====================================================================
def _ce_terms(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor):
    """(sum of CE over valid labels, count of valid labels); labels < 0
    are masked. On DTensors each rank sums its own rows, whole along the
    vocab."""
    return local_call(_ce_sums, (logits, labels), ((0, None), (0, None)),
                      ["sum", "sum"])


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(valid, logz - gold, 0.0)
    return ce.sum(), valid.sum()


def _chunk_ce(cfg: ModelConfig, xs, head, ls):
    logits = _mask_pad_vocab(cfg, (xs @ head).float())
    return _ce_terms(cfg, logits, ls)


def chunked_ce(cfg: ModelConfig, x_final: torch.Tensor, head: torch.Tensor,
               labels: torch.Tensor, chunk: int):
    """Sequence-chunked, checkpointed CE: the (B, chunk, V) float32 logits
    block is the only logits liveness, and the backward recomputes each
    block's logits (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``). Chunks are summed in ascending order from zero.
    Returns (loss_sum, count)."""
    s = x_final.shape[1]
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_final.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x_final.device)
    for c0 in range(0, s - s % chunk, chunk):
        args = (cfg, x_final[:, c0:c0 + chunk], head,
                labels[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            c_sum, c_cnt = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            c_sum, c_cnt = _chunk_ce(*args)
        loss_sum = loss_sum + c_sum
        cnt = cnt + c_cnt
    return loss_sum, cnt


def train_loss(cfg: ModelConfig, params, batch):
    """Cross-entropy over valid labels (labels < 0 are masked), plus a MoE
    stack's ``router_aux_coef * aux + router_z_coef * z``. Returns (loss,
    {"ce", "aux", "z", "tokens"}), each a 0-d tensor."""
    x_final, (aux, z) = forward_hidden(cfg, params, batch)
    head = _head(cfg, params)
    labels = batch["labels"]
    s = labels.shape[1]
    if cfg.loss_chunk and s % cfg.loss_chunk == 0 and s > cfg.loss_chunk:
        loss_sum, n_valid = chunked_ce(cfg, x_final, head, labels,
                                       cfg.loss_chunk)
    else:
        logits = _mask_pad_vocab(cfg, (x_final @ head).float())
        loss_sum, n_valid = _ce_terms(cfg, logits, labels)
    n_valid = torch.clamp(n_valid, min=1)
    loss = loss_sum / n_valid
    dev = loss.device
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    total = loss + cfg.router_aux_coef * aux + cfg.router_z_coef * z
    return total, {"ce": loss, "aux": aux, "z": z, "tokens": n_valid}


# =====================================================================
# serving
# =====================================================================
def _zero_attn_cache(cfg: ModelConfig, g: int, b: int, max_len: int, dt,
                     device) -> dict:
    """KV cache; 'int8' stores dictionary-quantized codes + per-(token,head)
    float32 scales — the paper's encode-small-integers idea applied to the
    serving cache (halves decode memory; see blocks._attn_apply)."""
    shape = (g, b, max_len, cfg.n_kv, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_serve_state(cfg: ModelConfig, batch_size: int, max_len: int,
                     device=None, *, enc_len: int = 0) -> dict:
    """Zeroed caches on ``device`` (``cuda`` unless named), one per
    position of the pattern, in the reference's shapes and dtypes:
    attention K/V for ``dense`` and ``moe``; the float32 GLA state and
    normalizer and the conv history (model dtype) for ``mlstm``; float32 h
    and c for ``slstm``; K/V under ``"attn"``, the conv history and the
    float32 SSD state for ``hymba``; self-attention K/V under ``"self"``
    for ``xdec``. The audio family also holds ``memory``, (B, enc_len, D)
    zeros in the model's dtype (a prefill with frames replaces it).
    ``pos`` is a host int."""
    device = resolve_device(device)
    dt = L.dtype_of(cfg.dtype)
    g = n_groups(cfg)
    b, di, h = batch_size, cfg.d_inner, cfg.n_heads

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches = []
    for kind in block_pattern(cfg):
        if kind == "mlstm":
            dk = int(di * cfg.qk_dim_ratio) // h
            caches.append({"state": zeros(g, b, h, dk, di // h),
                           "nstate": zeros(g, b, h, dk),
                           "conv": zeros(g, b, cfg.conv_width - 1, di,
                                         dtype=dt)})
        elif kind == "slstm":
            dh = cfg.d_model // h
            caches.append({"h": zeros(g, b, h, dh), "c": zeros(g, b, h, dh)})
        elif kind == "hymba":
            caches.append({
                "attn": _zero_attn_cache(cfg, g, b, max_len, dt, device),
                "conv": zeros(g, b, cfg.conv_width - 1, di, dtype=dt),
                "state": zeros(g, b, h, cfg.ssm_state, di // h)})
        else:
            kv = _zero_attn_cache(cfg, g, b, max_len, dt, device)
            caches.append({"self": kv} if kind == "xdec" else kv)
    state = {"blocks": caches, "pos": 0}
    if cfg.family == "audio":
        state["memory"] = torch.zeros((batch_size, enc_len, cfg.d_model),
                                      dtype=dt, device=device)
    return state


def prefill(cfg: ModelConfig, params, state, batch):
    logits, _, state = forward(cfg, params, batch, caches=state)
    return logits, state


def decode_step(cfg: ModelConfig, params, state, tokens):
    """tokens (B, 1) -> (logits (B,1,V), new state)."""
    logits, _, state = forward(cfg, params, {"tokens": tokens}, caches=state)
    return logits, state
