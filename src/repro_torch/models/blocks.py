"""Block definitions + initializers for all seven kinds: ``dense``
(families ``dense`` and ``vlm``), ``moe`` (family ``moe``), ``mlstm`` and
``slstm`` (family ``ssm``: xLSTM's matrix-memory and scalar-memory blocks),
``hymba`` (family ``hybrid``: attention beside SSD heads), and the audio
family's ``enc`` (a bidirectional dense block) and ``xdec`` (a decoder
block with cross-attention over the encoder's output, ``memory``).

Layers are organized as a repeating *pattern* of block kinds (e.g. llama4:
``['dense', 'moe']`` x 24 groups; xLSTM: ``['mlstm']*7 + ['slstm']`` x 6).
Params for each pattern position are stacked over groups (a leading group
dimension, the reference's pytree layout), and the stack runs a Python loop
over groups on views of them. Per-layer non-trained metadata (Hymba's
per-layer attention window) rides in a parallel ``meta`` list.

Each kind implements:
  init_<kind>(cfg, generator, n, device) -> stacked params dict
  apply_<kind>(cfg, p, meta, x, *, cache, pos, ctx) -> (x, cache, aux)

``ctx`` is the forward's :class:`StepContext`: what every layer shares.
``xdec`` also takes ``memory``. A cache is one group's views of the
stacked serve state, updated in place: attention K/V, and the recurrent
kinds' states (the GLA state, normalizer and conv history of ``mlstm``,
sLSTM's h and c, Hymba's K/V, conv history and SSD state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.context import (local_call, residual_add,
                                             seq_whole)
from repro_torch.distributed.sharding import local_range
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.attention import (attention, attention_mask,
                                          is_direct)
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.gla import chunked_gla, gla_step


# local_call's (batch dim, head dim) of an activation (B,S,H,...) and of a
# recurrent state (B,H,...)
SEQ_HEADS, STATE_HEADS = (0, 2), (0, 1)


def _split_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``, the last dim split into (heads, head dim). A
    DTensor whose last dim is split over mesh axes that do not divide the
    heads is gathered along it first."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate() if isinstance(p, Shard) and p.dim == t.ndim - 1
              and shape[-2] % n else p
              for p, n in zip(t.placements, t.device_mesh.shape)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*shape)


def _merge_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``, the (heads, head dim) dims merged into one. On
    a DTensor the gradient coming back is put on the merged tensor's own
    placements first, so the backward's split into heads never meets a
    split of the merged dim that the heads do not divide (a product's
    backward may choose one)."""
    out = t.reshape(*shape)
    return _KeepPlacements.apply(out) if isinstance(out, DTensor) else out


class _KeepPlacements(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient to the
    forward tensor's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def _pick_chunk(s: int, target: int = 256) -> int:
    """The reference's GLA chunk for a sequence of ``s``: s itself up to
    ``target``, else ``target`` where it divides s, else gcd(s, target)
    (1,040 gives 16)."""
    if s <= target:
        return s
    if s % target == 0:
        return target
    return math.gcd(s, target)


# =====================================================================
# pattern
# =====================================================================
def block_pattern(cfg: ModelConfig) -> list[str]:
    if cfg.family == "moe":
        if cfg.moe_every <= 1:
            return ["moe"]
        return ["dense"] * (cfg.moe_every - 1) + ["moe"]
    if cfg.family in ("dense", "vlm"):
        return ["dense"]
    if cfg.family == "ssm":
        if cfg.slstm_group > 1:
            return ["mlstm"] * (cfg.slstm_group - 1) + ["slstm"]
        return ["mlstm"]
    if cfg.family == "hybrid":
        return ["hymba"]
    if cfg.family == "audio":
        return ["xdec"]            # decoder stack; encoder handled separately
    raise ValueError(cfg.family)


def n_groups(cfg: ModelConfig) -> int:
    pat = block_pattern(cfg)
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} not divisible "
                         f"by pattern {pat}")
    return cfg.n_layers // len(pat)


# =====================================================================
# per-forward context
# =====================================================================
class StepContext:
    """What every layer of one forward shares, built once a forward rather
    than once a layer: RoPE's tables at the step's S positions from
    ``pos``, and the direct attention path's (S, T) mask for each window
    (T keys: the cache's length, or S without a cache)."""

    def __init__(self, cfg: ModelConfig, s: int, t: int, pos: int,
                 kv_len: int | None, device):
        self.s, self.t, self.pos, self.kv_len = s, t, pos, kv_len
        self.device = device
        positions = (pos + torch.arange(s, device=device))[None, :]
        self.cos, self.sin = L.rope_cos_sin(positions, cfg.head_dim,
                                            cfg.rope_theta)
        self._masks: dict[int, torch.Tensor] = {}

    def mask(self, window) -> torch.Tensor | None:
        """None on the flash path, which masks chunk by chunk."""
        if not is_direct(self.s, self.t):
            return None
        w = int(window)
        if w not in self._masks:
            self._masks[w] = attention_mask(
                self.s, self.t, q_offset=self.pos, window=w,
                kv_len=self.kv_len, device=self.device)
        return self._masks[w]


# =====================================================================
# attention sub-module
# =====================================================================
def _attn_init(cfg: ModelConfig, generator, n: int, dt, device):
    hd = cfg.head_dim
    kv = cfg.n_kv
    p = {
        "wq": L.dense_init(generator, (n, cfg.d_model, cfg.n_heads * hd), dt,
                           device),
        "wk": L.dense_init(generator, (n, cfg.d_model, kv * hd), dt, device),
        "wv": L.dense_init(generator, (n, cfg.d_model, kv * hd), dt, device),
        "wo": L.dense_init(generator, (n, cfg.n_heads * hd, cfg.d_model), dt,
                           device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, cfg.n_heads * hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((n, kv * hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((n, kv * hd), dtype=dt, device=device)
    return p


def _write_cache(buf: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """buf[:, pos:pos+S] = new, in place. A write past the cache's end
    raises (the reference's ``dynamic_update_slice`` would clamp it)."""
    end = pos + new.shape[1]
    if end > buf.shape[1]:
        raise ValueError(f"KV cache overflow: positions [{pos}, {end}) past "
                         f"max_len {buf.shape[1]}")
    if isinstance(buf, DTensor):
        _write_cache_local(buf, new, pos, end)
        return
    buf[:, pos:end] = new.to(buf.dtype)


def _write_cache_local(buf, new, pos: int, end: int) -> None:
    """The DTensor cache's write: each rank writes the part of [pos, end)
    its shard of T holds, from ``new`` laid out as ``buf`` is but whole
    along T."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    whole_t = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
               for pl in buf.placements]
    if list(new.placements) != whole_t:
        new = new.redistribute(mesh, whole_t)
    first, size = local_range(buf.shape[1], buf.placements, mesh, 1)
    lo, hi = max(pos, first), min(end, first + size)
    if lo < hi:
        buf.to_local()[:, lo - first:hi - first] = \
            new.to_local()[:, lo - pos:hi - pos].to(buf.dtype)


def _attn_apply(cfg: ModelConfig, p, x, *, cache, pos: int, window,
                ctx: StepContext, causal: bool = True, rope: bool = True,
                kv_src: torch.Tensor | None = None):
    """x (B,S,D). cache: None or one group's dict(k, v) of (B,T,KV,hd)
    views (plus ks, vs for the int8 cache), updated in place. ``kv_src``
    (cross-attention's memory, (B,T,D)): K and V come from it on every
    call, unrotated, and no cache is written. ``rope=False`` leaves Q and
    K unrotated; ``causal=False`` attends to every key through
    :func:`_bidir_attention` (``ctx``'s causal mask is not read)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, b, s, cfg.n_heads, hd)
    src = x if kv_src is None else seq_whole(kv_src)
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    kvh = k.shape[-1] // hd
    # T spelled out: an empty memory (T = 0) has no -1 to infer
    k = _split_heads(k, b, src.shape[1], kvh, hd)
    v = _split_heads(v, b, src.shape[1], kvh, hd)
    if rope:
        q = L.rotate(q, ctx.cos, ctx.sin)
        if kv_src is None:
            k = L.rotate(k, ctx.cos, ctx.sin)

    kv_len = None
    if cache is not None and kv_src is None:
        if "ks" in cache:        # int8 dictionary-quantized cache
            kq, ks_new = _kv_quantize(k)
            vq, vs_new = _kv_quantize(v)
            for name, new in (("k", kq), ("v", vq), ("ks", ks_new),
                              ("vs", vs_new)):
                _write_cache(cache[name], new, pos)
            k = _kv_dequantize(cache["k"], cache["ks"], x.dtype)
            v = _kv_dequantize(cache["v"], cache["vs"], x.dtype)
        else:
            _write_cache(cache["k"], k, pos)
            _write_cache(cache["v"], v, pos)
            k, v = cache["k"], cache["v"]
        kv_len = pos + s
    kv_dims, kv_pick = _kv_split(q, k)
    if causal:
        out = local_call(
            lambda q, k, v, mask: attention(q, *kv_pick(q, k, v), q_offset=pos,
                                            window=window, kv_len=kv_len,
                                            mask=mask),
            (q, k, v, ctx.mask(window)), (SEQ_HEADS, kv_dims, kv_dims, None),
            SEQ_HEADS)
    else:
        out = local_call(lambda q, k, v: _bidir_attention(q,
                                                          *kv_pick(q, k, v)),
                         (q, k, v), (SEQ_HEADS, kv_dims, kv_dims), SEQ_HEADS)
    return _merge_heads(out, b, s, cfg.n_heads * hd) @ p["wo"], cache


def _whole_kv(q, k, v):
    return k, v


def _kv_split(q, k):
    """How the attention core splits K/V over ``model``: with their heads
    where the axis divides them, else whole, each rank then taking the KV
    heads of its own query heads where ``model`` splits them (GQA with
    fewer KV heads than ranks; ``model`` may split the batch instead).
    -> (local_call dims of K and V, local (q, k, v) -> the rank's K/V)."""
    if not isinstance(q, DTensor) or "model" not in \
            q.device_mesh.mesh_dim_names:
        return SEQ_HEADS, _whole_kv
    m = q.device_mesh.size(q.device_mesh.mesh_dim_names.index("model"))
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    per = h // m
    if m == 1 or kvh % m == 0 or h % m or (g % per and per % g):
        return SEQ_HEADS, _whole_kv
    first = q.device_mesh.get_local_rank("model") * per // g
    n = max(1, per // g)

    def pick(q, k, v):
        if q.shape[2] == h:               # the heads are whole here
            return k, v
        return k[:, :, first:first + n], v[:, :, first:first + n]

    return (0, None, "sum"), pick


def _bidir_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_chunk: int = 1024) -> torch.Tensor:
    """Non-causal GQA attention, the reference's rule for its two routes
    (not :func:`attention.is_direct`'s). T past ``kv_chunk`` and a multiple
    of it goes through flash with every query position pinned to T, so the
    causal predicate keeps every key (decode over 2,048 frames too);
    otherwise the direct route, float32 scores with no mask at all (T =
    1,500 too). T = 0 gives zeros. q (B,S,H,dh), k, v (B,T,KV,dh)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh) * (dh ** -0.5)
    if t > kv_chunk and t % kv_chunk == 0:
        q_pos = torch.full((s,), float(t), dtype=torch.float32,
                           device=q.device)
        kbias = torch.zeros((t,), dtype=torch.float32, device=q.device)
        out = flash_attention(qg, k, v, q_pos, kbias, 0.0, kv_chunk)
        return out.reshape(b, s, h, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def _kv_quantize(x: torch.Tensor):
    """(B,S,KV,hd) -> int8 codes + per-(token,head) float32 scale.
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The 127 is
    a tensor on ``x``'s device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, a bit off the division the CPU and the
    reference make."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / xf.new_full((), 127.0)
    q = torch.round(xf / torch.clamp(scale[..., None], min=1e-12))
    return q.to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    return (q.float() * torch.clamp(scale, min=1e-12)[..., None]).to(dt)


def _mlp_init(cfg: ModelConfig, generator, n: int, dt, device):
    p = {"wu": L.dense_init(generator, (n, cfg.d_model, cfg.d_ff), dt,
                            device),
         "wd": L.dense_init(generator, (n, cfg.d_ff, cfg.d_model), dt,
                            device)}
    if cfg.mlp_style == "swiglu":
        p["wg"] = L.dense_init(generator, (n, cfg.d_model, cfg.d_ff), dt,
                               device)
    return p


def _mlp_apply(p, x):
    if "wg" in p:
        return L.swiglu(x, p["wg"], p["wu"], p["wd"])
    # jax.nn.gelu's default is the tanh approximation; torch's is exact
    return F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]


# =====================================================================
# dense transformer block
# =====================================================================
def init_dense(cfg: ModelConfig, generator, n: int, device):
    dt = L.dtype_of(cfg.dtype)
    return {"ln1": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "ln2": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "attn": _attn_init(cfg, generator, n, dt, device),
            "mlp": _mlp_init(cfg, generator, n, dt, device)}


def apply_dense(cfg: ModelConfig, p, meta, x, *, cache, pos: int,
                ctx: StepContext, causal: bool = True):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    window = meta.get("window", cfg.sliding_window or 0)
    attn_out, cache = _attn_apply(cfg, p["attn"], h, cache=cache, pos=pos,
                                  window=window, ctx=ctx, causal=causal)
    x = residual_add(x, attn_out)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = residual_add(x, _mlp_apply(p["mlp"], h))
    return x, cache, (0.0, 0.0)


# =====================================================================
# MoE block
# =====================================================================
def init_moe(cfg: ModelConfig, generator, n: int, device):
    """The router is float32 whatever ``cfg.dtype`` is, as the
    reference's."""
    dt = L.dtype_of(cfg.dtype)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"ln1": torch.ones((n, d), dtype=dt, device=device),
         "ln2": torch.ones((n, d), dtype=dt, device=device),
         "attn": _attn_init(cfg, generator, n, dt, device),
         "router": L.dense_init(generator, (n, d, e), torch.float32, device),
         "we_gate": L.dense_init(generator, (n, e, d, f), dt, device),
         "we_up": L.dense_init(generator, (n, e, d, f), dt, device),
         "we_down": L.dense_init(generator, (n, e, f, d), dt, device)}
    if cfg.shared_expert:
        p["shared"] = _mlp_init(cfg, generator, n, dt, device)
    return p


def apply_moe(cfg: ModelConfig, p, meta, x, *, cache, pos: int,
              ctx: StepContext):
    """The attention window is the config's (``meta`` is not read), as the
    reference's; the shared expert is added to the routed experts' output
    before the residual."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, cache = _attn_apply(cfg, p["attn"], h, cache=cache, pos=pos,
                                  window=cfg.sliding_window or 0, ctx=ctx)
    x = residual_add(x, attn_out)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    moe_out, aux, z = moe.moe_ff(h, p["router"], p["we_gate"], p["we_up"],
                                 p["we_down"], top_k=cfg.top_k,
                                 cap_factor=cfg.capacity_factor)
    if "shared" in p:
        moe_out = moe_out + _mlp_apply(p["shared"], h)
    x = residual_add(x, moe_out)
    return x, cache, (aux, z)


# =====================================================================
# recurrent state shared by mLSTM and Hymba
# =====================================================================
def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x (B,S,C), w (W,C); ``state``: the (B,W-1,C)
    history (zeros without). Returns (silu(y), new history). The taps are
    summed as the reference sums them (Python ``sum`` from 0, in
    ascending tap order, in x's dtype), and the SiLU is XLA's expansion
    (``moe._silu``)."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return moe._silu(y), new_state


def _save(cache: dict, **new) -> None:
    """Write a step's recurrent state into one group's cache views."""
    for name, t in new.items():
        cache[name].copy_(t)


# =====================================================================
# mLSTM block (xLSTM): chunked GLA core with a separate normalizer
# =====================================================================
def init_mlstm(cfg: ModelConfig, generator, n: int, device):
    """The gate projection ``wif`` is float32 whatever ``cfg.dtype`` is, as
    the reference's."""
    dt = L.dtype_of(cfg.dtype)
    di = cfg.d_inner
    dk = int(di * cfg.qk_dim_ratio)
    return {"ln": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "w_up": L.dense_init(generator, (n, cfg.d_model, 2 * di), dt,
                                 device),
            "conv_w": L.dense_init(generator, (n, cfg.conv_width, di), dt,
                                   device, scale=0.5),
            "wq": L.dense_init(generator, (n, di, dk), dt, device),
            "wk": L.dense_init(generator, (n, di, dk), dt, device),
            "wif": L.dense_init(generator, (n, di, 2 * cfg.n_heads),
                                torch.float32, device),
            "w_down": L.dense_init(generator, (n, di, cfg.d_model), dt,
                                   device),
            "ln_heads": torch.ones((n, di), dtype=dt, device=device)}


def apply_mlstm(cfg: ModelConfig, p, meta, x, *, cache, pos: int,
                ctx: StepContext):
    """Without a cache, the chunked GLA over the sequence; with one, a
    one-token call is a :func:`gla_step` on the cached state, and a longer
    one a prefill that restarts the GLA state and normalizer from zero (as
    the reference's does) while the conv history carries over."""
    b, s, _ = x.shape
    h_heads = cfg.n_heads
    di = cfg.d_inner
    dkh = p["wq"].shape[-1] // h_heads
    dvh = di // h_heads
    hin = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xi, z = torch.chunk(hin @ p["w_up"], 2, dim=-1)       # (B,S,di) each
    xc, new_conv = _causal_conv(xi, p["conv_w"],
                                None if cache is None else cache["conv"])
    q = _split_heads(xc @ p["wq"], b, s, h_heads, dkh)
    k = _split_heads(xc @ p["wk"], b, s, h_heads, dkh) / (dkh ** 0.5)
    v = _split_heads(xi, b, s, h_heads, dvh)
    gates = xi.float() @ p["wif"]                          # (B,S,2H) f32
    step = cache is not None and s == 1

    def core(q, k, v, gi, gf, state, nstate):
        i_gate = torch.sigmoid(gi)
        log_f = F.logsigmoid(gf)
        k = k * i_gate[..., None].to(k.dtype)
        if step:
            st, out1, n_st, n_out = gla_step(
                state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], nstate=nstate)
            return out1[:, None], st, n_out[:, None], n_st
        return chunked_gla(q, k, v, log_f, chunk=_pick_chunk(s),
                           normalizer=True)

    out, st, n_out, n_st = local_call(
        core, (q, k, v, gates[..., :h_heads], gates[..., h_heads:],
               cache["state"] if step else None,
               cache["nstate"] if step else None),
        (SEQ_HEADS,) * 5 + (STATE_HEADS,) * 2,
        [SEQ_HEADS, STATE_HEADS, SEQ_HEADS, STATE_HEADS])
    hsv = out / torch.clamp(n_out.abs(), min=1.0)[..., None].to(out.dtype)
    hsv = L.rms_norm(_merge_heads(hsv, b, s, di), p["ln_heads"],
                     cfg.norm_eps) * \
        moe._silu(z)
    x = residual_add(x, hsv @ p["w_down"])
    if cache is not None:
        _save(cache, state=st, nstate=n_st, conv=new_conv)
    return x, cache, (0.0, 0.0)


# =====================================================================
# sLSTM block (xLSTM): a sequential scan, block-diagonal recurrence
# =====================================================================
def init_slstm(cfg: ModelConfig, generator, n: int, device):
    """``w``, ``r`` and ``b`` are float32 whatever ``cfg.dtype`` is; ``r``
    is block-diagonal, one (dh, 4 dh) block a head."""
    dt = L.dtype_of(cfg.dtype)
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {"ln": torch.ones((n, d), dtype=dt, device=device),
            "w": L.dense_init(generator, (n, d, 4 * d), torch.float32,
                              device),
            "r": L.dense_init(generator, (n, h, dh, 4 * dh), torch.float32,
                              device),
            "b": torch.zeros((n, 4 * d), dtype=torch.float32, device=device),
            "w_down": L.dense_init(generator, (n, d, d), dt, device)}


def apply_slstm(cfg: ModelConfig, p, meta, x, *, cache, pos: int,
                ctx: StepContext):
    """One Python step a token, in float32 (the reference's ``lax.scan``),
    from zeros without a cache and from the cached (h, c) with one. The
    gates split per head: ``pre`` is (B,S,H,4 dh) before the i/f/z/o
    split."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    hin = L.rms_norm(x, p["ln"], cfg.norm_eps)
    pre = _split_heads(hin.float() @ p["w"] + p["b"], b, s, h, 4 * dh)

    def scan(pre, r, h_t, c_t):
        if h_t is None:
            h_t = pre.new_zeros(pre.shape[:1] + pre.shape[2:3] + (dh,))
            c_t = torch.zeros_like(h_t)
        outs = []
        for t in range(s):
            gates = pre[:, t] + torch.einsum("bhd,hdk->bhk", h_t, r)
            i, f, zg, o = torch.chunk(gates, 4, dim=-1)
            c_t = torch.sigmoid(f) * c_t + torch.sigmoid(i) * torch.tanh(zg)
            h_t = torch.sigmoid(o) * torch.tanh(c_t)
            outs.append(h_t)
        return torch.stack(outs, dim=1), h_t, c_t

    out, h_t, c_t = local_call(
        scan, (pre, p["r"], None if cache is None else cache["h"],
               None if cache is None else cache["c"]),
        (SEQ_HEADS, (None, 0), STATE_HEADS, STATE_HEADS),
        [SEQ_HEADS, STATE_HEADS, STATE_HEADS])
    out = _merge_heads(out, b, s, d)
    if cache is not None:
        _save(cache, h=h_t, c=c_t)
    x = residual_add(x, out.to(x.dtype) @ p["w_down"])
    return x, cache, (0.0, 0.0)


# =====================================================================
# Hymba block: attention beside SSD (Mamba-2 style) heads
# =====================================================================
def init_hymba(cfg: ModelConfig, generator, n: int, device):
    """``w_dt`` and ``a_log`` are float32 whatever ``cfg.dtype`` is."""
    dt = L.dtype_of(cfg.dtype)
    d, di, ds, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_heads
    return {"ln1": torch.ones((n, d), dtype=dt, device=device),
            "ln2": torch.ones((n, d), dtype=dt, device=device),
            "attn": _attn_init(cfg, generator, n, dt, device),
            "w_in": L.dense_init(generator, (n, d, 2 * di), dt, device),
            "conv_w": L.dense_init(generator, (n, cfg.conv_width, di), dt,
                                   device, scale=0.5),
            "w_bc": L.dense_init(generator, (n, di, 2 * h * ds), dt, device),
            "w_dt": L.dense_init(generator, (n, di, h), torch.float32,
                                 device),
            "a_log": torch.zeros((n, h), dtype=torch.float32, device=device),
            "norm_attn": torch.ones((n, d), dtype=dt, device=device),
            "norm_ssm": torch.ones((n, d), dtype=dt, device=device),
            "w_o_ssm": L.dense_init(generator, (n, di, d), dt, device),
            "mlp": _mlp_init(cfg, generator, n, dt, device)}


def apply_hymba(cfg: ModelConfig, p, meta, x, *, cache, pos: int,
                ctx: StepContext):
    """Attention with the layer's window (``meta``) beside the SSD path (a
    GLA with q = C and k = B, decayed by softplus(dt) exp(a_log)), each
    path RMS-normed and the two averaged, then the MLP. The cache modes are
    :func:`apply_mlstm`'s, with the K/V cache beside the SSD state."""
    b, s, d = x.shape
    h = cfg.n_heads
    di, ds = cfg.d_inner, cfg.ssm_state
    hin = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    window = meta.get("window", cfg.sliding_window or 0)
    # ---- attention path ----
    attn_out, _ = _attn_apply(cfg, p["attn"], hin,
                              cache=None if cache is None else cache["attn"],
                              pos=pos, window=window, ctx=ctx)
    # ---- SSD path ----
    xs, z = torch.chunk(hin @ p["w_in"], 2, dim=-1)       # (B,S,di)
    xc, new_conv = _causal_conv(xs, p["conv_w"],
                                None if cache is None else cache["conv"])
    bmat, cmat = torch.chunk(_split_heads(xc @ p["w_bc"], b, s, h, 2 * ds),
                             2, dim=-1)
    dt_pos = F.softplus(xc.float() @ p["w_dt"])            # (B,S,H) f32
    log_a = -dt_pos * torch.exp(p["a_log"])[None, None, :]
    v = _split_heads(xs, b, s, h, di // h) * dt_pos[..., None].to(xs.dtype)
    step = cache is not None and s == 1

    def core(cmat, bmat, v, log_a, state):
        if step:
            st, out1 = gla_step(state, cmat[:, 0], bmat[:, 0], v[:, 0],
                                log_a[:, 0])
            return out1[:, None], st
        return chunked_gla(cmat, bmat, v, log_a, chunk=_pick_chunk(s))

    ssm_out, st = local_call(
        core, (cmat, bmat, v, log_a, cache["state"] if step else None),
        (SEQ_HEADS,) * 4 + (STATE_HEADS,), [SEQ_HEADS, STATE_HEADS])
    ssm_out = (_merge_heads(ssm_out, b, s, di) * moe._silu(z)) @ \
        p["w_o_ssm"]
    # ---- fuse (the mean of the per-path norms, Hymba section 3) ----
    fused = 0.5 * (L.rms_norm(attn_out, p["norm_attn"], cfg.norm_eps) +
                   L.rms_norm(ssm_out, p["norm_ssm"], cfg.norm_eps))
    x = residual_add(x, fused)
    h_mid = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = residual_add(x, _mlp_apply(p["mlp"], h_mid))
    if cache is not None:
        _save(cache, conv=new_conv, state=st)
    return x, cache, (0.0, 0.0)


# =====================================================================
# encoder block + enc-dec decoder block (audio)
# =====================================================================
def init_enc(cfg: ModelConfig, generator, n: int, device):
    return init_dense(cfg, generator, n, device)


def apply_enc(cfg: ModelConfig, p, meta, x, *, cache=None, pos: int = 0,
              ctx: StepContext):
    """Bidirectional, with no cache; ``ctx`` is the encoder's own (RoPE
    from position 0 over the frames)."""
    return apply_dense(cfg, p, meta, x, cache=None, pos=pos, ctx=ctx,
                       causal=False)


def init_xdec(cfg: ModelConfig, generator, n: int, device):
    dt = L.dtype_of(cfg.dtype)
    return {"ln1": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "ln_x": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "ln2": torch.ones((n, cfg.d_model), dtype=dt, device=device),
            "attn": _attn_init(cfg, generator, n, dt, device),
            "xattn": _attn_init(cfg, generator, n, dt, device),
            "mlp": _mlp_init(cfg, generator, n, dt, device)}


def apply_xdec(cfg: ModelConfig, p, meta, x, *, cache, pos: int,
               ctx: StepContext, memory=None):
    """Causal self-attention (its cache is ``{"self": K/V}``), then
    cross-attention over ``memory`` (B,T,D), unrotated and bidirectional:
    its K and V are recomputed from the memory at every call, as the
    reference does, then the MLP."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, _ = _attn_apply(cfg, p["attn"], h,
                              cache=None if cache is None else cache["self"],
                              pos=pos, window=0, ctx=ctx)
    x = residual_add(x, attn_out)
    h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    xattn_out, _ = _attn_apply(cfg, p["xattn"], h, cache=None, pos=pos,
                               window=0, ctx=ctx, causal=False, rope=False,
                               kv_src=memory)
    x = residual_add(x, xattn_out)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = residual_add(x, _mlp_apply(p["mlp"], h))
    return x, cache, (0.0, 0.0)


INIT = {"dense": init_dense, "moe": init_moe, "mlstm": init_mlstm,
        "slstm": init_slstm, "hymba": init_hymba, "enc": init_enc,
        "xdec": init_xdec}
APPLY = {"dense": apply_dense, "moe": apply_moe, "mlstm": apply_mlstm,
         "slstm": apply_slstm, "hymba": apply_hymba, "enc": apply_enc,
         "xdec": apply_xdec}
