"""Block definitions + initializers: the ``dense`` kind (families ``dense``
and ``vlm``), the ``moe`` kind (family ``moe``), and the audio family's
``enc`` (a bidirectional dense block) and ``xdec`` (a decoder block with
cross-attention over the encoder's output, ``memory``).

Layers are organized as a repeating *pattern* of block kinds (e.g. llama4:
``['dense', 'moe']`` x 24 groups; xLSTM: ``['mlstm']*7 + ['slstm']`` x 6).
Params for each pattern position are stacked over groups (a leading group
dimension, the reference's pytree layout), and the stack runs a Python loop
over groups on views of them. Per-layer non-trained metadata rides in a
parallel ``meta`` list.

Each kind implements:
  init_<kind>(cfg, generator, n, device) -> stacked params dict
  apply_<kind>(cfg, p, meta, x, *, cache, pos, ctx) -> (x, cache, aux)

``ctx`` is the forward's :class:`StepContext`: what every layer shares.
``xdec`` also takes ``memory``.

The recurrent kinds (``mlstm``, ``slstm``, ``hymba``) come with ROADMAP.md
Queue 1 item 5(b); ``block_pattern`` and ``n_groups`` are whole, because
``configs.reduced`` reads them for every arch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.attention import (attention, attention_mask,
                                          is_direct)
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention


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
    buf[:, pos:end] = new.to(buf.dtype)


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
    q = q.reshape(b, s, cfg.n_heads, hd)
    src = x if kv_src is None else kv_src
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    kvh = k.shape[-1] // hd
    # T spelled out: an empty memory (T = 0) has no -1 to infer
    k = k.reshape(b, src.shape[1], kvh, hd)
    v = v.reshape(b, src.shape[1], kvh, hd)
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
    if causal:
        out = attention(q, k, v, q_offset=pos, window=window, kv_len=kv_len,
                        mask=ctx.mask(window))
    else:
        out = _bidir_attention(q, k, v)
    return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"], cache


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
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _mlp_apply(p["mlp"], h)
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
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    moe_out, aux, z = moe.moe_ff(h, p["router"], p["we_gate"], p["we_up"],
                                 p["we_down"], top_k=cfg.top_k,
                                 cap_factor=cfg.capacity_factor)
    if "shared" in p:
        moe_out = moe_out + _mlp_apply(p["shared"], h)
    x = x + moe_out
    return x, cache, (aux, z)


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
    x = x + attn_out
    h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    xattn_out, _ = _attn_apply(cfg, p["xattn"], h, cache=None, pos=pos,
                               window=0, ctx=ctx, causal=False, rope=False,
                               kv_src=memory)
    x = x + xattn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _mlp_apply(p["mlp"], h)
    return x, cache, (0.0, 0.0)


INIT = {"dense": init_dense, "moe": init_moe, "enc": init_enc,
        "xdec": init_xdec}
APPLY = {"dense": apply_dense, "moe": apply_moe, "enc": apply_enc,
         "xdec": apply_xdec}
