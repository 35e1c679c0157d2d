"""Plain PyTorch reference of the dense decoder family, in float32.

It follows the configuration file's ``model`` section (a dict), which is
the architecture both sides run: token embedding, ``n_layers`` blocks of
RMS norm -> causal GQA attention with RoPE (the halves layout) -> residual
-> RMS norm -> SwiGLU MLP -> residual, a final RMS norm and the vocabulary
head (the embedding transposed where ``tie_embeddings``); Q, K and V each
add a bias where ``qkv_bias``. Weights come in the layout :func:`shapes`
lists (``perfbench.weights`` draws them): stacked over layers, the
vocabulary padded to ``vocab_pad_multiple`` rows; only the first ``vocab``
rows are read, and logits are over ``vocab`` ids.

Every product runs in float32 with TF32 off, one layer at a time, on
whatever dtype the weights are stored in (each layer is cast to float32 as
it is used). ``prec="fp8"`` makes the control: each product's two operands
are rounded to float8 e4m3 with a per-tensor scale first (the gradient
passes straight through the rounding).

Training (:func:`loss_and_grads`, :func:`adamw_steps`) recomputes each
layer in the backward from its saved input, so only one layer's
activations are live; the parameters are held in the configuration's
dtype after each update, as the program holds them.

Imports torch, numpy and math only.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def padded_vocab(model: dict) -> int:
    m = model["vocab_pad_multiple"]
    return -(-model["vocab"] // m) * m


def shapes(model: dict) -> list[tuple[str, tuple, str]]:
    """(dotted path, shape, init) of every leaf, in drawing order; init is
    "embed", "dense", "bias" or "ones" (``perfbench.weights``)."""
    d, n, hd = model["d_model"], model["n_layers"], model["d_head"]
    h, kv, f = model["n_heads"], model["n_kv"], model["d_ff"]
    v = padded_vocab(model)
    out = [("embed", (v, d), "embed"), ("final_norm", (d,), "ones"),
           ("blocks.0.ln1", (n, d), "ones"), ("blocks.0.ln2", (n, d), "ones"),
           ("blocks.0.attn.wq", (n, d, h * hd), "dense"),
           ("blocks.0.attn.wk", (n, d, kv * hd), "dense"),
           ("blocks.0.attn.wv", (n, d, kv * hd), "dense"),
           ("blocks.0.attn.wo", (n, h * hd, d), "dense"),
           ("blocks.0.mlp.wg", (n, d, f), "dense"),
           ("blocks.0.mlp.wu", (n, d, f), "dense"),
           ("blocks.0.mlp.wd", (n, f, d), "dense")]
    if not model["tie_embeddings"]:
        out.append(("head", (d, v), "dense"))
    if model.get("qkv_bias"):
        out += [("blocks.0.attn.bq", (n, h * hd), "bias"),
                ("blocks.0.attn.bk", (n, kv * hd), "bias"),
                ("blocks.0.attn.bv", (n, kv * hd), "bias")]
    return out


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the products inside (and restored after)."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448) and
    back to float32; the gradient passes straight through."""
    d = x.detach()
    scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(F32) / scale
    return x + (q - d)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * \
        scale


def rope(x, positions, theta: float):
    """x (B, S, H, dh) rotated at ``positions`` (S,): channel i < dh/2
    pairs with channel i + dh/2."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32,
                                        device=x.device) / dh))
    ang = positions.to(F32)[:, None] * inv[None, :]           # (S, dh/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: str):
    """Causal attention over the whole sequence: q (B, S, H, dh), k and v
    (B, S, KV, dh); query head h reads KV head h // (H / KV)."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))          # (B, H, S, dh)
    scores = mm(q, k.transpose(-1, -2), prec) * dh ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), v, prec)
    return out.transpose(1, 2).reshape(b, s, h * dh)


def layer_weights(params: dict, i: int) -> dict:
    """Layer i's weights in float32: {ln1, ln2, wq, wk, wv, wo, wg, wu,
    wd} and, with QKV biases, {bq, bk, bv}."""
    blk = params["blocks"][0]
    w = {"ln1": blk["ln1"][i], "ln2": blk["ln2"][i]}
    w.update({k: t[i] for k, t in blk["attn"].items()})
    w.update({k: t[i] for k, t in blk["mlp"].items()})
    return {k: t.to(F32) for k, t in w.items()}


def block(cfg: dict, w: dict, x, positions, prec: str):
    """One decoder layer on x (B, S, D) float32."""
    b, s, _ = x.shape
    hd = cfg["d_head"]
    h = rms_norm(x, w["ln1"], cfg["norm_eps"])
    q, k, v = mm(h, w["wq"], prec), mm(h, w["wk"], prec), mm(h, w["wv"], prec)
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.reshape(b, s, cfg["n_heads"], hd), positions, cfg["rope_theta"])
    k = rope(k.reshape(b, s, cfg["n_kv"], hd), positions, cfg["rope_theta"])
    v = v.reshape(b, s, cfg["n_kv"], hd)
    x = x + mm(attention(q, k, v, prec), w["wo"], prec)
    h = rms_norm(x, w["ln2"], cfg["norm_eps"])
    mlp = F.silu(mm(h, w["wg"], prec)) * mm(h, w["wu"], prec)
    return x + mm(mlp, w["wd"], prec)


def head_matrix(cfg: dict, params: dict) -> torch.Tensor:
    """(D, vocab) float32: the head's first ``vocab`` columns."""
    v = cfg["vocab"]
    if cfg["tie_embeddings"]:
        return params["embed"][:v].to(F32).T
    return params["head"][:, :v].to(F32)


def hidden(cfg: dict, params: dict, tokens: torch.Tensor, prec: str):
    """tokens (B, S) -> the final-normed hidden states (B, S, D)."""
    x = params["embed"][tokens.long()].to(F32)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg["n_layers"]):
        x = block(cfg, layer_weights(params, i), x, pos, prec)
    return rms_norm(x, params["final_norm"].to(F32), cfg["norm_eps"])


@torch.no_grad()
def logits_at(cfg: dict, params: dict, tokens: torch.Tensor,
              positions: torch.Tensor, prec: str = "float32",
              rows: int = 4) -> torch.Tensor:
    """Logits (B, P, vocab) float32 at ``positions`` (P,) of each row of
    ``tokens`` (B, S): the full causal forward over the whole row, ``rows``
    rows at a time."""
    out = []
    with exact_float32():
        head = head_matrix(cfg, params)
        for r0 in range(0, tokens.shape[0], rows):
            x = hidden(cfg, params, tokens[r0:r0 + rows], prec)
            out.append(mm(x[:, positions], head, prec))
            del x
    return torch.cat(out)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _ce(cfg, params, x, labels, prec):
    """Mean cross-entropy of labels (B, S) under the head, from the last
    layer's output x; ``params``' embed and final_norm may require grad."""
    xn = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    v = cfg["vocab"]
    head = params["embed"][:v].T if cfg["tie_embeddings"] else \
        params["head"][:, :v]
    logits = mm(xn.reshape(-1, xn.shape[-1]), head, prec)
    return F.cross_entropy(logits, labels.reshape(-1).long())


def loss_and_grads(cfg: dict, params32: dict, tokens, labels,
                   prec: str = "float32"):
    """(loss, grads) of the mean cross-entropy of ``labels`` given
    ``tokens`` (both (B, S)); ``params32`` float32 in the benchmark's
    layout, grads the same layout (zeros in the vocabulary's padding)."""
    n = cfg["n_layers"]
    blk = params32["blocks"][0]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    grads = {"embed": torch.zeros_like(params32["embed"]),
             "blocks": [{"ln1": torch.zeros_like(blk["ln1"]),
                         "ln2": torch.zeros_like(blk["ln2"]),
                         "attn": {k: torch.zeros_like(t)
                                  for k, t in blk["attn"].items()},
                         "mlp": {k: torch.zeros_like(t)
                                 for k, t in blk["mlp"].items()}}]}
    if "head" in params32:
        grads["head"] = torch.zeros_like(params32["head"])
    with exact_float32():
        with torch.no_grad():
            x = params32["embed"][tokens.long()]
            inputs = []
            for i in range(n):
                inputs.append(x)
                x = block(cfg, layer_weights(params32, i), x, pos, prec)
        top = {k: params32[k].detach().requires_grad_()
               for k in ("embed", "final_norm", "head") if k in params32}
        x_last = x.detach().requires_grad_()
        loss = _ce(cfg, top, x_last, labels, prec)
        loss.backward()
        for k, t in top.items():
            if k == "final_norm":
                grads[k] = t.grad
            elif t.grad is not None:
                grads[k] += t.grad
        g = x_last.grad
        del top, x_last, x
        for i in reversed(range(n)):
            w = {k: t.detach().requires_grad_()
                 for k, t in layer_weights(params32, i).items()}
            xi = inputs.pop().requires_grad_()
            block(cfg, w, xi, pos, prec).backward(g)
            g = xi.grad
            gb = grads["blocks"][0]
            gb["ln1"][i], gb["ln2"][i] = w["ln1"].grad, w["ln2"].grad
            for part in ("attn", "mlp"):
                for k in gb[part]:
                    gb[part][k][i] = w[k].grad
            del w, xi
        grads["embed"].index_add_(0, tokens.reshape(-1).long(),
                                  g.reshape(-1, g.shape[-1]))
    return float(loss.detach()), grads


def leaves(tree, prefix: str = "") -> dict:
    """{dotted path: tensor} of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def wsd_lr(step: int, *, peak: float, warmup: int, total: int,
           decay_frac: float = 0.1, final_frac: float = 0.01) -> float:
    """Warmup (linear from 0) -> stable at ``peak`` -> exponential decay
    to ``final_frac * peak`` over the last ``decay_frac`` of ``total``."""
    start = total * (1.0 - decay_frac)
    if step < warmup:
        return peak * step / max(warmup, 1)
    if step < start:
        return peak
    t = min(max((step - start) / max(total - start, 1), 0.0), 1.0)
    return peak * final_frac ** t


def adamw_steps(cfg: dict, job: dict, params: dict, batches,
                prec: str = "float32", half_batch: bool = False,
                sample: dict | None = None) -> dict:
    """Runs len(batches) AdamW steps from ``params`` (the configuration's
    dtype; not changed), each batch a (tokens, labels) pair. Returns
    {"loss": [per step], "grad_norms": {leaf: norm of the clipped first
    gradient}, "grad_norms_raw": {leaf: unclipped}, "change_norms": {leaf:
    norm of the parameters' change over all the steps}, "grad_sample":
    {leaf: the clipped first gradient at the flat indices ``sample`` gives
    for that leaf}}. ``half_batch`` plants a fault: each step's loss is the mean over the first half of
    the rows only."""
    if job["schedule"] != "wsd":
        raise ValueError(f"the reference follows WSD, not {job['schedule']}")
    store = DTYPES[cfg["dtype"]]
    start = leaves(params)
    p = {k: t.to(F32, copy=True) for k, t in start.items()}
    tree = _tree_of(params, p)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    b1, b2, eps, wd = job["b1"], job["b2"], job["eps"], job["weight_decay"]
    out: dict = {"loss": []}
    for step, (tokens, labels) in enumerate(batches):
        if half_batch:
            half = tokens.shape[0] // 2
            tokens, labels = tokens[:half], labels[:half]
        loss, grads = loss_and_grads(cfg, tree, tokens, labels, prec)
        g = leaves(grads)
        del grads
        out["loss"].append(loss)
        norm = math.sqrt(sum(float(t.double().square().sum())
                             for t in g.values()))
        factor = min(1.0, job["clip_norm"] / max(norm, 1e-9))
        if step == 0:
            out["grad_norms_raw"] = {k: float(t.norm()) for k, t in g.items()}
            out["grad_norms"] = {k: float(t.norm()) * factor
                                 for k, t in g.items()}
            out["grad_sample"] = {
                k: (g[k].reshape(-1)[torch.from_numpy(idx).to(
                    g[k].device)].double() * factor).cpu().numpy()
                for k, idx in (sample or {}).items()}
        lr = wsd_lr(step, peak=job["lr"], warmup=job["warmup"],
                    total=job["total_steps"])
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        for k in p:
            gk = g.pop(k).mul_(factor)
            m[k].mul_(b1).add_(gk, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(gk, gk, value=1 - b2)
            del gk
            upd = (m[k] / c1) / ((v[k] / c2).sqrt_().add_(eps))
            upd.add_(p[k], alpha=wd)
            p[k].sub_(upd, alpha=lr)
            p[k].copy_(p[k].to(store).to(F32))      # held in the config dtype
            del upd
    out["change_norms"] = {k: float((p[k] - start[k].to(F32)).norm())
                           for k in p}
    return out


def _tree_of(params, flat: dict, prefix: str = ""):
    """``params``' structure with the leaves taken from ``flat``."""
    if isinstance(params, dict):
        return {k: _tree_of(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_tree_of(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(params)]
    return flat[prefix]


def loader_batches(corpus: np.ndarray, seed: int, steps, batch: int,
                   seq: int, device) -> list:
    """The training job's batches, worked out from the raw corpus: step
    s's rows start at ``default_rng((seed, s)).integers(0, n - seq - 1,
    batch)``, each row ``seq + 1`` tokens, inputs the first ``seq``,
    labels the last ``seq``."""
    out = []
    for s in steps:
        starts = np.random.default_rng((seed, s)).integers(
            0, corpus.size - seq - 1, size=batch)
        w = np.stack([corpus[a:a + seq + 1] for a in starts])
        out.append((torch.from_numpy(w[:, :-1].astype(np.int64)).to(device),
                    torch.from_numpy(w[:, 1:].astype(np.int64)).to(device)))
    return out
