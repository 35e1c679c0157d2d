"""ModelConfig: one dataclass covering every assigned architecture family."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # layer i is MoE iff i % moe_every == moe_every-1
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0      # 0 = full causal
    n_full_attn: int = 0         # hybrid: # of layers that stay full-attention

    # --- ssm / xlstm / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2          # d_inner = ssm_expand * d_model
    conv_width: int = 4
    slstm_group: int = 0         # xlstm: group = (slstm_group-1) mLSTM + 1 sLSTM
    qk_dim_ratio: float = 0.5    # xlstm mLSTM: dk = ratio * dv

    # --- mlp ---
    mlp_style: str = "swiglu"    # swiglu (3 mats) | gelu (2 mats)

    # --- embeddings / head ---
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256

    # --- enc-dec / frontends (vlm, audio) ---
    enc_layers: int = 0
    frontend: str = "none"       # none | vision | audio
    frontend_dim: int = 0        # stub embedding dim fed by input_specs
    n_patches: int = 0           # vlm: patches prepended to the sequence

    # --- numerics ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "layer"         # none | layer | dots
    scan_unroll: bool = False    # unroll the layer scan (dry-run cost probes)
    loss_chunk: int = 1024       # seq-chunked checkpointed CE (0 = full logits)
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (dictionary-quantized)
    grad_accum: int = 1          # microbatches per step (activation liveness)
    force_fsdp: bool = False     # FSDP-shard params regardless of size
    pure_dp: bool = False        # use the model axis as extra data parallelism
                                 # (ZeRO-3 weight sharding, no TP) — right call
                                 # for <2B-param models where TP-16 drowns in
                                 # per-layer activation collectives
    notes: str = ""

    # ----- derived -----
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0 and
                i % self.moe_every == self.moe_every - 1)

    @property
    def n_moe_layers(self) -> int:
        return sum(self.is_moe_layer(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        n_mats = 3 if self.mlp_style == "swiglu" else 2
        mlp = n_mats * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            moe = self.n_moe_layers * (self.n_experts * 3 * d * f + d * self.n_experts)
            dense = (self.n_layers - self.n_moe_layers) * mlp
            shared = self.n_layers * mlp if self.shared_expert else 0
            return emb + self.n_layers * attn + moe + dense + shared
        if self.family == "ssm":
            di = self.d_inner
            dk = int(di * self.qk_dim_ratio)
            mlstm = d * (2 * dk + 2 * di) + di * d + 3 * di  # q,k,v,up(+gates),out
            return emb + self.n_layers * mlstm
        if self.family == "hybrid":
            di = self.d_inner
            ssm = d * (di + 2 * self.n_heads * self.ssm_state + di) + di * d
            return emb + self.n_layers * (attn + ssm + mlp)
        n_dec = self.n_layers
        n_enc = self.enc_layers
        cross = 2 * d * self.n_kv * hd + d * self.n_heads * hd + self.n_heads * hd * d
        return emb + n_dec * (attn + mlp) + n_enc * (attn + mlp) + \
            (n_dec * cross if n_enc else 0)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        mlp = 3 * d * f
        per_moe = self.top_k * 3 * d * f + d * self.n_experts + \
            (mlp if self.shared_expert else 0)
        act = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            act += attn + (per_moe if self.is_moe_layer(i) else mlp)
        return act
