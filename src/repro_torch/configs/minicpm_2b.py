"""minicpm-2b — dense llama-like, MHA (kv=36), tied embeddings, WSD
schedule (train.schedule.wsd). [arXiv:2404.06395; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    rope_theta=1e4,
    notes="WSD LR schedule is the arch's training signature; see "
          "repro.train.schedule.wsd",
)
