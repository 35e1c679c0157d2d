"""Data pipeline: dictionary-encoded, bit-packed token storage (the paper's
columnar substrate feeding the LM)."""
from repro_torch.data.tokenstore import TokenStore
from repro_torch.data.synthetic import synthetic_corpus
from repro_torch.data.loader import token_batches

__all__ = ["TokenStore", "synthetic_corpus", "token_batches"]
