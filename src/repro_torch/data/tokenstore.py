"""TokenStore: the LM corpus as a columnar, dictionary-encoded column.

The token-id vocabulary IS the dictionary (codes = ids); the store keeps the
stream bit-packed at ceil(log2(V)) bits (paper §5.1) and counts per token
(paper §6.2 — instant unigram stats for data curation). With
``device_unpack`` it keeps the words in the device layout instead
(divisor widths, ``kernels.bitunpack.repack_for_device``). Spans are
decoded on the host (:meth:`TokenStore.get_span`, which the loader reads).
"""
from __future__ import annotations

import numpy as np

from repro_torch.columnar.bitpack import bits_needed, pack_bits, unpack_bits
from repro_torch.kernels.bitunpack import repack_for_device


class TokenStore:
    def __init__(self, tokens: np.ndarray, vocab: int,
                 device_unpack: bool = False):
        tokens = np.asarray(tokens, dtype=np.int64)
        if tokens.ndim != 1:
            raise ValueError("tokens must be a flat stream")
        if tokens.size and tokens.max() >= vocab:
            raise ValueError("token id out of vocab range")
        self.vocab = vocab
        self.n = tokens.size
        self.bits = bits_needed(vocab)
        self.device_unpack = device_unpack
        # count metadata (paper §6.2)
        self.counts = np.bincount(tokens, minlength=vocab).astype(np.int64)
        if device_unpack:
            self.words, self.device_bits = repack_for_device(tokens, self.bits)
            self.tokens = None
        else:
            self.words = pack_bits(tokens, self.bits)
            self.device_bits = self.bits
            self.tokens = tokens.astype(np.int32)

    # -- §6.2 count-metadata stats over the corpus ---------------------------
    def unigram_probs(self) -> np.ndarray:
        return self.counts / max(self.n, 1)

    def entropy_bits(self) -> float:
        p = self.unigram_probs()
        p = p[p > 0]
        return float(-(p * np.log2(p)).sum())

    @property
    def packed_nbytes(self) -> int:
        return int(self.words.nbytes)

    @property
    def raw_nbytes(self) -> int:
        return 4 * self.n                     # int32 ids

    def get_span(self, start: int, length: int) -> np.ndarray:
        """Host path: decode a token span (used by the loader)."""
        if self.tokens is not None:
            return self.tokens[start:start + length]
        # decode only the covering word range
        s = 32 // self.device_bits
        w0 = start // s
        w1 = (start + length + s - 1) // s
        local = unpack_bits(self.words[w0:w1], self.device_bits,
                            (w1 - w0) * s)
        return local[start - w0 * s: start - w0 * s + length]
