"""Port parity, the data pipeline: ``repro_torch.data`` against
``repro.data`` on the CPU.

Every data test of ``tests/test_data_serve.py`` (``:15-76``) runs its own
asserts on both packages, and the port's arrays must equal the
reference's (``np.array_equal``): the corpus, the packed words and counts,
decoded spans, and every batch's tokens, labels, patch embeddings and
frames, for dense, vlm and audio configs and on a resume at
``start_step``. The loader puts its tensors on ``cuda`` unless a device is
named; these tests name the CPU.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import data as jdata
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro_torch import data
from repro_torch.configs import get_config, reduced

PACKAGES = ("jax", "port")


def _pkg(name):
    return jdata if name == "jax" else data


def _cfg(name, arch):
    return jreduced(jget_config(arch)) if name == "jax" else \
        reduced(get_config(arch))


def _batches(name, store, cfg, **kw):
    if name == "port":
        kw["device"] = "cpu"
    return _pkg(name).token_batches(store, cfg, **kw)


def _np(batch):
    """A batch (JAX arrays or CPU tensors) -> {name: numpy array}."""
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in batch.items()}


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- TokenStore (tests/test_data_serve.py:15-45) -------------------------------------
def test_tokenstore_roundtrip_and_compression():
    stores = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        corpus = pkg.synthetic_corpus(50_000, vocab=4099, seed=0)
        store = pkg.TokenStore(corpus, vocab=4099)
        assert store.bits == 13
        np.testing.assert_array_equal(store.get_span(1000, 64),
                                      corpus[1000:1064])
        assert store.packed_nbytes < 0.45 * store.raw_nbytes
        np.testing.assert_array_equal(store.counts,
                                      np.bincount(corpus, minlength=4099))
        assert 0 < store.entropy_bits() < 13
        stores[name] = (corpus, store)
    (jc, js), (c, s) = stores["jax"], stores["port"]
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s.words, js.words)
    np.testing.assert_array_equal(s.counts, js.counts)
    np.testing.assert_array_equal(s.unigram_probs(), js.unigram_probs())
    assert s.entropy_bits() == js.entropy_bits()
    assert (s.packed_nbytes, s.raw_nbytes, s.n) == \
        (js.packed_nbytes, js.raw_nbytes, js.n)


@given(st.integers(0, 1000), st.integers(1, 200), st.integers(0, 400),
       st.booleans())
@settings(max_examples=25, deadline=None)
def test_tokenstore_span_property(seed, length, start, device_unpack):
    spans = []
    for name in PACKAGES:
        pkg = _pkg(name)
        corpus = pkg.synthetic_corpus(1000, vocab=97, seed=seed)
        store = pkg.TokenStore(corpus, vocab=97, device_unpack=device_unpack)
        n = min(length, 1000 - start)
        span = store.get_span(start, n)
        np.testing.assert_array_equal(span, corpus[start:start + n])
        spans.append(span)
    np.testing.assert_array_equal(*spans)


def test_tokenstore_device_unpack_path():
    got = []
    for name in PACKAGES:
        pkg = _pkg(name)
        corpus = pkg.synthetic_corpus(10_000, vocab=50, seed=1)
        store = pkg.TokenStore(corpus, vocab=50, device_unpack=True)
        assert store.device_bits == 8          # 6 -> the device's 8
        assert store.tokens is None
        np.testing.assert_array_equal(store.get_span(123, 77),
                                      corpus[123:200])
        got.append(store)
    np.testing.assert_array_equal(got[0].words, got[1].words)


def test_tokenstore_refuses_bad_streams():
    for name in PACKAGES:
        pkg = _pkg(name)
        with pytest.raises(ValueError, match="flat"):
            pkg.TokenStore(np.zeros((2, 2), np.int64), vocab=4)
        with pytest.raises(ValueError, match="vocab"):
            pkg.TokenStore(np.array([0, 4]), vocab=4)


# -- the loader (tests/test_data_serve.py:48-76) -------------------------------------
def test_loader_restart_determinism():
    """Resuming at step k replays batch k exactly, on both packages, and
    the port's batches equal the reference's."""
    runs = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        cfg = _cfg(name, "qwen2-7b")
        store = pkg.TokenStore(pkg.synthetic_corpus(10_000, cfg.vocab),
                               cfg.vocab)
        it1 = _batches(name, store, cfg, batch=4, seq=16, seed=7)
        batches = [_np(next(it1)) for _ in range(5)]
        b3 = _np(next(_batches(name, store, cfg, batch=4, seq=16, seed=7,
                               start_step=3)))
        _equal_trees(batches[3], b3)
        runs[name] = batches
    for j, p in zip(runs["jax"], runs["port"]):
        _equal_trees(j, p)


def test_loader_labels_are_shifted():
    got = []
    for name in PACKAGES:
        pkg = _pkg(name)
        cfg = _cfg(name, "qwen2-7b")
        store = pkg.TokenStore(pkg.synthetic_corpus(10_000, cfg.vocab),
                               cfg.vocab)
        b = _np(next(_batches(name, store, cfg, batch=2, seq=16)))
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
        got.append(b)
    _equal_trees(*got)


def test_loader_vlm_audio_frontends():
    for arch in ("llava-next-mistral-7b", "seamless-m4t-large-v2"):
        got = []
        for name in PACKAGES:
            pkg = _pkg(name)
            cfg = _cfg(name, arch)
            store = pkg.TokenStore(pkg.synthetic_corpus(10_000, cfg.vocab),
                                   cfg.vocab)
            b = _np(next(_batches(name, store, cfg, batch=2, seq=16)))
            if cfg.family == "vlm":
                assert b["patch_embeds"].shape == (2, cfg.n_patches,
                                                   cfg.frontend_dim)
                assert (b["labels"][:, :cfg.n_patches] == -1).all()
            else:
                assert b["frames"].shape == (2, 16, cfg.frontend_dim)
            got.append(b)
        _equal_trees(*got)


# -- the port's arrays against the reference's -------------------------------------------
@pytest.mark.parametrize("arch", ["glm4-9b", "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("device_unpack", [False, True])
def test_batches_equal_the_references(arch, device_unpack):
    """Dense, vlm and audio configs, from either store layout: three steps
    from step 0 and two resumed at step 5, every array of every batch
    equal to the reference's (int32 tokens and labels, float32 patches and
    frames drawn from the same per-step generator)."""
    runs = {}
    for name in PACKAGES:
        pkg = _pkg(name)
        cfg = _cfg(name, arch)
        store = pkg.TokenStore(pkg.synthetic_corpus(20_000, cfg.vocab,
                                                    seed=3),
                               cfg.vocab, device_unpack=device_unpack)
        it = _batches(name, store, cfg, batch=3, seq=24, seed=11)
        resumed = _batches(name, store, cfg, batch=3, seq=24, seed=11,
                           start_step=5)
        runs[name] = [_np(next(it)) for _ in range(3)] + \
            [_np(next(resumed)) for _ in range(2)]
    for j, p in zip(runs["jax"], runs["port"]):
        _equal_trees(j, p)
    assert runs["port"][0]["tokens"].dtype == np.int32
    assert all(b.get("frames", np.float32([])).dtype == np.float32
               for b in runs["port"])


def test_seamless_store_at_full_vocab():
    """The store that feeds seamless-m4t-large-v2 on the card, at 1/10 of
    its corpus: 256,206 ids need 18 bits, kept in 32-bit device words;
    packed words, counts, entropy and a span equal the reference's."""
    vocab = get_config("seamless-m4t-large-v2").vocab
    stores = [pkg.TokenStore(pkg.synthetic_corpus(100_000, vocab, seed=0),
                             vocab, device_unpack=True)
              for pkg in (jdata, data)]
    js, s = stores
    assert (s.bits, s.device_bits) == (js.bits, js.device_bits) == (18, 32)
    np.testing.assert_array_equal(s.words, js.words)
    np.testing.assert_array_equal(s.counts, js.counts)
    assert s.entropy_bits() == js.entropy_bits()
    np.testing.assert_array_equal(s.get_span(99_000, 999),
                                  js.get_span(99_000, 999))


def test_token_batches_default_to_cuda(monkeypatch):
    """No device named: the batches go to ``cuda``, and without CUDA the
    call raises at once, not at the first batch."""
    cfg = reduced(get_config("qwen2-7b"))
    store = data.TokenStore(data.synthetic_corpus(1_000, cfg.vocab),
                            cfg.vocab)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data.token_batches(store, cfg, batch=2, seq=8)
    b = next(data.token_batches(store, cfg, batch=2, seq=8, device="cpu"))
    assert {t.device.type for t in b.values()} == {"cpu"}
