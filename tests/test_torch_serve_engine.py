"""Port parity, the LM serving engine: ``repro_torch.serve.ServeEngine``
against ``repro.serve.ServeEngine`` on the CPU.

Every test of ``tests/test_serve_engine.py`` and the four engine tests of
``tests/test_data_serve.py`` (``:86-137``) run on both packages: the
reference's parameters for reduced glm4-9b (``init_params`` from
``PRNGKey(0)``) are carried into the port with ``params_from_reference``,
each scenario runs its own asserts on each package's engine, and the
port's greedy tokens must equal the JAX engine's, request by request.
The ghost-slot, solo-against-batch and greedy-against-forward scenarios
also run on the two MoE archs, on seamless and on the recurrent xlstm
and hymba (:data:`ENGINE_ARCHS`, with glm4-9b every arch of
``configs.ARCH_IDS`` but the other dense ones): a MoE layer routes each
batch row on its own, and a recurrent state is a row's own, so a
request's tokens do not depend on its neighbours; the engine passes no
frames, so seamless's cross-attention reads an empty memory in both
engines (its forward is given zero frames to match).

Temperature sampling draws from each engine's own seeded generator; JAX's
and torch's streams cannot match (a deliberate difference), so that test
keeps its own assert on each package and adds one of the port's: the same
seed gives the same stream.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


class _Package:
    """One package's engine and request types over the same parameters."""

    def __init__(self, port: bool, cfg, params):
        self.port, self.cfg, self.params = port, cfg, params
        self.Request = Request if port else JRequest

    def engine(self, **kw):
        if self.port:
            return ServeEngine(self.cfg, self.params, device="cpu", **kw)
        return JServeEngine(self.cfg, self.params, **kw)

    def logits(self, seq):
        """The training forward's last-position logits over ``seq``."""
        batch = {"tokens": np.asarray([seq], np.int32)}
        if self.cfg.family == "audio":            # the engine's empty memory
            batch["frames"] = np.zeros((1, 0, self.cfg.frontend_dim),
                                       np.float32)
        if self.port:
            out, _, _ = lm.forward(self.cfg, self.params,
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
            return out[0, -1].numpy()
        out, _, _ = jlm.forward(self.cfg, self.params,
                                {k: jnp.asarray(v) for k, v in batch.items()})
        return np.asarray(out[0, -1])


ENGINE_ARCHS = ["glm4-9b", "moonshot-v1-16b-a3b",
                "llama4-maverick-400b-a17b", "seamless-m4t-large-v2",
                "xlstm-1.3b", "hymba-1.5b"]


def _packages(arch):
    jcfg = jreduced(jget_config(arch))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm.params_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return (_Package(False, jcfg, jparams),
            _Package(True, reduced(get_config(arch)), params))


@pytest.fixture(scope="module")
def packages():
    return _packages("glm4-9b")


@pytest.fixture(scope="module", params=ENGINE_ARCHS)
def arch_packages(request, packages):
    return packages if request.param == "glm4-9b" else \
        _packages(request.param)


def _on_both(packages, scenario):
    """Run ``scenario(pkg)`` on the reference, then on the port; the
    port's greedy streams must equal the reference's."""
    ref, port = (scenario(pkg) for pkg in packages)
    assert port == ref
    return port


def _prompt(cfg, n=6, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, n).astype(np.int32)


def _greedy(pkg, prompt, max_new, *, batch_size, max_len=24):
    eng = pkg.engine(batch_size=batch_size, max_len=max_len)
    return eng.run_batch([pkg.Request(prompt=prompt.copy(),
                                      max_new_tokens=max_new)])[0].out_tokens


# -- tests/test_serve_engine.py ------------------------------------------------------
def test_ghost_slots_do_not_perturb_real_outputs(arch_packages):
    """A partially-filled batch zero-pads the unused slots; the real
    request's greedy decode must be bit-identical to a batch_size=1 run."""
    def scenario(pkg):
        p = _prompt(pkg.cfg)
        want = _greedy(pkg, p, 6, batch_size=1)
        for b in (2, 4):
            got = _greedy(pkg, p, 6, batch_size=b)
            assert got == want, f"ghost slots leaked at batch_size={b}"
        return want
    _on_both(arch_packages, scenario)


def test_two_real_slots_match_their_solo_runs(arch_packages):
    def scenario(pkg):
        pa, pb = _prompt(pkg.cfg, seed=1), _prompt(pkg.cfg, seed=2)
        want_a = _greedy(pkg, pa, 5, batch_size=1)
        want_b = _greedy(pkg, pb, 5, batch_size=1)
        eng = pkg.engine(batch_size=4, max_len=24)
        ra, rb = eng.run_batch(
            [pkg.Request(prompt=pa.copy(), max_new_tokens=5),
             pkg.Request(prompt=pb.copy(), max_new_tokens=5)])
        assert ra.out_tokens == want_a
        assert rb.out_tokens == want_b
        return ra.out_tokens, rb.out_tokens
    _on_both(arch_packages, scenario)


def test_per_request_max_new_tokens(packages):
    """Mixed budgets in one batch: the short request stops at ITS budget,
    the long one keeps decoding to its own."""
    def scenario(pkg):
        p = _prompt(pkg.cfg, seed=3)
        eng = pkg.engine(batch_size=4, max_len=24)
        short, long = eng.run_batch(
            [pkg.Request(prompt=p.copy(), max_new_tokens=2),
             pkg.Request(prompt=p.copy(), max_new_tokens=6)])
        assert len(short.out_tokens) == 2
        assert len(long.out_tokens) == 6
        assert short.out_tokens == long.out_tokens[:2]
        return short.out_tokens, long.out_tokens
    _on_both(packages, scenario)


def test_eos_stops_one_slot_not_its_neighbor(packages):
    def scenario(pkg):
        p = _prompt(pkg.cfg, seed=4)
        want = _greedy(pkg, p, 6, batch_size=4)
        eos = want[0]
        eng = pkg.engine(batch_size=4, max_len=24)
        stopped, full = eng.run_batch(
            [pkg.Request(prompt=p.copy(), max_new_tokens=6, eos_id=eos),
             pkg.Request(prompt=p.copy(), max_new_tokens=6)])
        assert stopped.out_tokens == [eos]
        assert full.out_tokens == want
        return stopped.out_tokens, full.out_tokens
    _on_both(packages, scenario)


def test_all_slots_eos_ends_batch_early(packages):
    def scenario(pkg):
        p = _prompt(pkg.cfg, seed=5)
        eos = _greedy(pkg, p, 1, batch_size=1)[0]
        eng = pkg.engine(batch_size=2, max_len=24)
        done = eng.run_batch(
            [pkg.Request(prompt=p.copy(), max_new_tokens=8, eos_id=eos)
             for _ in range(2)])
        for r in done:
            assert r.out_tokens == [eos]
        return [r.out_tokens for r in done]
    _on_both(packages, scenario)


def test_max_len_truncates_decode(packages):
    """Decode stops once the write head hits max_len: exactly
    max_len - plen + 1 new tokens (the position check runs before each
    decode step), a prefix of a roomier engine's stream."""
    def scenario(pkg):
        plen, max_len = 6, 10
        p = _prompt(pkg.cfg, n=plen, seed=6)
        eng = pkg.engine(batch_size=1, max_len=max_len)
        r = eng.run_batch([pkg.Request(prompt=p, max_new_tokens=64)])[0]
        assert len(r.out_tokens) == max_len - plen + 1
        roomy = _greedy(pkg, p, 64, batch_size=1, max_len=24)
        assert r.out_tokens == roomy[:len(r.out_tokens)]
        return r.out_tokens, roomy
    _on_both(packages, scenario)


def test_engine_rejects_bad_batches(packages):
    def scenario(pkg):
        eng = pkg.engine(batch_size=2, max_len=16)
        with pytest.raises(ValueError):
            eng.run_batch([pkg.Request(prompt=_prompt(pkg.cfg))
                           for _ in range(3)])
        with pytest.raises(ValueError):
            eng.run_batch([pkg.Request(prompt=_prompt(pkg.cfg, n=4)),
                           pkg.Request(prompt=_prompt(pkg.cfg, n=6))])
    _on_both(packages, scenario)


def test_engine_throughput_stats_json_safe(packages):
    """wall_s <= 0 gives tok_per_s 0.0 and a flag, never inf."""
    def scenario(pkg):
        eng = pkg.engine(batch_size=1, max_len=16)
        done = eng.run_batch([pkg.Request(prompt=_prompt(pkg.cfg),
                                          max_new_tokens=4)])
        for wall in (0.0, -0.5):
            st = eng.throughput_stats(done, wall)
            assert st["wall_s_invalid"] is True
            assert st["tok_per_s"] == 0.0
            json.dumps(st, allow_nan=False)
        ok = eng.throughput_stats(done, 2.0)
        assert ok["wall_s_invalid"] is False
        assert ok["tok_per_s"] == pytest.approx(ok["new_tokens"] / 2.0)
        assert ok["new_tokens"] == 4
        return done[0].out_tokens, ok
    _on_both(packages, scenario)


# -- tests/test_data_serve.py:86-137 ------------------------------------------------------
def test_engine_batched_requests(packages):
    def scenario(pkg):
        eng = pkg.engine(batch_size=4, max_len=24)
        rng = np.random.default_rng(0)
        reqs = [pkg.Request(prompt=rng.integers(0, pkg.cfg.vocab, 8)
                            .astype(np.int32), max_new_tokens=6)
                for _ in range(4)]
        done = eng.run_batch(reqs)
        for r in done:
            assert len(r.out_tokens) == 6
            assert all(0 <= t < pkg.cfg.vocab for t in r.out_tokens)
        return [r.out_tokens for r in done]
    _on_both(packages, scenario)


def test_engine_greedy_matches_forward(arch_packages):
    """Engine greedy decode == argmax over the training forward (teacher
    forcing on its own outputs)."""
    def scenario(pkg):
        eng = pkg.engine(batch_size=1, max_len=16)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, pkg.cfg.vocab, 6).astype(np.int32)
        req = eng.run_batch([pkg.Request(prompt=prompt,
                                         max_new_tokens=4)])[0]
        seq = list(prompt)
        for i in range(4):
            nxt = int(np.argmax(pkg.logits(seq)[:pkg.cfg.vocab]))
            assert nxt == req.out_tokens[i], (i, nxt, req.out_tokens)
            seq.append(nxt)
        return req.out_tokens
    _on_both(arch_packages, scenario)


def test_engine_eos_stops_early(packages):
    def scenario(pkg):
        eng = pkg.engine(batch_size=1, max_len=32)
        prompt = np.arange(4, dtype=np.int32)
        r1 = eng.run_batch([pkg.Request(prompt=prompt,
                                        max_new_tokens=3)])[0]
        eos = r1.out_tokens[0]
        r2 = eng.run_batch([pkg.Request(prompt=prompt, max_new_tokens=8,
                                        eos_id=eos)])[0]
        assert r2.out_tokens[0] == eos and len(r2.out_tokens) == 1
        return r1.out_tokens, r2.out_tokens
    _on_both(packages, scenario)


def test_engine_temperature_sampling(packages):
    """Hot sampling makes two identical prompts diverge, on each package.
    The streams are each engine's own (JAX's and torch's generators
    differ); the port's is fixed by its seed."""
    def run(pkg, seed=3):
        eng = pkg.engine(batch_size=2, max_len=16, temperature=1.5,
                         seed=seed)
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, pkg.cfg.vocab, 4).astype(np.int32)
        r = eng.run_batch([pkg.Request(prompt=prompt.copy(),
                                       max_new_tokens=8),
                           pkg.Request(prompt=prompt.copy(),
                                       max_new_tokens=8)])
        assert r[0].out_tokens != r[1].out_tokens
        assert all(0 <= t < pkg.cfg.vocab
                   for q in r for t in q.out_tokens)
        return [q.out_tokens for q in r]

    jax_pkg, port = packages
    run(jax_pkg)
    assert run(port) == run(port)
    assert run(port) != run(port, seed=4)


# -- the port's device rule ----------------------------------------------------------------
def test_engine_refuses_parameters_off_its_device(packages):
    _, port = packages
    with pytest.raises(ValueError, match="not on the engine's device"):
        ServeEngine(port.cfg, port.params, batch_size=1, max_len=8,
                    device="meta")
    mixed = dict(port.params, final_norm=port.params["final_norm"].to(
        "meta"))
    with pytest.raises(ValueError, match="meta"):
        ServeEngine(port.cfg, mixed, batch_size=1, max_len=8, device="cpu")


# -- the card-against-CPU check (repro_torch.serve.lm_parity) ---------------------------------
@pytest.mark.parametrize("arch,cache", [
    ("glm4-9b", "bfloat16"), ("glm4-9b", "int8"),
    ("moonshot-v1-16b-a3b", "bfloat16"),
    ("llama4-maverick-400b-a17b", "bfloat16"),
    ("xlstm-1.3b", "bfloat16"), ("hymba-1.5b", "bfloat16")])
def test_lm_parity_check_runs_on_the_cpu(arch, cache):
    """``check_card_matches_cpu`` with the CPU standing in for the card:
    every comparison it makes passes, over every logit; a MoE arch's
    routing is compared with no flip."""
    from repro_torch.serve import lm_parity
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              kv_cache_dtype=cache)
    line = lm_parity.check_card_matches_cpu(cfg, "cpu", seed=1, max_len=24)
    n = lm_parity.BATCH * (lm_parity.PROMPT + lm_parity.NEW - 1) * cfg.vocab
    assert f" {n} logits within" in line and "one apart" not in line
    assert (" 0 flips" in line) == (cfg.family == "moe")


def test_lm_parity_int8_code_flips():
    """A code one apart is counted and bounds its sequence's compared
    positions; codes two apart raise."""
    from repro_torch.serve import lm_parity
    cfg = dataclasses.replace(reduced(get_config("glm4-9b")),
                              kv_cache_dtype="int8")
    a = lm.init_serve_state(cfg, 3, 16, device="cpu")
    b = lm.init_serve_state(cfg, 3, 16, device="cpu")
    assert lm_parity._code_flips(a, b, 10)[0] == 0
    b["blocks"][0]["v"][1, 2, 7, 0, 3] = 1        # group 1, sequence 2
    b["blocks"][0]["k"][0, 2, 9, 1, 0] = -1
    flips, first = lm_parity._code_flips(a, b, 10)
    assert flips == 2 and first.tolist() == [10, 10, 7]
    b["blocks"][0]["k"][0, 0, 3, 0, 0] = 2
    with pytest.raises(AssertionError, match="up to 2"):
        lm_parity._code_flips(a, b, 10)
