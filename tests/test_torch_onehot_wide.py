"""Port parity, the one-hot wide layer: ``repro_torch`` against ``repro``.

The same seeded codes and weights go through the JAX package's Pallas
kernel (interpret mode) and its pure-jnp versions, and through the port's
wrapper on CPU tensors (the plain versions of the CUDA kernels).

- Forward, float32: equal to the Pallas kernel bit for bit, on in-range and
  out-of-range codes alike (a code outside [0, K) adds nothing); within
  1e-6 of ``onehot_wide_ref`` and ``onehot_wide_materialized`` on in-range
  codes (they sum in another order). bfloat16: within 5e-2 of the Pallas
  kernel, the JAX test's own tolerance (the Pallas kernel rounds to bf16
  after every column, the port once).
- Backward: within rtol 1e-5 / atol 1e-6 of ``jax.grad`` (JAX cannot
  differentiate the Pallas call, so the oracle is autodiff through the
  jnp gather under the kernel's rule); out-of-range codes get no gradient.
  Also bit for bit: each entry is the float32 sum of its rows in ascending
  order from +0.0 in both packages (the order the CUDA kernel keeps), so
  the port's gradient equals ``jax.grad`` of ``onehot_wide_ref`` exactly on
  in-range codes, and the kernel rule's autodiff where codes fall outside
  [0, K).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.onehot_wide import onehot_wide as j_onehot_wide
from repro.kernels.onehot_wide.ref import (onehot_wide_materialized,
                                           onehot_wide_ref as j_ref)
from repro_torch.kernels import edge_cases
from repro_torch.kernels.onehot_wide import ops, ref
from repro_torch.kernels.onehot_wide.ops import onehot_wide

# the shapes of tests/test_kernels.py's sweep: (C, N, K, F)
SHAPES = [(1, 16, 4, 8), (3, 100, 50, 16), (2, 256, 600, 128), (5, 33, 7, 1)]


def _inputs(c, n, k, f, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, k, f)).astype(np.float32)
    codes = rng.integers(0, k, size=(c, n)).astype(np.int32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    return codes, w, g


def _port(codes, w, dtype=torch.float32):
    return onehot_wide(torch.from_numpy(codes),
                       torch.from_numpy(w).to(dtype))


@pytest.mark.parametrize("c,n,k,f", SHAPES)
def test_forward_equals_pallas_kernel_f32(c, n, k, f):
    codes, w, _ = _inputs(c, n, k, f, seed=c * n + k)
    want = np.asarray(j_onehot_wide(jnp.asarray(codes), jnp.asarray(w)))
    got = _port(codes, w).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("c,n,k,f", SHAPES)
def test_forward_bf16_matches_pallas_kernel(c, n, k, f):
    codes, w, _ = _inputs(c, n, k, f, seed=c * n + k)
    want = np.asarray(j_onehot_wide(jnp.asarray(codes),
                                    jnp.asarray(w, jnp.bfloat16)), np.float32)
    got = _port(codes, w, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("c,n,k,f", SHAPES)
def test_forward_matches_jnp_versions_in_range(c, n, k, f):
    codes, w, _ = _inputs(c, n, k, f, seed=c * n + k + 1)
    got = _port(codes, w).numpy()
    jc, jw = jnp.asarray(codes), jnp.asarray(w)
    for want in (j_ref(jc, jw), onehot_wide_materialized(jc, jw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_forward_out_of_range_codes_equal_pallas_kernel():
    """-1 (the Pallas wrapper's padding), K (inside the zero rows the
    wrapper pads K to 512 with), past the padded K, and both int32 ends
    add nothing, in the Pallas kernel and in the port."""
    c, n, k, f = 2, 300, 5, 3
    codes, w, _ = _inputs(c, n, k, f, seed=11)
    bad = np.array([-1, k, 511, 512, 600, (1 << 31) - 1, -(1 << 31)],
                   np.int32)
    codes[0, :bad.size] = bad
    codes[1, 100:100 + bad.size] = bad[::-1]
    want = np.asarray(j_onehot_wide(jnp.asarray(codes), jnp.asarray(w)))
    got = _port(codes, w).numpy()
    assert np.array_equal(got, want)
    # rows whose codes are all out of range are exactly zero
    codes[:, 7] = -1
    assert not _port(codes, w).numpy()[7].any()


@pytest.mark.parametrize(
    "f", edge_cases.WIDE_FWD_FS + edge_cases.WIDE_FWD_PASSES["fs"])
def test_forward_grid_equals_pallas_kernel(f):
    """``edge_cases.onehot_wide_forward_cases`` at one F (the forward
    kernels' grid: C up to 33, N up to 1,025, K up to 600, codes -1, K and
    the int32 ends among them, w aligned and as an offset view; F 1,024
    and 1,030 on ``WIDE_FWD_PASSES``' grid): float32 equals the Pallas
    kernel (interpret mode) bit for bit, and bfloat16 equals the kernel
    rule summed in float32 in ascending c and rounded once. C = 0 gives
    zeros (the Pallas wrapper takes no empty column axis)."""
    grid = dict(edge_cases.WIDE_FWD_PASSES, fs=(f,)) \
        if f in edge_cases.WIDE_FWD_PASSES["fs"] else dict(fs=(f,))
    for codes, w in edge_cases.onehot_wide_forward_cases(
            np.random.default_rng(300 + f), "cpu", **grid):
        c, n = codes.shape
        k = w.shape[1]
        got = onehot_wide(codes, w)
        assert got.dtype == w.dtype and got.shape == (n, f)
        cn, wn = codes.numpy(), w.float().numpy()
        rule = np.zeros((n, f), np.float32)
        for ci in range(c):
            valid = (cn[ci] >= 0) & (cn[ci] < k)
            rule = rule + np.where(valid[:, None],
                                   wn[ci][np.clip(cn[ci], 0, k - 1)], 0)
        if w.dtype == torch.bfloat16:
            assert torch.equal(got, torch.from_numpy(rule).to(torch.bfloat16))
        elif c == 0 or w.storage_offset():
            assert np.array_equal(got.numpy(), rule)
        else:
            want = np.asarray(j_onehot_wide(jnp.asarray(cn), jnp.asarray(wn)))
            assert np.array_equal(got.numpy(), want), (c, n, k, f)


def test_reference_quirks_outside_range():
    """The jnp version the JAX package trains through does NOT follow the
    kernel outside [0, K): -1 wraps to the last row, past K gives NaN. The
    port follows the kernel (documented in ROADMAP Queue 3)."""
    w = np.arange(30, dtype=np.float32).reshape(2, 5, 3)
    codes = np.array([[0, 4, -1, 5, 7, -3], [1, 2, 3, 4, 0, 600]], np.int32)
    kernel = np.asarray(j_onehot_wide(jnp.asarray(codes), jnp.asarray(w)))
    jref = np.asarray(j_ref(jnp.asarray(codes), jnp.asarray(w)))
    assert np.array_equal(jref[2], w[0, 4] + w[1, 3])       # -1 wrapped
    assert np.isnan(jref[3]).all()                          # 5 >= K
    got = _port(codes, w).numpy()
    assert np.array_equal(got, kernel)
    assert np.array_equal(got[2], w[1, 3])
    assert np.array_equal(got[3], w[1, 4]) and not got[5].any()


def _jax_grad_kernel_rule(codes, w, g):
    """d/dw sum(out * g) for the kernel's function, by JAX autodiff through
    the jnp gather (in-range codes gathered, the rest masked to zero)."""
    k = w.shape[1]
    jc = jnp.asarray(codes)
    valid = (jc >= 0) & (jc < k)

    def f(w):
        rows = jnp.take_along_axis(w, jnp.clip(jc, 0, k - 1)[:, :, None],
                                   axis=1)
        return jnp.sum(jnp.where(valid[:, :, None], rows, 0).sum(0) * g)

    return np.asarray(jax.grad(f)(jnp.asarray(w)))


@pytest.mark.parametrize("c,n,k,f", SHAPES)
def test_backward_matches_jax_grad(c, n, k, f):
    codes, w, g = _inputs(c, n, k, f, seed=c + n + k)
    want = np.asarray(jax.grad(
        lambda w: jnp.sum(j_ref(jnp.asarray(codes), w) * g))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    (onehot_wide(torch.from_numpy(codes), wt) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    direct = ops.onehot_wide_backward(torch.from_numpy(codes),
                                      torch.from_numpy(g), k)
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-5, atol=1e-6)


def _port_grads(codes, w, g):
    """The port's gradient on the CPU, through ``onehot_wide_backward`` and
    through ``OneHotWide``'s backward."""
    direct = ops.onehot_wide_backward(torch.from_numpy(codes),
                                      torch.from_numpy(g), w.shape[1])
    wt = torch.from_numpy(w).requires_grad_(True)
    (onehot_wide(torch.from_numpy(codes), wt) * torch.from_numpy(g)).sum() \
        .backward()
    return direct.numpy(), wt.grad.numpy()


# the train shape, the JAX sweep's largest shape, and few codes over
# thousands of rows: (C, N, K, F)
BIT_SHAPES = [(2, 1024, 50, 1), (2, 256, 600, 128), (2, 4096, 4, 5),
              (3, 20000, 3, 2)]


@pytest.mark.parametrize("c,n,k,f", BIT_SHAPES)
def test_backward_equals_jax_grad_bit_for_bit(c, n, k, f):
    codes, w, g = _inputs(c, n, k, f, seed=c * k + n)
    want = np.asarray(jax.grad(
        lambda w: jnp.sum(j_ref(jnp.asarray(codes), w) * g))(jnp.asarray(w)))
    for got in _port_grads(codes, w, g):
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_backward_edge_grid_equals_jax_grad_bit_for_bit():
    """``test_edge_grid_small``'s grid (codes -1, K and both int32 ends
    among them): the port's gradient equals the kernel rule's ``jax.grad``
    bit for bit (``onehot_wide_ref`` itself wraps -1 and gives NaN past K;
    see ``test_reference_quirks_outside_range``)."""
    for codes, w, g in edge_cases.onehot_wide_cases(
            np.random.default_rng(0), "cpu", ks=(1, 4, 600)):
        cn, wn, gn = codes.numpy(), w.numpy(), g.numpy()
        want = _jax_grad_kernel_rule(cn, wn, gn)
        for got in _port_grads(cn, wn, gn):
            assert got.shape == want.shape and np.array_equal(got, want)


def test_backward_out_of_range_codes_get_no_gradient():
    c, n, k, f = 3, 200, 9, 4
    codes, w, g = _inputs(c, n, k, f, seed=5)
    codes[:, ::3] = np.array([-1, k, -(1 << 31)], np.int32)[:, None]
    codes[0, :k - 1] = np.arange(k - 1)   # every row but K-1 hit in column 0
    codes[0, 200 - 9:] = -1
    dw = ops.onehot_wide_backward(torch.from_numpy(codes),
                                  torch.from_numpy(g), k).numpy()
    np.testing.assert_allclose(dw, _jax_grad_kernel_rule(codes, w, g),
                               rtol=1e-5, atol=1e-6)
    hit = np.zeros((c, k), bool)
    for ci in range(c):
        hit[ci, codes[ci][(codes[ci] >= 0) & (codes[ci] < k)]] = True
    assert not dw[~hit].any()


def test_edge_grid_small():
    """C in {0, 1, 8}, N in {0, 1, 33, 1024}, K in {1, 4, 600}, F in
    {1, 129} with -1, K and both int32 ends among the codes (the card's
    edge set without its K = 65,537): forward, bf16 forward and backward
    against the kernel's rule computed independently in numpy, and no
    kernel launch on the CPU."""
    before = dict(ops.LAUNCHES)
    for codes, w, g in edge_cases.onehot_wide_cases(
            np.random.default_rng(0), "cpu", ks=(1, 4, 600)):
        c, k, f = w.shape
        n = codes.shape[1]
        cn, wn, gn = codes.numpy(), w.numpy(), g.numpy()
        valid = (cn >= 0) & (cn < k)
        want = np.zeros((n, f), np.float32)
        dw = np.zeros((c, k, f), np.float32)
        for ci in range(c):
            rows = np.where(valid[ci][:, None], wn[ci][np.clip(cn[ci], 0,
                                                               k - 1)], 0)
            want = want + rows
            np.add.at(dw[ci], cn[ci][valid[ci]], gn[valid[ci]])
        got = onehot_wide(codes, w)
        assert got.shape == (n, f) and np.array_equal(got.numpy(), want)
        got16 = onehot_wide(codes, w.to(torch.bfloat16))
        assert torch.equal(got16, ref.onehot_wide_ref(codes,
                                                      w.to(torch.bfloat16)))
        np.testing.assert_allclose(
            ops.onehot_wide_backward(codes, g, k).numpy(), dw, rtol=1e-5,
            atol=1e-6)
    assert ops.LAUNCHES == before


def test_backward_sum_bound_covers_reordering():
    """The card's tolerance for the gradient: two summation orders of the
    same terms (here forward and reversed rows) differ by no more than
    ``backward_sum_bound``, which is zero where a cell has one term."""
    rng = np.random.default_rng(3)
    k = 3
    codes = torch.from_numpy(rng.integers(-1, k + 1, (2, 4096))
                             .astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((4096, 5)).astype(np.float32))
    fwd = ref.onehot_wide_backward_ref(codes, g, k)
    rev = ref.onehot_wide_backward_ref(codes.flip(1), g.flip(0), k)
    bound = ref.backward_sum_bound(codes, g, k)
    assert (bound > 0).all()
    assert ((fwd - rev).abs() <= bound).all()
    one = torch.tensor([[0, 1]], dtype=torch.int32)
    assert not ref.backward_sum_bound(one, g[:2], 2).any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    codes = torch.zeros((2, 8), dtype=torch.int32)
    w = torch.zeros((2, 4, 3))
    with pytest.raises(TypeError):
        onehot_wide(codes.long(), w)
    with pytest.raises(TypeError):
        onehot_wide(codes, w.double())
    with pytest.raises(ValueError):
        onehot_wide(codes, w[:1])                     # C differs
    with pytest.raises(ValueError):
        onehot_wide(codes, torch.zeros((2, 0, 3)))    # K = 0
    with pytest.raises(ValueError):
        onehot_wide(torch.zeros((8, 2), dtype=torch.int32).t(), w)
    with pytest.raises(ValueError):
        onehot_wide(codes, torch.zeros((2, 12)))      # not 3-D
    with pytest.raises(TypeError):                    # gradient is f32 only
        ops.onehot_wide_backward(codes, torch.zeros((8, 3),
                                                    dtype=torch.bfloat16), 4)
    with pytest.raises(ValueError):
        ops.onehot_wide_backward(codes, torch.zeros((7, 3)), 4)


def test_autograd_wiring_and_empty_shapes():
    """``codes`` get no gradient, an empty C or N gives zeros, and the
    same Function serves bf16 forward."""
    w = torch.randn((0, 1, 2), requires_grad=True)
    out = onehot_wide(torch.zeros((0, 5), dtype=torch.int32), w)
    assert out.shape == (5, 2) and not out.any()
    out.sum().backward()
    assert w.grad.shape == (0, 1, 2)
    w = torch.randn((3, 4, 2), requires_grad=True)
    out = onehot_wide(torch.zeros((3, 0), dtype=torch.int32), w)
    assert out.shape == (0, 2)
    out.sum().backward()
    assert not w.grad.any()
    codes = torch.tensor([[1, 3]], dtype=torch.int32)
    w = torch.randn((1, 4, 2))
    assert torch.equal(onehot_wide(codes, w.bfloat16()),
                       w.bfloat16()[0, [1, 3]])
