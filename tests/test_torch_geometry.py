"""The port's energies and all-pairs energies against the JAX package on
the CPU: the elementwise energies with their clamps, the plain version of
the order-energy kernel (K3) against the Pallas kernel in interpret mode
and the JAX package's XLA version, and the Gram-matrix cone forms. The CUDA
kernel itself is held against the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from learning_embeddings_tpu.geometry import energies as jax_energies
from learning_embeddings_tpu.geometry import pairwise as jax_pairwise
from learning_embeddings_tpu_torch.geometry import energies, pairwise
from learning_embeddings_tpu_torch.ops import pairwise_order as k3

torch.set_num_threads(2)

K3_SHAPES = [(1, 1, 1), (37, 129, 10), (130, 7, 3), (5, 300, 131)]


def _pair_inputs(rng, n=64, d=5, ball=False):
    """Random pairs plus the degenerate ones the floors and clamps guard:
    x == y, x == 0, y == 0."""
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, d).astype(np.float32)
    if ball:   # points inside the Poincaré ball
        x *= 0.9 / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1)
        y *= 0.9 / np.maximum(np.linalg.norm(y, axis=1, keepdims=True), 1)
        x *= rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32)
        y *= rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32)
    else:      # norms above the cone aperture K = 3 for half the rows
        x[: n // 2] *= 3.0
    y[0] = x[0]
    x[1] = 0.0
    y[2] = 0.0
    return x, y


@pytest.mark.parametrize("name", ["order", "euc_cone", "hyp_cone"])
def test_elementwise_energies_match_jax(name):
    rng = np.random.RandomState(0)
    x, y = _pair_inputs(rng, ball=(name == "hyp_cone"))
    fn = {"order": "order_energy", "euc_cone": "euc_cone_energy",
          "hyp_cone": "hyp_cone_energy"}[name]
    got = getattr(energies, fn)(torch.from_numpy(x), torch.from_numpy(y))
    ref = np.asarray(getattr(jax_energies, fn)(jnp.asarray(x),
                                               jnp.asarray(y)))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # f32 sums in another order; acos near its ±(1 − 1e-5) clamp has a
    # slope up to ~220, which turns an f32 rounding of its argument
    # (~1e-7) into ~2e-5 of the angle: hence the hyperbolic atol
    atol = 5e-5 if name == "hyp_cone" else 1e-6
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol)


def test_constants_match_jax():
    assert energies.EUC_CONE_K == jax_energies.EUC_CONE_K
    assert energies.HYP_CONE_K == jax_energies.HYP_CONE_K
    assert energies._TINY == jax_energies._TINY
    assert energies._CLAMP == jax_energies._CLAMP
    for K in (0.1, 3.0):
        assert energies.inner_radius(K) == jax_energies.inner_radius(K)


def _order_tolerance(u, v):
    """|plain − reference| ≤ 1e-5·Σ_d terms + 1e-6: the two sum the same
    f32 terms in another order."""
    diff = np.maximum(u[:, None, :] - v[None, :, :], 0.0)
    return 1e-5 * (diff * diff).sum(-1) + 1e-6


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_pairwise_order_plain_matches_pallas_interpret(shape):
    m, n, d = shape
    rng = np.random.RandomState(m + n + d)
    # integer-valued inputs: every partial sum is exact in f32
    ui = rng.randint(-3, 4, (m, d)).astype(np.float32)
    vi = rng.randint(-3, 4, (n, d)).astype(np.float32)
    got = k3.pairwise_order(torch.from_numpy(ui), torch.from_numpy(vi))
    ref = np.asarray(jax_pairwise._pairwise_order_pallas(
        jnp.asarray(ui), jnp.asarray(vi), interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)

    u = rng.randn(m, d).astype(np.float32)
    v = rng.randn(n, d).astype(np.float32)
    got = k3.pairwise_order(torch.from_numpy(u), torch.from_numpy(v))
    ref = np.asarray(jax_pairwise._pairwise_order_pallas(
        jnp.asarray(u), jnp.asarray(v), interpret=True))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert (np.abs(got.numpy() - ref) <= _order_tolerance(u, v)).all()


@pytest.mark.parametrize("shape", K3_SHAPES + [(0, 5, 3)], ids=str)
def test_pairwise_order_plain_matches_jax_xla(shape):
    m, n, d = shape
    rng = np.random.RandomState(7 + m + n + d)
    u = rng.randn(m, d).astype(np.float32)
    v = rng.randn(n, d).astype(np.float32)
    got = pairwise.pairwise_order_energy(torch.from_numpy(u),
                                         torch.from_numpy(v))
    ref = np.asarray(jax_pairwise.pairwise_order_energy(
        jnp.asarray(u), jnp.asarray(v), use_pallas=False))
    assert got.shape == ref.shape == (m, n)
    assert (np.abs(got.numpy() - ref) <= _order_tolerance(u, v)).all()


def test_pairwise_order_casts_to_f32():
    rng = np.random.RandomState(3)
    u = torch.from_numpy(rng.randn(9, 4)).to(torch.bfloat16)
    v = torch.from_numpy(rng.randn(6, 4)).to(torch.bfloat16)
    got = k3.pairwise_order(u, v)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, k3.pairwise_order(u.float(), v.float()),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="expected u"):
        k3.pairwise_order(u, v[:, :3])


@pytest.mark.parametrize("kind", ["euc_cone", "hyp_cone"])
def test_gram_cone_energies_match_jax(kind):
    rng = np.random.RandomState(5)
    d = 6
    if kind == "hyp_cone":
        u = rng.randn(23, d).astype(np.float32)
        v = rng.randn(31, d).astype(np.float32)
        u *= (rng.uniform(0.2, 0.9, (23, 1))
              / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
        v *= (rng.uniform(0.2, 0.9, (31, 1))
              / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    else:
        u = 2.0 * rng.randn(23, d).astype(np.float32)
        v = 2.0 * rng.randn(31, d).astype(np.float32)
    # no pair with x == y here: there the Gram forms of both packages
    # divide a rounding residue of x·y − ‖x‖² by the 1e-12 floor
    got = pairwise.pairwise_energy(kind, torch.from_numpy(u),
                                   torch.from_numpy(v))
    ref = np.asarray(jax_pairwise.pairwise_energy(kind, jnp.asarray(u),
                                                  jnp.asarray(v)))
    assert got.shape == (23, 31) and torch.isfinite(got).all()
    # a Gram-matrix product in another summation order, then acos/asin
    # near their clamps (slope up to ~220): see the elementwise test
    atol = 5e-5 if kind == "hyp_cone" else 1e-5
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=atol)


def test_pairwise_energy_dispatches_order_to_k3():
    rng = np.random.RandomState(9)
    u = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    v = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    torch.testing.assert_close(pairwise.pairwise_energy("order", u, v),
                               k3.pairwise_order_plain(u, v))


def test_pairwise_order_raises_off_cpu_and_cuda():
    u = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no path"):
        k3.pairwise_order(u, u)
