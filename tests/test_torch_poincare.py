"""The port's Poincaré-ball operations against the JAX package's on the CPU:
values, and the gradients of Σ w·f(x) from torch.autograd against
jax.grad, on seeded rows inside the annulus, below its inner radius r0,
above the unit norm, and exactly at 0.

Tolerances: values rel 1e-6 / abs 1e-7 (the same f32 operations, sums
over the last axis in another order); gradients rel 1e-5 of the largest
entry. Where a clamp sits exactly at its bound (the zero row's norm floor
in `mobius_add`, the ±(1 − 1e−5) clamp of `arctanh`, arccosh at 1) only
values are compared: jnp.clip/maximum and torch.clamp split the gradient
at a tie differently."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.geometry import poincare as jp
from learning_embeddings_tpu_torch.geometry import poincare as tp

K = 0.1
R0 = tp.inner_radius(K)
D = 5


def _rows(seed, radii):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(radii), D)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (x * np.asarray(radii)[:, None]).astype(np.float32)


#: below r0, in the annulus, near its outer edge, above 1
RADII = [0.02, 0.08, 0.3, 0.6, 0.9, 0.99, 1.3, 2.0]


def ball(seed):
    return _rows(seed, RADII)


def with_zero(x):
    return np.concatenate([x, np.zeros((1, D), np.float32)])


def _weights(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def check(jfn, tfn, *arrays, grad=True):
    """Values of both; with `grad`, the gradients of Σ w·f w.r.t. every
    input."""
    want = np.asarray(jfn(*map(jnp.asarray, arrays)))
    ts = [torch.tensor(a, requires_grad=grad) for a in arrays]
    got = tfn(*ts)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    if not grad:
        return
    w = _weights(want.shape)
    jgrads = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * w),
                      argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


def test_arctanh():
    x = np.linspace(-0.999, 0.999, 41).astype(np.float32)
    check(jp.arctanh, tp.arctanh, x)
    # past and exactly at the ±(1 − 1e−5) clamp: values only
    edge = np.float32([-3.0, -1.0, -(1 - 1e-5), 1 - 1e-5, 1.0, 2.5])
    check(jp.arctanh, tp.arctanh, edge, grad=False)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_project_annulus(eps):
    check(lambda x: jp.project_annulus(x, R0, eps),
          lambda x: tp.project_annulus(x, R0, eps), with_zero(ball(0)))


def test_project_annulus_scale_carries_no_gradient():
    x = torch.tensor(ball(1), requires_grad=True)
    tp.project_annulus(x, R0).sum().backward()
    n = np.linalg.norm(ball(1), axis=1, keepdims=True)
    scale = np.where(n <= R0, R0 / n, np.where(n >= 1, (1 - 1e-5) / n, 1.0))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.broadcast_to(scale, x.shape), rtol=1e-6)


@pytest.mark.parametrize("v_offset", [1e-6, 1e-15])
def test_mobius_add(v_offset):
    u, v = ball(2), 0.5 * ball(3)
    check(lambda a, b: jp.mobius_add(a, b, R0, v_offset),
          lambda a, b: tp.mobius_add(a, b, R0, v_offset), u, v)
    # a zero u and a zero v row: values only (the zero row's norm floor)
    check(lambda a, b: jp.mobius_add(a, b, R0, v_offset),
          lambda a, b: tp.mobius_add(a, b, R0, v_offset),
          with_zero(u), with_zero(v), grad=False)


def test_lambda_x():
    # norms off 1, where λ has its pole
    check(jp.lambda_x, tp.lambda_x, with_zero(ball(4)))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_exp_map_x(scale):
    """Small, unit and large tangents: the last reaches the ±15 clamp."""
    x = _rows(5, [0.1, 0.2, 0.5, 0.8, 0.95, 0.999])
    v = scale * np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    check(lambda a, b: jp.exp_map_x(a, b, R0),
          lambda a, b: tp.exp_map_x(a, b, R0), x, v)


def test_exp_map_x_zero_tangent():
    x = ball(7)
    check(lambda a, b: jp.exp_map_x(a, b, R0),
          lambda a, b: tp.exp_map_x(a, b, R0), x, np.zeros_like(x))


def test_exp_map_zero_shifted():
    x = with_zero(3.0 * np.random.RandomState(8).randn(8, D)
                  .astype(np.float32))
    check(lambda a: jp.exp_map_zero_shifted(a, R0),
          lambda a: tp.exp_map_zero_shifted(a, R0), x)
    check(lambda a: jp.exp_map_zero_shifted(a, R0),
          lambda a: tp.exp_map_zero_shifted(a, R0), ball(9))


def test_poincare_distance():
    x, y = _rows(10, [0.05, 0.3, 0.6, 0.9]), _rows(11, [0.2, 0.5, 0.1, 0.95])
    check(jp.poincare_distance, tp.poincare_distance, x, y)
    # equal points: arccosh at its clamp, values only
    check(jp.poincare_distance, tp.poincare_distance, x, x, grad=False)


def test_geometry_exports():
    from learning_embeddings_tpu_torch import geometry

    for name in jp.__all__:
        assert getattr(geometry, name) is getattr(tp, name), name


@pytest.mark.parametrize("mode", ["hyp_cone", "hyp_cone_exp0"])
def test_geometry_map_hyperbolic_modes(mode):
    """The label table's and image tower's post-maps, values and
    gradients, on rows inside, below and above the annulus."""
    from learning_embeddings_tpu.models.embedder import geometry_map as jgm
    from learning_embeddings_tpu_torch.models.embedder import (
        geometry_map as tgm)

    check(lambda x: jgm(x, mode, K), lambda x: tgm(x, mode, K), ball(12))
    check(lambda x: jgm(x, mode, K), lambda x: tgm(x, mode, K),
          with_zero(ball(13)), grad=False)


def test_label_embedder_hyperbolic_modes_match_jax():
    from learning_embeddings_tpu.models.embedder import (
        LabelEmbedder as JaxLabelEmbedder)
    from learning_embeddings_tpu_torch.models import (LabelEmbedder,
                                                      label_table_from_jax)

    for mode in ("hyp_cone", "hyp_cone_exp0"):
        je = JaxLabelEmbedder(n_nodes=9, dim=4, mode=mode, K=K)
        v = je.init(jax.random.PRNGKey(2), jnp.zeros((1,), jnp.int32))
        pe = LabelEmbedder(9, 4, mode=mode, K=K,
                           generator=torch.Generator().manual_seed(0))
        # both start at row norms r0 + U[0, 0.05]
        for t in (np.asarray(v["params"]["embedding"]),
                  pe.embedding.detach().numpy()):
            n = np.linalg.norm(t, axis=1)
            assert (n >= R0 - 1e-6).all() and (n <= R0 + 0.05 + 1e-6).all()
        pe.load_state_dict(label_table_from_jax(jax.device_get(v)))
        ids = np.array([0, 3, 8, 3])
        with torch.no_grad():
            got = pe(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(je.apply(v, jnp.asarray(ids, jnp.int32))),
            rtol=1e-6, atol=1e-7)
