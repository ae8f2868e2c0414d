"""The port's Riemannian optimizers against the JAX package's optax
transforms on the CPU: the same table on the ball and the same sequence of
gradients, 1 and 5 steps of RiemannianSGD, RiemannianAdam and the hybrid
(conformal rescale, then a stock Adam or momentum-SGD step, then the
annulus projection), and the lr schedules reaching both Riemannian
optimizers through torch.optim.lr_scheduler (after tests/test_rsgd.py).

Tolerance: the table after the steps within abs 1e-6 (f32 rounding of the
same formulas; torch's Adam and optax's adam order their divisions
differently). The lr is 0.01: at 0.05 five steps push rows of this table
to the outer edge of the annulus, where λ = 2/(1 − ‖w‖) has its pole, and
the same rounding differences grow to 7e-6 there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from learning_embeddings_tpu.optim import rsgd as jr
from learning_embeddings_tpu_torch.geometry import inner_radius
from learning_embeddings_tpu_torch.optim import (
    RiemannianAdam, RiemannianSGD, project_annulus_,
    scale_by_conformal_factor_)

K = 0.1
R0 = inner_radius(K)


def ball_points(n, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x * rng.uniform(R0, 0.9, (n, 1)).astype(np.float32)


def grads(n_steps, shape, seed=1):
    rng = np.random.RandomState(seed)
    return [(0.5 * rng.randn(*shape)).astype(np.float32)
            for _ in range(n_steps)]


def run_optax(tx, w, gs, project):
    params = {"e": jnp.asarray(w)}
    state = tx.init(params)
    for g in gs:
        updates, state = tx.update({"e": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        if project:
            params = jr.project_annulus_tree(params, K)
    return np.asarray(params["e"])


def run_torch(make_opt, w, gs, *, conformal=False, project=False,
              lr_lambda=None):
    p = torch.nn.Parameter(torch.tensor(w))
    opt = make_opt([p])
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda)
             if lr_lambda else None)
    for g in gs:
        opt.zero_grad()
        p.grad = torch.tensor(g)
        if conformal:
            scale_by_conformal_factor_([p])
        opt.step()
        if sched:
            sched.step()
        if project:
            project_annulus_([p], K)
    return p.detach().numpy()


LR = 0.01
CASES = {
    # name: (optax transform, torch optimizer, conformal, project)
    "rsgd": (lambda lr: jr.riemannian_sgd(lr, K),
             lambda ps, lr: RiemannianSGD(ps, lr=lr, K=K), False, False),
    "radam": (lambda lr: jr.riemannian_adam(lr, K),
              lambda ps, lr: RiemannianAdam(ps, lr=lr, K=K), False, True),
    "hybrid_adam": (
        lambda lr: optax.chain(jr.scale_by_conformal_factor(),
                               optax.adam(lr)),
        lambda ps, lr: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8), True, True),
    "hybrid_sgd": (
        lambda lr: optax.chain(jr.scale_by_conformal_factor(),
                               optax.sgd(lr, momentum=0.9)),
        lambda ps, lr: torch.optim.SGD(ps, lr=lr, momentum=0.9), True,
        True),
}


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_optax(name, n_steps):
    jtx, topt, conformal, project = CASES[name]
    w = ball_points(16, 8, seed=0)
    gs = grads(n_steps, w.shape)
    want = run_optax(jtx(LR), w, gs, project)
    got = run_torch(lambda ps: topt(ps, LR), w, gs, conformal=conformal,
                    project=project)
    assert not np.allclose(want, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    norms = np.linalg.norm(got, axis=1)
    assert (norms >= R0 - 1e-6).all() and (norms < 1.0).all()


@pytest.mark.parametrize("name", ["rsgd", "radam"])
def test_lr_schedule_reaches_riemannian_optimizers(name):
    """A piecewise-constant schedule (×0.1 from step 2) through LambdaLR
    moves the same table as the optax schedule does, and differs from the
    constant lr."""
    jtx, topt, _, project = CASES[name]
    w = ball_points(8, 4, seed=2)
    gs = grads(5, w.shape, seed=3)
    sched = optax.piecewise_constant_schedule(0.1, {2: 0.1})
    want = run_optax(jtx(sched), w, gs, project)
    got = run_torch(lambda ps: topt(ps, 0.1), w, gs, project=project,
                    lr_lambda=lambda k: 0.1 ** (k >= 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    constant = run_torch(lambda ps: topt(ps, 0.1), w, gs, project=project)
    assert not np.allclose(got, constant, atol=1e-4)


def test_lr_lives_in_param_groups():
    p = torch.nn.Parameter(torch.tensor(ball_points(4, 3, seed=4)))
    for opt in (RiemannianSGD([p], lr=0.1, K=K),
                RiemannianAdam([p], lr=0.1, K=K)):
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
        p.grad = torch.ones_like(p)
        opt.step()
        sched.step()
        assert opt.param_groups[0]["lr"] == pytest.approx(0.05)
        assert opt.param_groups[0]["K"] == K


def test_radam_state_dict_round_trip():
    w = ball_points(6, 3, seed=5)
    gs = grads(4, w.shape, seed=6)
    p = torch.nn.Parameter(torch.tensor(w))
    opt = RiemannianAdam([p], lr=0.05, K=K)
    for g in gs[:2]:
        p.grad = torch.tensor(g)
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = RiemannianAdam([q], lr=0.05, K=K)
    opt2.load_state_dict(opt.state_dict())
    for g in gs[2:]:
        for param, o in ((p, opt), (q, opt2)):
            param.grad = torch.tensor(g)
            o.step()
    assert torch.equal(p, q)
    assert opt.state[p]["step"] == 4
