"""The port's ResNet + multi_head HierarchicalCNN against the JAX package's
(bn_impl='pallas', float32) on the CPU, from weights carried over with
models/jax_import.py: logits in train and eval mode and the updated
running statistics, for resnet18 and resnet50."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from learning_embeddings_tpu.models.heads import HierarchicalCNN as JaxCNN
from learning_embeddings_tpu_torch.models import HierarchicalCNN
from learning_embeddings_tpu_torch.models import state_dict_from_jax

torch.set_num_threads(2)

LEVELS = (3, 9, 27)
STAGES = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}


def _perturbed(tree, rng, kind):
    """Move BatchNorm scale/bias and running stats off their init values
    so that the comparison sees them."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if kind == "params" and "scale" in out:
            n = out["scale"].shape
            out["scale"] = (1 + 0.2 * rng.randn(*n)).astype(np.float32)
            out["bias"] = (0.1 * rng.randn(*n)).astype(np.float32)
        if kind == "stats" and "mean" in out:
            n = out["mean"].shape
            out["mean"] = (0.1 * rng.randn(*n)).astype(np.float32)
            out["var"] = (0.5 + rng.rand(*n)).astype(np.float32)
        return out
    return walk(tree)


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def pair(request):
    backbone = request.param
    jm = JaxCNN(backbone=backbone, levels=LEVELS, dtype=jnp.float32,
                bn_impl="pallas")
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.RandomState(0)
    params = _perturbed(jax.tree_util.tree_map(np.asarray,
                                               dict(variables["params"])),
                        rng, "params")
    stats = _perturbed(jax.tree_util.tree_map(
        np.asarray, dict(variables["batch_stats"])), rng, "stats")

    model = HierarchicalCNN(backbone, LEVELS, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params, stats, STAGES[backbone]),
                          strict=True)
    model.to(memory_format=torch.channels_last)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    return backbone, jm, params, stats, model, x


def _port_forward(model, x):
    return model(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()


def test_eval_logits_match(pair):
    _, jm, params, stats, model, x = pair
    apply = jax.jit(functools.partial(jm.apply, train=False))
    ref = apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    got = _port_forward(model.eval(), x)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_train_logits_and_running_stats_match(pair):
    backbone, jm, params, stats, model, x = pair
    apply = jax.jit(functools.partial(jm.apply, train=True,
                                      mutable=["batch_stats"]))
    ref, mutated = apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x))
    model.load_state_dict(state_dict_from_jax(params, stats,
                                              STAGES[backbone]))
    got = _port_forward(model.train(), x)
    # resnet50 in train mode is ill-conditioned in f32: the Σx²/R − mean²
    # statistics of 53 BatchNorm layers cancel, and against a float64
    # evaluation of the same network the JAX logits are off by up to 9e-4
    # (the port's by 2.3e-4) at this input; resnet18 stays within 3e-5
    tol = 1e-4 if backbone == "resnet18" else 2e-3
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)

    want = state_dict_from_jax(params, jax.device_get(mutated["batch_stats"]),
                               STAGES[backbone])
    have = model.state_dict()
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (20 if backbone == "resnet18" else 53)
    # the same f32 conditioning reaches the deep layers' batch statistics
    rtol, atol = (1e-4, 1e-5) if backbone == "resnet18" else (1e-3, 2e-4)
    for k in names:
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)
