"""The port's trainer configs against the JAX package's dataclasses: every
field that both have defaults to the same value, and the fields that only
one side has are exactly the expected ones:

* `device` (port only): the port's entry points run on the card
  (``"cuda"``) unless the caller asks for the CPU; JAX picks its device
  outside the config.
* `donate` (JAX only): buffer donation to the jitted step; the torch step
  updates parameters and optimizer state in place, so it has no
  counterpart.
"""

import dataclasses

import pytest

from learning_embeddings_tpu.train.embedding import (
    EmbeddingTrainerConfig as JaxEmbeddingConfig)
from learning_embeddings_tpu.train.joint import (
    JointTrainerConfig as JaxJointTrainerConfig)
from learning_embeddings_tpu.train.joint_cnn import (
    JointCNNConfig as JaxJointCNNConfig)
from learning_embeddings_tpu_torch.train.embedding import (
    EmbeddingTrainerConfig)
from learning_embeddings_tpu_torch.train.joint import JointTrainerConfig
from learning_embeddings_tpu_torch.train.joint_cnn import JointCNNConfig

PAIRS = {"JointCNNConfig": (JointCNNConfig, JaxJointCNNConfig),
         "JointTrainerConfig": (JointTrainerConfig, JaxJointTrainerConfig),
         "EmbeddingTrainerConfig": (EmbeddingTrainerConfig,
                                    JaxEmbeddingConfig)}


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_shared_defaults_equal_jax(name):
    port, ref = map(_defaults, PAIRS[name])
    shared = set(port) & set(ref)
    assert shared, name
    for k in sorted(shared):
        assert port[k] == ref[k], (name, k, port[k], ref[k])


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_on_one_side_only(name):
    port, ref = map(_defaults, PAIRS[name])
    assert set(port) - set(ref) == {"device"}
    assert set(ref) - set(port) == {"donate"}
    assert port["device"] == "cuda"


def test_defaults_that_carry_the_workload():
    # the BASELINE workload's energy, and the label-only trainer's
    assert JointCNNConfig().energy == "hyp_cone"
    assert JointTrainerConfig().energy == "hyp_cone"
    cfg = EmbeddingTrainerConfig()
    assert (cfg.energy, cfg.optimizer) == ("hyp_cone", "rsgd")
