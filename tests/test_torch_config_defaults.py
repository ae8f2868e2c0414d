"""The port's trainer configs against the JAX package's dataclasses: every
field that both have defaults to the same value, and the fields that only
one side has are exactly the expected ones:

* `device` (port only): the port's entry points run on the card
  (``"cuda"``) unless the caller asks for the CPU; JAX picks its device
  outside the config.
* `donate` (JAX only): buffer donation to the jitted step; the torch step
  updates parameters and optimizer state in place, so it has no
  counterpart.
* ClassifierConfig: `spatial_partition` (the images' H sharded over the
  mesh's 'model' axis) and `tp_patterns` (the head's tensor-parallel
  sharding) are on both sides with the same defaults.

One default differs by design: ClassifierConfig's `bn_impl` is 'pallas'
in the port (the fused reductions, the port's kernels K1 and K2) and
'flax' in the JAX package; its `dtype` is bfloat16 on both sides, spelt
`torch.bfloat16` and `jnp.bfloat16`.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from learning_embeddings_tpu.train.classifier import (
    ClassifierConfig as JaxClassifierConfig)
from learning_embeddings_tpu.train.embedding import (
    EmbeddingTrainerConfig as JaxEmbeddingConfig)
from learning_embeddings_tpu.train.joint import (
    JointTrainerConfig as JaxJointTrainerConfig)
from learning_embeddings_tpu.train.joint_cnn import (
    JointCNNConfig as JaxJointCNNConfig)
from learning_embeddings_tpu_torch.train.classifier import ClassifierConfig
from learning_embeddings_tpu_torch.train.embedding import (
    EmbeddingTrainerConfig)
from learning_embeddings_tpu_torch.train.joint import JointTrainerConfig
from learning_embeddings_tpu_torch.train.joint_cnn import JointCNNConfig

PAIRS = {"JointCNNConfig": (JointCNNConfig, JaxJointCNNConfig),
         "JointTrainerConfig": (JointTrainerConfig, JaxJointTrainerConfig),
         "EmbeddingTrainerConfig": (EmbeddingTrainerConfig,
                                    JaxEmbeddingConfig),
         "ClassifierConfig": (ClassifierConfig, JaxClassifierConfig)}
#: fields only the JAX config has, beyond `donate` (none since spatial
#: partitioning is ported)
JAX_ONLY = {}
#: (port, JAX) defaults that differ by design
DIFFERENT = {"ClassifierConfig": {"bn_impl": ("pallas", "flax")}}
#: the same value in the two frameworks' spellings
SAME_DTYPE = {(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)}


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
    differ = DIFFERENT.get(name, {})
    for k in sorted(shared):
        if k in differ:
            assert (port[k], ref[k]) == differ[k], (name, k)
        elif isinstance(port[k], torch.dtype):
            assert (port[k], ref[k]) in SAME_DTYPE, (name, k)
        else:
            assert port[k] == ref[k], (name, k, port[k], ref[k])


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_on_one_side_only(name):
    port, ref = map(_defaults, PAIRS[name])
    assert set(port) - set(ref) == {"device"}
    assert set(ref) - set(port) == {"donate"} | JAX_ONLY.get(name, set())
    assert port["device"] == "cuda"


def test_defaults_that_carry_the_workload():
    # the BASELINE workload's energy, and the label-only trainer's
    assert JointCNNConfig().energy == "hyp_cone"
    assert JointTrainerConfig().energy == "hyp_cone"
    cfg = EmbeddingTrainerConfig()
    assert (cfg.energy, cfg.optimizer) == ("hyp_cone", "rsgd")
