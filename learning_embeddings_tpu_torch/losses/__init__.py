from .classification import make_multi_level_ce
from .joint_sampling import (JointGraph, build_joint_graph,
                             sample_joint_negatives_np)
from .margin import (NegativeSampler, make_negative_sampler, margin_loss,
                     variant_loss)

__all__ = ["make_multi_level_ce", "JointGraph", "build_joint_graph",
           "sample_joint_negatives_np", "variant_loss", "margin_loss",
           "NegativeSampler", "make_negative_sampler"]
