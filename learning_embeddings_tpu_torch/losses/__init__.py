from .classification import (hierarchical_softmax_nll, make_hierarchical_softmax,
                             make_last_level_ce, make_masked_ce,
                             make_multi_level_ce, multi_label_soft_margin)
from .joint_sampling import (JointGraph, build_joint_graph,
                             sample_joint_negatives_np)
from .margin import (NegativeSampler, make_negative_sampler, margin_loss,
                     variant_loss)

__all__ = ["make_multi_level_ce", "make_last_level_ce", "make_masked_ce",
           "multi_label_soft_margin", "make_hierarchical_softmax",
           "hierarchical_softmax_nll", "JointGraph", "build_joint_graph",
           "sample_joint_negatives_np", "variant_loss", "margin_loss",
           "NegativeSampler", "make_negative_sampler"]
