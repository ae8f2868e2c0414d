from .classification import make_multi_level_ce
from .joint_sampling import (JointGraph, build_joint_graph,
                             sample_joint_negatives_np)
from .margin import variant_loss

__all__ = ["make_multi_level_ce", "JointGraph", "build_joint_graph",
           "sample_joint_negatives_np", "variant_loss"]
