from .embedder import (FeatCNN, FeatNet, LabelEmbedder, MatrixApproximation,
                       geometry_map, hyperbolic_init)
from .heads import HEADS, HierarchicalCNN
from .jax_import import (feat_net_from_jax, label_table_from_jax,
                         label_table_from_jax_checkpoint, state_dict_from_jax)
from .resnet import BACKBONES, ResNet, init_params_

__all__ = ["HEADS", "HierarchicalCNN", "state_dict_from_jax",
           "label_table_from_jax", "label_table_from_jax_checkpoint",
           "feat_net_from_jax", "FeatNet", "MatrixApproximation",
           "BACKBONES", "ResNet", "init_params_",
           "FeatCNN", "LabelEmbedder", "geometry_map", "hyperbolic_init"]
