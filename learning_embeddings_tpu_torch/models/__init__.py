from .heads import HEADS, HierarchicalCNN
from .jax_import import state_dict_from_jax
from .resnet import BACKBONES, ResNet, init_params_

__all__ = ["HEADS", "HierarchicalCNN", "state_dict_from_jax", "BACKBONES",
           "ResNet", "init_params_"]
