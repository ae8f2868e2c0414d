from .bn import (FlaxBatchNorm, FusedBatchNorm, GhostBatchNorm,
                 batch_norm_train, ghost_batch_norm_train, make_norm)
from .image import device_scale

__all__ = ["FusedBatchNorm", "GhostBatchNorm", "FlaxBatchNorm", "make_norm",
           "batch_norm_train", "ghost_batch_norm_train", "device_scale"]
