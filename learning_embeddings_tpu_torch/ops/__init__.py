from .bn import FusedBatchNorm, batch_norm_train
from .image import device_scale

__all__ = ["FusedBatchNorm", "batch_norm_train", "device_scale"]
