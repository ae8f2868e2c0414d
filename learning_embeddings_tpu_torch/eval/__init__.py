from .metrics import prf1_from_counts
from .ranking import joint_classification_metrics
from .reconstruction import reconstruction_metrics
from .threshold import (
    ThresholdMetrics,
    best_threshold_metrics,
    threshold_metrics,
)

__all__ = [
    "ThresholdMetrics",
    "best_threshold_metrics",
    "threshold_metrics",
    "reconstruction_metrics",
    "joint_classification_metrics",
    "prf1_from_counts",
]
