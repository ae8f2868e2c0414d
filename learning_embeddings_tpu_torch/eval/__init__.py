from .metrics import (LevelMetrics, confusion_matrix,
                      hierarchical_match_counts, level_metrics_from_confusion,
                      multilevel_metrics, prf1_from_counts)
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
    "LevelMetrics",
    "confusion_matrix",
    "level_metrics_from_confusion",
    "multilevel_metrics",
    "hierarchical_match_counts",
]
