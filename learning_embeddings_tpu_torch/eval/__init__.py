from .confusion import cross_level_confusion
from .metrics import (LevelMetrics, confusion_matrix,
                      hierarchical_match_counts, level_metrics_from_confusion,
                      multilevel_metrics, prf1_from_counts)
from .multilabel import (multilabel_metrics, per_class_pr,
                         tune_per_class_thresholds, tune_single_threshold)
from .ranking import joint_classification_metrics
from .reconstruction import reconstruction_metrics
from .reports import Summarize
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
    "multilabel_metrics",
    "per_class_pr",
    "tune_per_class_thresholds",
    "tune_single_threshold",
    "Summarize",
    "cross_level_confusion",
]
