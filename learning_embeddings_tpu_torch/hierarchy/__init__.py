from .graph import label_graph_from_paths, transitive_closure
from .labelmap import (
    LabelMap,
    build_labelmap,
    butterfly200_labelmap,
    labelmap_from_records,
    toy_labelmap,
)

__all__ = [
    "LabelMap",
    "build_labelmap",
    "butterfly200_labelmap",
    "labelmap_from_records",
    "toy_labelmap",
    "label_graph_from_paths",
    "transitive_closure",
]
