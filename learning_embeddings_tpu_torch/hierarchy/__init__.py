from .graph import (
    EdgeSplits,
    edges_from_adjacency,
    label_graph_from_paths,
    negative_adjacency,
    split_edges,
    transitive_closure,
)
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
    "EdgeSplits",
    "edges_from_adjacency",
    "label_graph_from_paths",
    "negative_adjacency",
    "split_edges",
    "transitive_closure",
]
