"""Taxonomy graph statistics + D3 force-graph export: the port's copy of
``learning_embeddings_tpu/hierarchy/stats.py`` (numpy, on the port's
``LabelMap``). Counterpart of `data/graph_stats.py` (:9-164): node/edge
counts, degree extremes, and the `graph_for_d3*.json` payload of a
force-directed browser."""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

__all__ = ["graph_stats", "export_d3_json"]


def graph_stats(labelmap, sample_counts: Optional[np.ndarray] = None) -> Dict:
    """Counts + degree extremes of the taxonomy tree (graph_stats.py:9-80).
    sample_counts: optional (n_classes,) per-node specimen counts."""
    A = labelmap.full_child_mask()
    out_deg = A.sum(axis=1)
    in_deg = A.sum(axis=0)
    stats = {
        "n_nodes": int(labelmap.n_classes),
        "n_edges": int(A.sum()),
        "levels": list(labelmap.levels),
        "max_out_degree": int(out_deg.max()),
        "max_out_degree_node": labelmap.ix_to_name[
            labelmap.level_of_global()[int(out_deg.argmax())]][
            int(out_deg.argmax()
                - labelmap.level_start[labelmap.level_of_global()[
                    int(out_deg.argmax())]])],
        "max_in_degree": int(in_deg.max()),
        "per_level_branching": [
            float(labelmap.child_masks[l].sum(axis=1).mean())
            for l in range(labelmap.n_levels - 1)
        ],
    }
    if sample_counts is not None:
        stats["samples_total"] = int(np.sum(sample_counts))
    return stats


def export_d3_json(labelmap, path: str,
                   sample_counts: Optional[np.ndarray] = None) -> dict:
    """{nodes: [{id, name, level, count}], links: [{source, target}]} for a
    force-directed browser (graph_for_d3 payload, graph_stats.py:90-164)."""
    lvl = labelmap.level_of_global()
    nodes = []
    for g in range(labelmap.n_classes):
        l = int(lvl[g])
        nodes.append({
            "id": int(g),
            "name": labelmap.ix_to_name[l][g - int(labelmap.level_start[l])],
            "level": l,
            "count": int(sample_counts[g]) if sample_counts is not None else 0,
        })
    u, v = np.nonzero(labelmap.full_child_mask())
    links = [{"source": int(a), "target": int(b)} for a, b in zip(u, v)]
    payload = {"nodes": nodes, "links": links}
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload
