"""Tensorboard-log → plot exporter: the port's copy of
``learning_embeddings_tpu/utils/tblog.py`` (the reference's `ConvertLog`,
network/convert_tblog.py:9-138): read scalar series from TB event files
(tensorboard imported only there) or from the ``logs/metrics.jsonl``
mirror that ``train/experiment.py::MetricsLogger`` writes, and render
per-metric plots (matplotlib imported only there), combinable across
experiments."""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["read_scalars", "read_jsonl_scalars", "export_plots"]


def read_scalars(logdir: str) -> Dict[str, List[Tuple[int, float]]]:
    """tag -> [(step, value)] from TB event files."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(logdir, size_guidance={"scalars": 0})
    acc.Reload()
    out: Dict[str, List[Tuple[int, float]]] = {}
    for tag in acc.Tags().get("scalars", []):
        out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


def read_jsonl_scalars(path: str) -> Dict[str, List[Tuple[int, float]]]:
    """Same shape from the MetricsLogger jsonl mirror."""
    out: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["tag"]].append((rec["step"], rec["value"]))
    return dict(out)


def export_plots(
    scalars_by_experiment: Dict[str, Dict[str, List[Tuple[int, float]]]],
    output_dir: str,
    tags: Optional[Sequence[str]] = None,
    fmt: str = "pdf",
) -> List[str]:
    """One plot per tag, all experiments overlaid (the reference's
    combinable-across-experiments export). Returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    all_tags = tags
    if all_tags is None:
        all_tags = sorted({t for s in scalars_by_experiment.values() for t in s})
    written = []
    for tag in all_tags:
        fig, ax = plt.subplots()
        found = False
        for exp_name, scalars in scalars_by_experiment.items():
            if tag not in scalars or not scalars[tag]:
                continue
            steps, values = zip(*sorted(scalars[tag]))
            ax.plot(steps, values, label=exp_name)
            found = True
        if not found:
            plt.close(fig)
            continue
        ax.set_title(tag)
        ax.set_xlabel("step")
        ax.legend()
        path = os.path.join(output_dir, tag.replace("/", "_") + f".{fmt}")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written
