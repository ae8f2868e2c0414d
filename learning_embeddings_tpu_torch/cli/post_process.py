"""Cross-level confusion report from a finished classifier experiment's
score dumps: the port of ``learning_embeddings_tpu/cli/post_process.py``
(the reference's network/post_process.py:16-117, over the
``stats/predicted_scores.npy`` and ``stats/correct_labels.npy`` that
``train/runner.py::run_classifier`` writes). The same flags and outputs;
no ``--device``: it only reads files (numpy; matplotlib for the plot).

    python -m learning_embeddings_tpu_torch.cli.post_process \\
        --experiment_path exp/run --predicted_level 0 --gt_level 3
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..eval.confusion import cross_level_confusion, plot_cross_level_confusion
from ..train.experiment import read_manifest
from .common import DEFAULT_DATA_DIR, load_ethec_data


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, required=True)
    parser.add_argument("--predicted_level", type=int, default=0)
    parser.add_argument("--gt_level", type=int, default=3)
    return parser


def main(args=None):
    args = build_parser().parse_args(args)

    stats = os.path.join(args.experiment_path, "stats")
    scores = np.load(os.path.join(stats, "predicted_scores.npy"))
    ll = np.load(os.path.join(stats, "correct_labels.npy"))
    manifest = read_manifest(os.path.join(args.experiment_path,
                                          "config_params.txt"))
    labelmap, _, _ = load_ethec_data(
        manifest.get("data_dir", DEFAULT_DATA_DIR),
        manifest.get("debug", "False") == "True")

    m, row_order, col_order = cross_level_confusion(
        scores, ll, labelmap, pred_level=args.predicted_level,
        gt_level=args.gt_level)
    out = os.path.join(
        stats, f"confusion_p{args.predicted_level}_g{args.gt_level}.png")
    plot_cross_level_confusion(
        m, out,
        title=f"pred L{args.predicted_level} vs gt L{args.gt_level}")
    if m.shape[0] == m.shape[1]:
        acc = float(np.trace(m) / max(m.sum(), 1))
        print(f"wrote {out}; weighted accuracy {acc:.4f}")
    else:
        print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
