"""Scalar-log → per-metric plot exporter: the port of
``learning_embeddings_tpu/cli/convert_tblog.py`` (the reference's
``ConvertLog``: per-metric train/val/test PDF plots, combinable across
experiments). Reads each experiment's ``logs/metrics.jsonl`` (the
``MetricsLogger`` mirror), else its tensorboard event files. The same
flags; no ``--device``: it only reads files.

    python -m learning_embeddings_tpu_torch.cli.convert_tblog \\
        --experiment_path exp/a [exp/b ...] --output_dir plots/ [--fmt pdf]
"""

from __future__ import annotations

import argparse
import os

from ..utils.tblog import export_plots, read_jsonl_scalars, read_scalars


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, nargs="+",
                        required=True,
                        help="One or more experiment dirs; multiple dirs "
                             "are overlaid per metric.")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--fmt", type=str, default="pdf")
    parser.add_argument("--tags", type=str, nargs="*", default=None)
    return parser


def main(args=None):
    args = build_parser().parse_args(args)

    per_exp = {}
    for path in args.experiment_path:
        name = os.path.basename(path.rstrip("/"))
        jsonl = os.path.join(path, "logs", "metrics.jsonl")
        if os.path.exists(jsonl):
            per_exp[name] = read_jsonl_scalars(jsonl)
        else:
            per_exp[name] = read_scalars(os.path.join(path, "logs"))
    written = export_plots(per_exp, args.output_dir, tags=args.tags,
                           fmt=args.fmt)
    print(f"wrote {len(written)} plots to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
