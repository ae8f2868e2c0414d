"""Label-only hyperbolic embedding CLI: the port of
``learning_embeddings_tpu/cli/order_embeddings_h.py`` (the same flags,
plus ``--device``): Poincaré-ball entailment cones with the conformal-adam
hybrid (default), Riemannian SGD (``--use_rsgd``) or Riemannian Adam
(``--use_radam``), and an optional cosine-embedding warm start.

    python -m learning_embeddings_tpu_torch.cli.order_embeddings_h \\
        --taxonomy butterfly200 --set_mode train --experiment_dir exp \\
        --experiment_name h --n_epochs 2 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..train.runner import run_label_embedding
from .common import manifest_from_args, process_group_from_env
from .order_embeddings import add_label_flags, label_config, label_splits


def build_parser():
    parser = argparse.ArgumentParser()
    add_label_flags(parser, default_loss="hyp_cones_loss")
    parser.add_argument("--use_rsgd", action="store_true",
                        help="Full Riemannian SGD instead of the "
                             "conformal-rescaled adam hybrid.")
    parser.add_argument("--use_radam", action="store_true",
                        help="Riemannian Adam: a manifold step with adam "
                             "moments.")
    parser.add_argument("--load_cosine_emb", type=str, default=None,
                        help="Path to 2-D cosine embeddings .npy warm start")
    return parser


def main(args=None):
    args = build_parser().parse_args(args)
    labelmap, splits = label_splits(args)
    cfg = label_config(args, "hyp_cone",
                       "rsgd" if args.use_rsgd
                       else "radam" if args.use_radam
                       else args.optimizer_method)
    warm_start = None
    if args.load_cosine_emb:
        warm_start = np.load(args.load_cosine_emb)

    with process_group_from_env(args.device):
        result = run_label_embedding(
            labelmap, splits, cfg,
            experiment_dir=args.experiment_dir,
            experiment_name=args.experiment_name,
            n_epochs=args.n_epochs,
            eval_interval=args.eval_interval,
            check_reconstr_every=args.check_reconstr_every,
            resume=args.resume,
            manifest_args=manifest_from_args(args),
            init_embeddings=warm_start,
        )
    print({k: v for k, v in result.items()
           if isinstance(v, (int, float, str))})
    return result


if __name__ == "__main__":
    main()
