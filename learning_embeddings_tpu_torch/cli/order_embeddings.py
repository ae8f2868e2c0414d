"""Label-only Euclidean embedding CLI: the port of
``learning_embeddings_tpu/cli/order_embeddings.py`` (the same flags, plus
``--device``). With ``--loss order_emb_loss`` its reconstruction takes the
all-pairs order energy, on the card the kernel of ``ops/pairwise_order.py``.

    python -m learning_embeddings_tpu_torch.cli.order_embeddings \\
        --loss order_emb_loss --taxonomy butterfly200 --set_mode train \\
        --experiment_dir exp --experiment_name order --n_epochs 5
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from ..hierarchy import label_graph_from_paths, split_edges
from ..train.embedding import EmbeddingTrainerConfig
from ..train.runner import run_label_embedding
from .common import add_common_flags, load_ethec_data, manifest_from_args

LOSS_MAP = {
    "order_emb_loss": "order",
    "euc_emb_loss": "euc_cone",
    "euc_cones_loss": "euc_cone",
}


def add_label_flags(parser: argparse.ArgumentParser,
                    default_loss: Optional[str] = None) -> None:
    """The flags both label-only CLIs share; `--loss` is required
    unless `default_loss` is given."""
    add_common_flags(parser)
    parser.add_argument("--embedding_dim", type=int, default=10)
    parser.add_argument("--neg_to_pos_ratio", type=int, default=5)
    parser.add_argument("--alpha", help="Margin alpha.", type=float, default=0.05)
    parser.add_argument("--prop_of_nb_edges", type=float, default=0.9,
                        help="Proportion of non-basic edges added to train.")
    parser.add_argument("--loss", type=str, required=default_loss is None,
                        default=default_loss,
                        help="[order_emb_loss, euc_cones_loss]")
    parser.add_argument("--pick_per_level", action="store_true")
    parser.add_argument("--taxonomy", type=str, default="ethec",
                        choices=("ethec", "butterfly200"),
                        help="butterfly200: label-only embedding on the "
                             "frozen 5/23/116/200 taxonomy (no dataset "
                             "json needed)")
    parser.add_argument("--graph_from", type=str, default="train",
                        choices=("train", "all"),
                        help="Build the label graph from the train split or "
                             "from all splits.")
    parser.add_argument("--check_reconstr_every", type=int, default=10)
    parser.add_argument("--level_weights", nargs="*", default=None,
                        type=float,
                        help="Per-level edge weights for the margin loss.")
    parser.add_argument("--weigh_pos_term", action="store_true",
                        help="Apply level weights to the positive term only.")
    parser.add_argument("--weigh_neg_term", action="store_true",
                        help="Weight negatives n_nodes/ratio x "
                             "1/deg_tc(corrupted node).")
    for flag in ("--class_weights", "--freeze_weights", "--use_grayscale"):
        parser.add_argument(flag, action="store_true",
                            help="Accepted for reference command-line "
                                 "compatibility; unused by the imageless "
                                 "label-only CLI.")
    for flag in ("--evaluator", "--image_dir", "--model",
                 "--weight_strategy"):
        parser.add_argument(flag, type=str, default=None,
                            help="Accepted for reference command-line "
                                 "compatibility; unused by the imageless "
                                 "label-only CLI.")


def build_parser():
    parser = argparse.ArgumentParser()
    add_label_flags(parser)
    parser.add_argument("--load_cosine_emb", type=str, default=None,
                        help="Path to cosine embeddings .npy warm start")
    return parser


def label_splits(args):
    """(labelmap, EdgeSplits) of the CLI's taxonomy and label graph."""
    if args.taxonomy == "butterfly200":
        from ..hierarchy import butterfly200_labelmap

        labelmap = butterfly200_labelmap()
        level_labels = labelmap.leaf_paths()   # full taxonomy coverage
    else:
        labelmap, datasets, _ = load_ethec_data(args.data_dir, args.debug)
        level_labels = (np.concatenate([d.level_labels
                                        for d in datasets.values()])
                        if args.graph_from == "all"
                        else datasets["train"].level_labels)
    adj = label_graph_from_paths(level_labels, labelmap)
    return labelmap, split_edges(
        adj, proportion_of_nb_edges_in_train=args.prop_of_nb_edges,
        seed=args.random_seed)


def label_config(args, energy: str, optimizer: str) -> EmbeddingTrainerConfig:
    return EmbeddingTrainerConfig(
        energy=energy,
        embedding_dim=args.embedding_dim,
        lr=args.lr,
        batch_size=args.batch_size,
        neg_to_pos_ratio=args.neg_to_pos_ratio,
        alpha=args.alpha,
        optimizer=optimizer,
        pick_per_level=args.pick_per_level,
        level_weights=(tuple(args.level_weights)
                       if args.level_weights else None),
        weigh_pos_term=args.weigh_pos_term,
        weigh_neg_term=args.weigh_neg_term,
        seed=args.random_seed,
        lr_steps=tuple(args.lr_step),
        lr_decay=args.lr_decay,
        device=args.device,
    )


def main(args=None):
    args = build_parser().parse_args(args)
    labelmap, splits = label_splits(args)
    cfg = label_config(args, LOSS_MAP[args.loss], args.optimizer_method)
    result = run_label_embedding(
        labelmap, splits, cfg,
        experiment_dir=args.experiment_dir,
        experiment_name=args.experiment_name,
        n_epochs=args.n_epochs,
        eval_interval=args.eval_interval,
        check_reconstr_every=args.check_reconstr_every,
        resume=args.resume,
        manifest_args=manifest_from_args(args),
    )
    if args.load_cosine_emb:
        print("note: cosine warm start is applied before training in the "
              "hyperbolic CLI; ignored for euclidean losses")
    print({k: v for k, v in result.items()
           if isinstance(v, (int, float, str))})
    return result


if __name__ == "__main__":
    main()
