"""Toy-hierarchy embedding CLI: the port of
``learning_embeddings_tpu/cli/embed_toy.py`` (the same flags, plus
``--device``): a complete b-ary tree → order / cone embeddings →
reconstruction check, and at dimension 2 a plot of the embedding."""

from __future__ import annotations

import argparse
import os

from ..hierarchy import label_graph_from_paths, split_edges, toy_labelmap
from ..train.embedding import EmbeddingTrainerConfig
from ..train.runner import run_label_embedding
from .common import add_device_flag, manifest_from_args

LOSS_MAP = {
    "order_emb_loss": "order",
    "euc_emb_loss": "euc_cone",
    "euc_cones_loss": "euc_cone",
    "hyp_cones_loss": "hyp_cone",
}


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--experiment_dir", type=str, required=True)
    parser.add_argument("--n_epochs", type=int, required=True)
    parser.add_argument("--n_workers", type=int, default=4)
    parser.add_argument("--eval_interval", type=int, default=1)
    parser.add_argument("--embedding_dim", type=int, default=10)
    parser.add_argument("--neg_to_pos_ratio", type=int, default=5)
    parser.add_argument("--alpha", help="Margin alpha.", type=float,
                        default=0.05)
    parser.add_argument("--prop_of_nb_edges", type=float, default=0.0,
                        help="Proportion of non-basic edges added to train.")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--optimizer_method", type=str, default="adam")
    parser.add_argument("--loss", type=str, required=True,
                        help="[order_emb_loss, euc_cones_loss, hyp_cones_loss]")
    parser.add_argument("--pick_per_level", action="store_true")
    parser.add_argument("--lr_step", nargs="*", default=[], type=int)
    parser.add_argument("--lr_decay", type=float, default=1.0)
    parser.add_argument("--tree_levels", required=True, type=int)
    parser.add_argument("--tree_branching", required=True, type=int)
    parser.add_argument("--random_seed", type=int, default=0)
    add_device_flag(parser)
    return parser


def main(args=None):
    args = build_parser().parse_args(args)
    lm = toy_labelmap(branching=args.tree_branching, n_levels=args.tree_levels)
    adj = label_graph_from_paths(lm.leaf_paths(), lm)
    splits = split_edges(adj,
                         proportion_of_nb_edges_in_train=args.prop_of_nb_edges,
                         seed=args.random_seed)
    cfg = EmbeddingTrainerConfig(
        energy=LOSS_MAP[args.loss],
        embedding_dim=args.embedding_dim,
        lr=args.lr,
        batch_size=args.batch_size,
        neg_to_pos_ratio=args.neg_to_pos_ratio,
        alpha=args.alpha,
        optimizer=args.optimizer_method,
        pick_per_level=args.pick_per_level,
        seed=args.random_seed,
        lr_steps=tuple(args.lr_step),
        lr_decay=args.lr_decay,
        device=args.device,
    )
    result = run_label_embedding(
        lm, splits, cfg,
        experiment_dir=args.experiment_dir,
        experiment_name=args.experiment_name,
        n_epochs=args.n_epochs,
        eval_interval=args.eval_interval,
        resume=args.resume,
        manifest_args=manifest_from_args(args),
    )
    # post-train 2-D plot
    if args.embedding_dim == 2:
        from ..viz.toy import plot_toy_embedding

        out = os.path.join(result["experiment"].stats, "toy_embedding.png")
        plot_toy_embedding(result["trainer"].all_embeddings().cpu().numpy(),
                           lm, out, energy=cfg.energy, K=result["trainer"].K)
        print(f"wrote {out}")
    print({k: v for k, v in result.items()
           if isinstance(v, (int, float, str))})
    return result


if __name__ == "__main__":
    main()
