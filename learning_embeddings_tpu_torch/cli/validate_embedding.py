"""Re-score a trained label-embedding checkpoint: the port of
``learning_embeddings_tpu/cli/validate_embedding.py``. Rebuilds the
experiment from its manifest (``config_params.txt``), loads its best (or a
given) checkpoint and recomputes the graph reconstruction and the val/test
edge metrics, optionally with the 2-D plot. With the order energy the
reconstruction takes the kernel of ``ops/pairwise_order.py`` on the card.

    python -m learning_embeddings_tpu_torch.cli.validate_embedding \\
        --experiment_path exp/emb_run [--epoch 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..hierarchy import label_graph_from_paths, split_edges, toy_labelmap
from ..train.embedding import EmbeddingTrainer, EmbeddingTrainerConfig
from ..train.experiment import Checkpointer, ExperimentDir, read_manifest
from .common import DEFAULT_DATA_DIR, add_device_flag, load_ethec_data
from .order_embeddings import LOSS_MAP as EUC_LOSS_MAP

LOSS_MAP = dict(EUC_LOSS_MAP, hyp_cones_loss="hyp_cone")


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, required=True)
    parser.add_argument("--epoch", type=str, default=None,
                        help="checkpoint name (default: best_model, else "
                             "latest numbered)")
    parser.add_argument("--plot", action="store_true",
                        help="render the 2-d embedding (dim-2 runs only)")
    add_device_flag(parser)
    args = parser.parse_args(args)

    manifest = read_manifest(os.path.join(args.experiment_path,
                                          "config_params.txt"))
    # rebuild the experiment exactly as the manifest describes
    if "tree_branching" in manifest:          # toy run
        lm = toy_labelmap(branching=int(manifest["tree_branching"]),
                          n_levels=int(manifest["tree_levels"]))
        level_labels = lm.leaf_paths()
        prop = float(manifest.get("prop_of_nb_edges", 0.0))
    elif manifest.get("taxonomy") == "butterfly200":
        from ..hierarchy import butterfly200_labelmap

        lm = butterfly200_labelmap()
        level_labels = lm.leaf_paths()
        prop = float(manifest.get("prop_of_nb_edges", 0.9))
    else:
        lm, datasets, _ = load_ethec_data(
            manifest.get("data_dir", DEFAULT_DATA_DIR),
            manifest.get("debug", "False") == "True")
        if manifest.get("graph_from", "train") == "all":
            level_labels = np.concatenate(
                [d.level_labels for d in datasets.values()])
        else:
            level_labels = datasets["train"].level_labels
        prop = float(manifest.get("prop_of_nb_edges", 0.9))
    adj = label_graph_from_paths(level_labels, lm)
    splits = split_edges(adj, proportion_of_nb_edges_in_train=prop,
                         seed=int(manifest.get("random_seed", 0)))

    cfg = EmbeddingTrainerConfig(
        energy=LOSS_MAP.get(manifest.get("loss", "hyp_cones_loss"),
                            "hyp_cone"),
        embedding_dim=int(manifest.get("embedding_dim", 10)),
        batch_size=int(manifest.get("batch_size", 10)),
        neg_to_pos_ratio=int(manifest.get("neg_to_pos_ratio", 5)),
        alpha=float(manifest.get("alpha", 0.05)),
        optimizer=manifest.get("optimizer_method", "adam"),
        pick_per_level=manifest.get("pick_per_level", "False") == "True",
        seed=int(manifest.get("random_seed", 0)),
        device=args.device,
    )
    trainer = EmbeddingTrainer(lm, splits, cfg)

    exp = ExperimentDir(*os.path.split(args.experiment_path.rstrip("/")))
    ckpt = Checkpointer(exp)
    name = args.epoch
    if name is None:
        name = ("best_model" if "best_model" in os.listdir(exp.weights)
                else ckpt.find_existing_weights())
    payload = ckpt.load(name, trainer.checkpoint_payload())
    trainer.restore_payload(payload)

    rec = trainer.reconstruction()
    print(f"checkpoint {name}: reconstruction f1={float(rec.f1):.4f} "
          f"acc={float(rec.accuracy):.4f} threshold={float(rec.threshold):.4f}")
    results = {"reconstruction_f1": float(rec.f1)}
    for split in ("val", "test"):
        if len(getattr(splits, split)):
            m = trainer.evaluate(split)
            print(f"{split}: edge f1={float(m.f1):.4f} "
                  f"threshold={float(m.threshold):.4f}")
            results[f"{split}_f1"] = float(m.f1)
    if args.plot and cfg.embedding_dim == 2:
        from ..viz.toy import plot_toy_embedding

        out = os.path.join(exp.stats, f"validate_{name}.png")
        plot_toy_embedding(trainer.all_embeddings().cpu().numpy(), lm, out,
                           energy=cfg.energy, K=trainer.K)
        print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
