"""Shared implementation of the joint image + label CLIs (``oe.py``,
Euclidean; ``oe_h.py``, hyperbolic): the port of
``learning_embeddings_tpu/cli/_joint_main.py`` (the same flags, plus
``--device``). Two paths:

* the default, fc7: ``FeatNet`` on the ``{split}.npz`` features that
  ``cli/image_emb.py`` writes (``--features_dir``, default
  ``<data_dir>/embeddings``), through
  ``train/runner.py::run_joint_embedding``;
* ``--use_CNN``: the image tower trains end to end on pixels through
  ``train/runner.py::run_joint_cnn``; its BatchNorm reductions are the
  kernels of ``ops/bn_triton.py`` on the card.

With the order energy the eval's all-pairs energies are the kernel of
``ops/pairwise_order.py`` on both paths. Pixels decode through
``data/pipeline.py`` (cv2, else PIL), or with ``--loader native`` the train
pixels through the C++ JPEG loader of ``data/native_loader.py`` (resize +
flip, no crop: ``pad=0``). The JAX CLI takes that loader by itself for
.jpg files and falls back to Python quietly; the port takes it only when
asked and raises where it fails.

Under ``torchrun`` both paths run data-parallel over every rank (the
runners' ``mesh="auto"``): the edge batches, and the ``--use_CNN`` tower
batch, shard over 'data'.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..losses.joint_sampling import build_joint_graph
from ..train.experiment import load_checkpoint_file
from ..train.joint import JointTrainerConfig
from ..train.runner import run_joint_embedding
from .common import (add_common_flags, add_loader_flag, load_ethec_data,
                     manifest_from_args, process_group_from_env)

LOSS_MAP = {
    "order_emb_loss": "order",
    "hyp_cones_loss": "hyp_cone",
}


def resolve_energy(loss: str, default_energy: str) -> str:
    """The reference reuses one loss class name for two geometries: in
    oe.py `euc_cones_loss` is a Euclidean cone (K = 3.0), in oe_h.py the
    hyperbolic cone (K = 0.1), so the flag maps per CLI."""
    if loss == "euc_cones_loss":
        return "hyp_cone" if default_energy == "hyp_cones_loss" \
            else "euc_cone"
    return LOSS_MAP[loss]


def build_parser(default_energy: str):
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    add_loader_flag(parser)
    parser.add_argument("--alpha", type=float, default=0.05)
    parser.add_argument("--load_G_from_disk", action="store_true",
                        help="Load/save the combined graph cache "
                             "(<data_dir>/joint_graph.npz)")
    parser.add_argument("--load_emb_from", type=str, default=None,
                        help="Path to a label-embedding checkpoint (a "
                             "label-only run's weights/best_model): its "
                             "table and calibrated threshold")
    parser.add_argument("--load_cosine_emb", type=str, default=None)
    parser.add_argument("--load_tower_from", type=str, default=None,
                        help="--use_CNN only: warm-start the image tower's "
                             "trunk from a finetuned classifier checkpoint "
                             "(weights/<name>). The checkpoint's trunk must "
                             "match --model; the projection head stays "
                             "freshly initialized.")
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--embedding_dim", type=int, default=10)
    parser.add_argument("--neg_to_pos_ratio", type=int, default=5)
    parser.add_argument("--model", type=str, default=None,
                        help="fc7 path: recorded only (features are "
                             "precomputed; default alexnet). --use_CNN: the "
                             "pixel-tower backbone (default resnet18). An "
                             "explicit value is always respected.")
    parser.add_argument("--loss", type=str, default=default_energy)
    parser.add_argument("--loss_variant", type=str, default="margin",
                        choices=("margin", "vendrov", "nll"),
                        help="margin = the hypernym margin losses; vendrov "
                             "= the caption-ranking loss; nll = "
                             "SimpleEuclideanEmbLoss.")
    parser.add_argument("--use_CNN", action="store_true",
                        help="Train the image CNN end-to-end on pixels "
                             "instead of frozen fc7 features (FeatCNN).")
    parser.add_argument("--image_size", type=int, default=448)
    parser.add_argument("--pick_per_level", action="store_true")
    parser.add_argument("--freeze_weights", action="store_true")
    parser.add_argument("--half_half", action="store_true")
    parser.add_argument("--hide_levels", action="store_true")
    parser.add_argument("--use_rsgd", action="store_true")
    parser.add_argument("--use_radam", action="store_true",
                        help="Riemannian Adam for the label table "
                             "(hyperbolic energies).")
    parser.add_argument("--freeze_bn", action="store_true",
                        help="--use_CNN only: frozen BN statistics in the "
                             "image tower")
    parser.add_argument("--lr_images", type=float, default=1e-3)
    parser.add_argument("--features_dir", type=str, default=None,
                        help="Directory with {split}.npz fc7 features from "
                             "the image_emb CLI (default: "
                             "<data_dir>/embeddings)")
    parser.add_argument("--eval_max_images", type=int, default=None,
                        help="--use_CNN only: cap eval-split embedding work "
                             "at N images (a seeded random subsample, "
                             "printed; default scores the full split)")
    return parser


def load_warm_start(args, n_labels: int):
    """(init_table, init_threshold) for the joint label table.

    --load_emb_from: a label-embedding checkpoint of the port (e.g. a
    label-only run's weights/best_model): its table AND its calibrated
    optimal_threshold.
    --load_cosine_emb: a plain .npy table; a narrower table (e.g. inverted
    2-D cosine embeddings) is zero-padded into the first columns."""
    if args.load_emb_from:
        payload = load_checkpoint_file(args.load_emb_from)
        table = payload["params"]["embedding"]
        thr = float(payload.get("optimal_threshold", float("nan")))
        return table.numpy(), (None if np.isnan(thr) else thr)
    if args.load_cosine_emb:
        table = np.asarray(np.load(args.load_cosine_emb), np.float32)
        if table.shape[0] != n_labels:
            raise ValueError(
                f"--load_cosine_emb table has {table.shape[0]} rows, "
                f"taxonomy has {n_labels} labels")
        if table.shape[1] < args.embedding_dim:
            pad = np.zeros((n_labels, args.embedding_dim - table.shape[1]),
                           np.float32)
            table = np.concatenate([table, pad], axis=1)
        return table, None
    return None, None


def load_tower_warm_start(args):
    """init_tower = (trunk_params, trunk_stats) for the --use_CNN image
    tower, from a finetuned classifier checkpoint of the port
    (--load_tower_from): its ``trunk.*`` parameters and buffers, named
    relative to the trunk. Only the trunk transfers; the tower's
    projection stays freshly initialised."""
    if not args.load_tower_from:
        return None
    payload = load_checkpoint_file(args.load_tower_from)

    def trunk_of(tree):
        return {k[len("trunk."):]: v for k, v in tree.items()
                if k.startswith("trunk.")}

    params = payload.get("params", {})
    trunk = trunk_of(params)
    if not trunk:
        raise ValueError(
            "--load_tower_from: no 'trunk.*' entries in the checkpoint "
            f"params (keys: {sorted(params)[:6]}) — expected a classifier "
            "checkpoint (train/classifier.py checkpoint_payload)")
    stats = payload.get("batch_stats", {})
    trunk_stats = trunk_of(stats)
    if not trunk_stats:
        raise ValueError(
            "--load_tower_from: checkpoint has trunk parameters but no "
            f"trunk.* batch_stats (batch_stats keys: {sorted(stats)[:6]}) "
            "— the tower's BN statistics must transfer with the weights")
    return trunk, trunk_stats


def load_features(features_dir: str, split: str, dataset) -> np.ndarray:
    """fc7 features of `split`, rows aligned with dataset.image_paths:
    ``image_emb`` writes {paths, features} per split."""
    path = os.path.join(features_dir, f"{split}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — run the image_emb CLI first "
            f"(fc7 precompute)")
    blob = np.load(path, allow_pickle=True)
    by_path = {p: i for i, p in enumerate(blob["paths"])}
    rows = [by_path[p] for p in dataset.image_paths]
    return blob["features"][rows].astype(np.float32)


def joint_main(args, default_energy: str):
    args = build_parser(default_energy).parse_args(args)
    with process_group_from_env(args.device):
        return _joint_main(args, default_energy)


def _joint_main(args, default_energy: str):
    if args.model is None:   # effective backbone lands in the manifest
        args.model = "resnet18" if args.use_CNN else "alexnet"
    labelmap, datasets, _ = load_ethec_data(args.data_dir, args.debug)
    cache = os.path.join(args.data_dir, "joint_graph.npz")
    if args.load_G_from_disk and os.path.exists(cache):
        from ..losses.joint_sampling import load_joint_graph

        graph, train_edges = load_joint_graph(cache)
    else:
        graph, train_edges = build_joint_graph(
            labelmap, datasets["train"].level_labels)
        if args.load_G_from_disk:
            from ..losses.joint_sampling import save_joint_graph

            save_joint_graph(cache, graph, train_edges)

    if args.use_CNN:
        return _joint_cnn_main(args, labelmap, datasets, graph, train_edges,
                               default_energy)
    if args.load_tower_from:
        raise SystemExit("--load_tower_from requires --use_CNN (the fc7 "
                         "path has no image tower to warm-start)")

    features_dir = args.features_dir or os.path.join(args.data_dir,
                                                     "embeddings")
    feats = load_features(features_dir, "train", datasets["train"])
    eval_features, eval_paths = {}, {}
    for split in ("val", "test"):
        if split in datasets:
            eval_features[split] = load_features(features_dir, split,
                                                 datasets[split])
            eval_paths[split] = (datasets[split].level_labels
                                 + labelmap.level_start[None, :])
    if args.freeze_weights:
        # the fc7 features come from a frozen trunk already; FeatNet is the
        # projection that trains
        print("--freeze_weights: fc7 features are already frozen; the "
              "FeatNet projection and label table keep training")
    init_table, init_threshold = load_warm_start(args, labelmap.n_classes)
    cfg = JointTrainerConfig(
        energy=resolve_energy(args.loss, default_energy),
        embedding_dim=args.embedding_dim,
        feature_dim=feats.shape[1],
        lr_labels=args.lr,
        lr_images=args.lr_images,
        batch_size=args.batch_size,
        neg_to_pos_ratio=args.neg_to_pos_ratio,
        alpha=args.alpha,
        optimizer_labels=("rsgd" if args.use_rsgd
                          else "radam" if args.use_radam else "adam"),
        pick_per_level=args.pick_per_level,
        hide_levels=args.hide_levels,
        half_half=args.half_half,
        loss_variant=args.loss_variant,
        seed=args.random_seed,
        device=args.device,
    )
    result = run_joint_embedding(
        labelmap, graph, train_edges, feats, cfg,
        experiment_dir=args.experiment_dir,
        experiment_name=args.experiment_name,
        n_epochs=args.n_epochs,
        eval_interval=args.eval_interval,
        eval_features=eval_features,
        eval_paths=eval_paths,
        resume=args.resume,
        manifest_args=manifest_from_args(args),
        init_embeddings=init_table,
        init_threshold=init_threshold,
        mesh="auto",
    )
    print({k: v for k, v in result.items()
           if isinstance(v, (int, float, str))})
    print("test:", result["test_metrics"])
    return result


def native_pixels(paths, size: int, seed: int) -> np.ndarray:
    """The joint train transform (resize + random hflip; the zero-headroom
    crop window, pad=0, makes the loader's resize → crop a plain resize)
    of JPEG files through the C++ loader, as f32 in [0, 1]; raises on any
    file it cannot read (JAX ``cli/_joint_main.py:287-314`` falls back to
    Python instead)."""
    from ..data import native_loader

    batch, status = native_loader.load_augment_batch(paths, size, pad=0,
                                                     train=True, seed=seed)
    if (status != 0).any():
        bad = np.nonzero(status)[0][:3]
        raise FileNotFoundError(f"native loader failed on "
                                f"{[paths[j] for j in bad]} (codes "
                                f"{status[bad]})")
    return batch


def _joint_cnn_main(args, labelmap, datasets, graph, train_edges,
                    default_energy):
    """--use_CNN: the image tower on pixels, through run_joint_cnn (resume,
    threshold checkpointing, edge-F1 calibration on val, full-split
    eval)."""
    from ..data.pipeline import (augment_eval, augment_joint_train,
                                 decode_image)
    from ..train.joint_cnn import JointCNNConfig
    from ..train.runner import run_joint_cnn

    ds = datasets["train"]
    size = args.image_size

    def pixel_loader(rows):
        # the joint train transform: resize + random hflip, seeded by the
        # batch's first row
        rows = np.asarray(rows)
        seed = int(rows[0]) if len(rows) else 0
        if args.loader == "native":
            return native_pixels(
                [os.path.join(args.image_dir, ds.image_paths[r])
                 for r in rows], size, seed)
        rng = np.random.RandomState(seed)
        return np.stack([
            augment_joint_train(decode_image(
                os.path.join(args.image_dir, ds.image_paths[r])), size, rng)
            for r in rows]).astype(np.float32) / 255.0

    init_table, init_threshold = load_warm_start(args, labelmap.n_classes)
    cfg = JointCNNConfig(
        loss_variant=args.loss_variant,
        energy=resolve_energy(args.loss, default_energy),
        backbone=args.model,
        embedding_dim=args.embedding_dim, image_size=size,
        lr_labels=args.lr, lr_images=args.lr_images,
        batch_size=args.batch_size, neg_to_pos_ratio=args.neg_to_pos_ratio,
        alpha=args.alpha,
        optimizer_labels=("rsgd" if args.use_rsgd
                          else "radam" if args.use_radam else "adam"),
        pick_per_level=args.pick_per_level, seed=args.random_seed,
        hide_levels=args.hide_levels, half_half=args.half_half,
        freeze_bn=args.freeze_bn, freeze_images=args.freeze_weights,
        device=args.device)

    def eval_loader_for(eval_ds):
        def load(rows):
            return np.stack([
                augment_eval(decode_image(
                    os.path.join(args.image_dir, eval_ds.image_paths[r])),
                    size)
                for r in np.asarray(rows)]).astype(np.float32) / 255.0
        return load

    eval_sets = {}
    for split in ("val", "test"):
        eds = datasets.get(split)
        if eds is not None and len(eds):
            paths = eds.level_labels + np.asarray(
                labelmap.level_start)[None, :]
            eval_sets[split] = (paths, eval_loader_for(eds))

    result = run_joint_cnn(
        labelmap, graph, train_edges, pixel_loader, cfg,
        experiment_dir=args.experiment_dir,
        experiment_name=args.experiment_name,
        n_epochs=args.n_epochs,
        eval_interval=args.eval_interval,
        eval_sets=eval_sets,
        eval_max_images=args.eval_max_images,
        resume=args.resume,
        manifest_args=manifest_from_args(args),
        init_embeddings=init_table,
        init_threshold=init_threshold,
        init_tower=load_tower_warm_start(args),
        mesh="auto",
    )
    print({k: v for k, v in result.items()
           if isinstance(v, (int, float, str))})
    print("test:", result["test_metrics"])
    return result
