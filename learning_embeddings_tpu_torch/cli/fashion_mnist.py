"""FashionMNIST hierarchical classifier CLI: the port of
``learning_embeddings_tpu/cli/fashion_mnist.py`` (the reference's
network/fashion_mnist.py __main__, :262-283): a 2-level taxonomy (4
families / 10 classes), 1-channel input, RandomResizedCrop + hflip train
transform, through ``train/runner.py::run_classifier``. The JAX flags and
loss names, plus ``--device``.

The images load from the idx files under ``--data_root`` (FashionMNIST/raw);
where they are absent the CLI trains on ``synthetic_array_dataset``, as
the JAX CLI does. On the card every train step runs the BatchNorm
reductions of ``ops/bn_triton.py`` (20 + 20 on the default ResNet-18).
``--bn_stats_rows N`` takes the ghost-batch statistics route
(``GhostBatchNorm``). ``--n_model > 1`` raises (not ported: ROADMAP.md
queue A item 21).

    python -m learning_embeddings_tpu_torch.cli.fashion_mnist \\
        --experiment_dir <dir> --experiment_name f --n_epochs 1 \\
        --loss multi_level --set_mode train [--debug] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.workloads import (
    ArrayDataset,
    fmnist_labelmap,
    load_fmnist,
    stratified_index_split,
    synthetic_array_dataset,
)
from .common import add_device_flag, inverse_class_weights, manifest_from_args
from .ethec_experiments import LOSS_MAP

__all__ = ["LOSS_MAP", "build_parser", "add_workload_flags", "run_workload",
           "main"]


def add_workload_flags(parser: argparse.ArgumentParser) -> None:
    """The flags of the two array-dataset CLIs (this one and ``cifar``)."""
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--evaluator", type=str, default="MLST")
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--experiment_dir", type=str, required=True)
    parser.add_argument("--n_epochs", type=int, required=True)
    parser.add_argument("--n_workers", type=int, default=4)
    parser.add_argument("--eval_interval", type=int, default=1)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--optimizer_method", type=str, default="adam")
    parser.add_argument("--model", type=str, default="resnet18")
    parser.add_argument("--loss", type=str, required=True)
    parser.add_argument("--freeze_weights", action="store_true")
    parser.add_argument("--set_mode", type=str, required=True)
    parser.add_argument("--data_root", type=str, default="../database",
                        help="Directory with the dataset's files; a "
                             "synthetic class-colored dataset is used when "
                             "they are absent.")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--random_seed", type=int, default=0)
    parser.add_argument("--class_weights", action="store_true",
                        help="Re-weigh the loss by inverse class freq.")
    parser.add_argument("--level_weights", nargs="*", default=None,
                        type=float, help="Per-level loss weights.")
    parser.add_argument("--f32_input", action="store_true",
                        help="Transfer float32 pixels host->device instead "
                             "of the default uint8-with-on-device-scale.")
    parser.add_argument("--freeze_bn", action="store_true",
                        help="Frozen BN running statistics (no BN kernel "
                             "runs).")
    parser.add_argument("--bn_stats_rows", type=int, default=0,
                        help=">0: ghost-batch BN statistics over the first "
                             "N rows of each batch.")
    parser.add_argument("--n_model", type=int, default=1,
                        help="Mesh 'model' axis width (not ported: > 1 "
                             "raises).")
    parser.add_argument("--lr_step", type=int, nargs="*",
                        default=[],
                        help="Epochs where lr *= lr_decay "
                             "(reference MultiStepLR, finetuner.py:102)")
    parser.add_argument("--lr_decay", type=float, default=0.1)
    add_device_flag(parser)


def build_parser():
    parser = argparse.ArgumentParser()
    add_workload_flags(parser)
    return parser


def run_workload(args, labelmap, loader, name: str, size: int,
                 channels: int, use_grayscale: bool):
    """The array-dataset CLIs' run: `loader(args.data_root)`'s train and
    test images (else `synthetic_array_dataset` of `size`² × `channels`,
    600 images under --debug, 6000 otherwise), --debug's first 600, the
    stratified 80/10/10 split, then ``run_classifier`` with the
    RandomResizedCrop transform and no resampler."""
    from ..train.classifier import ClassifierConfig
    from ..train.runner import run_classifier

    try:
        tr_i, tr_l, te_i, te_l = loader(args.data_root)
        images = np.concatenate([tr_i, te_i])
        labels = np.concatenate([tr_l, te_l]).astype(np.int32)
    except FileNotFoundError:
        print(f"== {name} files not found; using a synthetic stand-in")
        n = 600 if args.debug else 6000
        ds = synthetic_array_dataset(labelmap, n, size=size,
                                     channels=channels, seed=args.random_seed)
        images, labels = ds.images, ds.leaf_labels
    if args.debug:
        images, labels = images[:600], labels[:600]

    tr, va, te = stratified_index_split(labels, seed=args.random_seed)
    datasets = {
        "train": ArrayDataset(images[tr], labels[tr], labelmap),
        "val": ArrayDataset(images[va], labels[va], labelmap),
        "test": ArrayDataset(images[te], labels[te], labelmap),
    }
    class_weights = None
    if args.class_weights:
        class_weights = inverse_class_weights(datasets["train"], labelmap)
    cfg = ClassifierConfig(
        backbone=args.model,
        criterion=LOSS_MAP[args.loss],
        level_weights=(tuple(args.level_weights)
                       if args.level_weights else None),
        class_weights=class_weights,
        lr=args.lr,
        optimizer=args.optimizer_method,
        freeze_trunk=args.freeze_weights,
        image_size=args.image_size,
        batch_size=args.batch_size,
        seed=args.random_seed,
        lr_steps=tuple(args.lr_step),
        lr_decay=args.lr_decay,
        freeze_bn=args.freeze_bn,
        bn_stats_rows=args.bn_stats_rows,
        device=args.device,
    )
    evaluator = args.evaluator if args.loss == "multi_label" else "MLEVAL"
    return run_classifier(
        labelmap, datasets, "", cfg,
        experiment_dir=args.experiment_dir,
        experiment_name=args.experiment_name,
        n_epochs=args.n_epochs,
        evaluator=evaluator,
        eval_interval=args.eval_interval,
        n_workers=args.n_workers,
        use_grayscale=use_grayscale,
        resume=args.resume,
        manifest_args=manifest_from_args(args),
        set_mode=args.set_mode,
        augment="rrc",
        use_weighted_resampler=False,
        n_model=args.n_model,
        input_dtype="float32" if args.f32_input else "uint8",
    )


def main(args=None):
    args = build_parser().parse_args(args)
    return run_workload(args, fmnist_labelmap(), load_fmnist, "FashionMNIST",
                        size=28, channels=1, use_grayscale=True)


if __name__ == "__main__":
    main()
