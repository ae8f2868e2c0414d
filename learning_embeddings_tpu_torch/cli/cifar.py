"""CIFAR-10/100 hierarchical classifier CLI: the port of
``learning_embeddings_tpu/cli/cifar.py`` (the reference's
network/finetuner.py __main__, :888-914 ``train_cifar10``): CIFAR-10's
3-level taxonomy (2 / 4 / 10) or CIFAR-100's 2-level one (20 / 100),
through ``train/runner.py::run_classifier`` as ``cli/fashion_mnist.py``
runs it (RGB input). The JAX flags, ``--dataset cifar10|cifar100``
among them, plus ``--device``.

The images load from the python pickles under ``--data_root``; where they
are absent the CLI trains on ``synthetic_array_dataset``, as the JAX CLI
does. ``--bn_stats_rows N`` takes the ghost-batch statistics route;
``--n_model > 1`` raises (not ported: ROADMAP.md queue A item 21).

    python -m learning_embeddings_tpu_torch.cli.cifar --dataset cifar10 \\
        --experiment_dir <dir> --experiment_name c --n_epochs 1 \\
        --loss multi_level --set_mode train [--debug] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data.workloads import (cifar10_labelmap, cifar100_labelmap,
                              load_cifar10, load_cifar100)
from .fashion_mnist import LOSS_MAP, add_workload_flags, run_workload

__all__ = ["LOSS_MAP", "build_parser", "main"]


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="cifar10",
                        help="[cifar10, cifar100]")
    add_workload_flags(parser)
    return parser


def main(args=None):
    args = build_parser().parse_args(args)
    if args.dataset == "cifar100":
        labelmap, loader = cifar100_labelmap(), load_cifar100
    else:
        labelmap, loader = cifar10_labelmap(), load_cifar10
    return run_workload(args, labelmap, loader, args.dataset, size=32,
                        channels=3, use_grayscale=False)


if __name__ == "__main__":
    main()
