"""ETHEC CNN classifier CLI: the port of
``learning_embeddings_tpu/cli/ethec_experiments.py`` (the same flags and
loss names, plus ``--device``), through ``train/runner.py::run_classifier``.

On the card every train step runs the BatchNorm reductions of
``ops/bn_triton.py`` (the port's default BatchNorm; the JAX CLI runs
flax's); ``--bn_stats_rows`` and ``--bn_stats_dtype bfloat16`` take the
``GhostBatchNorm`` route (K1 on the statistics rows, its bf16-rounding
variant for bf16). ``--loader native`` decodes JPEG files in the C++
loader of ``data/native_loader.py`` (the JAX CLI takes it by itself for
.jpg files). Flags whose feature is not ported raise: ``--n_model > 1``
and ``--spatial_partition`` (ROADMAP.md queue A item 21).

    python -m learning_embeddings_tpu_torch.cli.ethec_experiments \\
        --data_dir <splits> --image_dir <images> --experiment_dir <dir> \\
        --experiment_name e --n_epochs 2 --model resnet50 \\
        --loss multi_level --set_mode train [--device cpu]
"""

from __future__ import annotations

import argparse

from .common import (add_common_flags, add_loader_flag,
                     inverse_class_weights, load_ethec_data,
                     manifest_from_args)

LOSS_MAP = {
    "multi_level": "multi_level_ce",
    "last_level": "last_level_ce",
    "masked_loss": "masked_ce",
    "multi_label": "multi_label_sm",
    "hsoftmax": "hsoftmax",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--evaluator", help="Evaluator type.", type=str,
                        default="ML")
    parser.add_argument("--image_dir", help="Image parent directory.",
                        type=str, required=True)
    parser.add_argument("--weight_strategy", type=str, default="inv",
                        help='["inv", "inv_sqrt"] class-frequency weighting')
    parser.add_argument("--model", help="NN model to use.", type=str,
                        required=True)
    parser.add_argument("--loss", type=str, required=True,
                        help="[multi_label, multi_level, last_level, "
                             "masked_loss, hsoftmax]")
    parser.add_argument("--use_grayscale", action="store_true",
                        help="Use grayscale images.")
    parser.add_argument("--class_weights", action="store_true",
                        help="Re-weigh the loss by inverse class freq.")
    parser.add_argument("--freeze_weights", action="store_true",
                        help="Fine tune only the last layer.")
    parser.add_argument("--level_weights", nargs=4, default=None, type=float,
                        help="List of weights for each level")
    parser.add_argument("--use_2d", action="store_true",
                        help="Use model with 2d features")
    parser.add_argument("--image_size", type=int, default=448)
    parser.add_argument("--load_backbone_from", type=str, default=None,
                        help="Path to a torchvision resnet state_dict .pth "
                             "— starts the trunk from pretrained weights.")
    parser.add_argument("--freeze_bn", action="store_true",
                        help="Train with frozen BN running statistics (no "
                             "BN kernel runs).")
    parser.add_argument("--profile", type=int, default=0,
                        help="Profile N train steps with torch.profiler "
                             "into <exp>/stats/trace and log the top op "
                             "classes by device time.")
    parser.add_argument("--n_model", type=int, default=1,
                        help="Mesh 'model' axis width (not ported: > 1 "
                             "raises).")
    parser.add_argument("--spatial_partition", action="store_true",
                        help="Shard the image H axis (not ported: raises).")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Accumulate gradients over N micro-batches "
                             "per optimizer step (effective batch = "
                             "N x batch_size without the memory).")
    parser.add_argument("--bn_stats_rows", type=int, default=0,
                        help=">0: ghost-batch BN statistics over the first "
                             "N rows of each batch.")
    parser.add_argument("--bn_stats_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="dtype of the train-mode BN statistics "
                             "(bfloat16: each x² and mean rounded to bf16).")
    add_loader_flag(parser)
    parser.add_argument("--generate_plots", action="store_true",
                        help="PR curves + F1-vs-frequency plots on the "
                             "final test pass")
    return parser


def main(args=None):
    from ..train.classifier import ClassifierConfig
    from ..train.runner import run_classifier

    args = build_parser().parse_args(args)
    if args.spatial_partition:
        raise NotImplementedError(
            "--spatial_partition is not ported yet (ROADMAP.md queue A "
            "item 21)")
    labelmap, datasets, _ = load_ethec_data(args.data_dir, args.debug)

    class_weights = None
    if args.class_weights:
        class_weights = inverse_class_weights(datasets["train"], labelmap)

    cfg = ClassifierConfig(
        backbone=args.model,
        criterion=LOSS_MAP[args.loss],
        lr=args.lr,
        optimizer=args.optimizer_method,
        lr_steps=tuple(args.lr_step),
        lr_decay=args.lr_decay,
        level_weights=args.level_weights,
        class_weights=class_weights,
        freeze_trunk=args.freeze_weights,
        image_size=args.image_size,
        batch_size=args.batch_size,
        seed=args.random_seed,
        # --use_2d: 2-d bottleneck + per-level bias-free heads
        head_override="bottleneck2d" if args.use_2d else None,
        freeze_bn=args.freeze_bn,
        bn_stats_rows=args.bn_stats_rows,
        bn_stats_dtype=args.bn_stats_dtype,
        grad_accum=args.grad_accum,
        device=args.device,
    )
    evaluator = args.evaluator if args.loss == "multi_label" else "MLEVAL"
    return run_classifier(
        labelmap, datasets, args.image_dir, cfg,
        experiment_dir=args.experiment_dir,
        experiment_name=args.experiment_name,
        n_epochs=args.n_epochs,
        evaluator=evaluator,
        eval_interval=args.eval_interval,
        n_workers=args.n_workers,
        weight_strategy=args.weight_strategy,
        use_grayscale=args.use_grayscale,
        resume=args.resume,
        manifest_args=manifest_from_args(args),
        set_mode=args.set_mode,
        generate_plots=args.generate_plots,
        load_backbone_from=args.load_backbone_from,
        n_model=args.n_model,
        input_dtype="float32" if args.f32_input else "uint8",
        profile_steps=args.profile,
        loader=args.loader,
    )


if __name__ == "__main__":
    main()
