"""fc7 feature precompute: the port of
``learning_embeddings_tpu/cli/image_emb.py``. Loads the trunk of a port
classifier's ``best_model`` (``--experiment_load_dir``; a randomly
initialised trunk without it), runs it over every image of each split
through ``ImagePipeline`` (the eval transform) and writes
``<output_dir>/<split>.npz`` with {paths: (N,) str, features: (N, F)
float32}, the input of the fc7 joint trainer.

BatchNorm runs in inference mode (running statistics), so no BN kernel
runs. Same flags as the JAX CLI, plus ``--device`` (default cuda) and
``--loader`` (``native``: JPEG files through the C++ loader, which the JAX
CLI takes by itself for .jpg files). Every backbone of ``BACKBONES``
runs: ``--model alexnet`` (the reference's fc7 extractor) writes
4096-wide features, ``vgg11_bn`` 512-wide.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import add_device_flag, add_loader_flag, load_ethec_data


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default=None,
                        help="default <data_dir>/embeddings")
    parser.add_argument("--model", type=str, default="resnet50")
    parser.add_argument("--experiment_load_dir", type=str, default=None,
                        help="Experiment dir holding best_model weights of "
                             "a finetuned classifier; random-init trunk "
                             "when omitted.")
    parser.add_argument("--image_size", type=int, default=448)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--n_workers", type=int, default=8)
    add_loader_flag(parser)
    add_device_flag(parser)
    return parser


def load_trunk(model: str, experiment_load_dir, device):
    """The eval-mode trunk of `model` on `device` (channels_last): from
    the ``trunk.*`` parameters and buffers of the experiment's
    best_model, or initialised from seed 0 without one."""
    import torch

    from ..models.resnet import init_params_, make_trunk
    from ..train.experiment import Checkpointer, ExperimentDir

    trunk = make_trunk(model)
    init_params_(trunk, torch.Generator().manual_seed(0))
    if experiment_load_dir:
        exp = ExperimentDir(*os.path.split(experiment_load_dir.rstrip("/")))
        payload = Checkpointer(exp).load_raw("best_model")
        state = {k[len("trunk."):]: v
                 for tree in (payload["params"], payload["batch_stats"])
                 for k, v in tree.items() if k.startswith("trunk.")}
        trunk.load_state_dict(state, strict=True)
    return trunk.to(device=device,
                    memory_format=torch.channels_last).eval()


def main(args=None):
    import torch

    from ..data import ImagePipeline
    from ..ops.image import device_scale
    from ..train.classifier import resolve_device

    args = build_parser().parse_args(args)
    device = resolve_device(args.device)
    labelmap, datasets, _ = load_ethec_data(args.data_dir, args.debug)
    out_dir = args.output_dir or os.path.join(args.data_dir, "embeddings")
    os.makedirs(out_dir, exist_ok=True)
    trunk = load_trunk(args.model, args.experiment_load_dir, device)

    written = {}
    for split, ds in datasets.items():
        pipe = ImagePipeline(ds, labelmap, args.image_dir,
                             image_size=args.image_size,
                             batch_size=args.batch_size, train=False,
                             num_workers=args.n_workers, out_dtype="uint8",
                             loader=args.loader)
        feats = []
        with torch.no_grad():
            for batch in pipe.batches(np.arange(len(ds))):
                images = torch.as_tensor(batch["image"]).to(device)
                feats.append(trunk(device_scale(images).permute(0, 3, 1, 2))
                             .float().cpu().numpy())
        features = (np.concatenate(feats) if feats
                    else np.zeros((0, 1), np.float32))
        path = os.path.join(out_dir, f"{split}.npz")
        np.savez(path, paths=np.asarray(ds.image_paths), features=features)
        print(f"wrote {path}: {features.shape}")
        written[split] = path
    return written


if __name__ == "__main__":
    main()
