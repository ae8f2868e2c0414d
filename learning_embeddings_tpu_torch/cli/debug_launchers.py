"""Tiny-config debug launchers: the port of
``learning_embeddings_tpu/cli/debug_launchers.py`` (the reference's
`network/profiling.py`, :7-108): canned command lines that run each
workload end to end on synthetic or debug data, as living smoke tests.
Each launcher takes a `device` (default ``cuda``) and passes it on as
``--device``; experiments go to a temporary directory.

    python -m learning_embeddings_tpu_torch.cli.debug_launchers \\
        [ethec|toy|emb|joint|fmnist|cifar] [--device cpu]

``ethec`` and ``joint`` read the ETHEC splits from ``$ETHEC_SPLITS_DIR``
(``--debug`` keeps 12 leaves) and write random PNGs for their images.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def toy(device: str = "cuda"):
    from .embed_toy import main

    with tempfile.TemporaryDirectory() as d:
        return main(("--pick_per_level --tree_levels 3 --tree_branching 2 "
                     "--n_epochs 50 --lr 0.03 --loss hyp_cones_loss "
                     "--embedding_dim 2 --neg_to_pos_ratio 5 --alpha 0.01 "
                     "--experiment_name toy_dbg --batch_size 10 "
                     f"--experiment_dir {d} --device {device}").split())


def emb(device: str = "cuda"):
    from .order_embeddings import main

    with tempfile.TemporaryDirectory() as d:
        return main(("--debug --set_mode train --loss order_emb_loss "
                     "--n_epochs 20 --lr 0.01 --embedding_dim 6 "
                     "--experiment_name emb_dbg "
                     f"--experiment_dir {d} --device {device}").split())


def _fixture_images(datasets, root):
    """A random 64×80 PNG under `root` for every image path of the
    splits."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(0)
    for ds in datasets.values():
        for p in ds.image_paths:
            full = os.path.join(root, p)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            if not os.path.exists(full):
                cv2.imwrite(full, rng.randint(0, 255, (64, 80, 3), np.uint8))


def _ethec_splits():
    from .common import DEFAULT_DATA_DIR, load_ethec_data

    if not DEFAULT_DATA_DIR:
        raise FileNotFoundError("set ETHEC_SPLITS_DIR to the directory of "
                                "the ETHEC train/val/test.json splits")
    return load_ethec_data(DEFAULT_DATA_DIR, debug=True)


def ethec(device: str = "cuda"):
    from .ethec_experiments import main

    _, datasets, _ = _ethec_splits()
    with tempfile.TemporaryDirectory() as d:
        images = os.path.join(d, "images")
        _fixture_images(datasets, images)
        return main(("--debug --set_mode train --loss multi_level "
                     "--model resnet18 --n_epochs 1 --batch_size 8 "
                     "--image_size 64 --n_workers 2 --experiment_name e_dbg "
                     f"--experiment_dir {d} --image_dir {images} "
                     f"--device {device}").split())


def joint(device: str = "cuda"):
    """fc7 precompute, then oe_h on the debug splits."""
    from ..data import save_ethec_json
    from .image_emb import main as emb_main
    from .oe_h import main as oeh_main

    _, datasets, records = _ethec_splits()
    with tempfile.TemporaryDirectory() as d:
        images, data = os.path.join(d, "images"), os.path.join(d, "data")
        _fixture_images(datasets, images)
        os.makedirs(data)
        for split, recs in records.items():
            save_ethec_json(recs, os.path.join(data, f"{split}.json"))
        emb_main(f"--data_dir {data} --image_dir {images} --model resnet18 "
                 f"--image_size 64 --batch_size 16 --n_workers 2 "
                 f"--device {device}".split())
        return oeh_main(("--set_mode train --n_epochs 2 --batch_size 16 "
                         "--embedding_dim 6 --neg_to_pos_ratio 3 "
                         "--pick_per_level --experiment_name j_dbg "
                         f"--experiment_dir {d} --data_dir {data} "
                         f"--image_dir {images} --device {device}").split())


def fmnist(device: str = "cuda"):
    from .fashion_mnist import main

    with tempfile.TemporaryDirectory() as d:
        return main(("--debug --set_mode train --loss multi_level "
                     "--model resnet18 --n_epochs 1 --batch_size 16 "
                     "--image_size 32 --experiment_name f_dbg "
                     f"--experiment_dir {d} --device {device}").split())


def cifar(device: str = "cuda"):
    from .cifar import main

    with tempfile.TemporaryDirectory() as d:
        return main(("--debug --set_mode train --dataset cifar10 "
                     "--loss hsoftmax --model resnet18 --n_epochs 1 "
                     "--batch_size 16 --image_size 32 --experiment_name c_dbg "
                     f"--experiment_dir {d} --device {device}").split())


LAUNCHERS = {"toy": toy, "emb": emb, "ethec": ethec, "joint": joint,
             "fmnist": fmnist, "cifar": cifar}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Tiny end-to-end runs.")
    ap.add_argument("which", nargs="?", default="toy",
                    choices=sorted(LAUNCHERS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = LAUNCHERS[args.which](args.device)
    print(f"debug launcher '{args.which}' completed")
    return result


if __name__ == "__main__":
    main()
