"""Shared CLI plumbing: the port of ``learning_embeddings_tpu/cli/common.py``
(ETHEC dataset loading, debug subsetting, the common argparse flags; flag
names, types and defaults are the JAX package's; the classifier's
inverse-frequency class weights), plus the port's own ``--device``
flag."""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

from ..data import (encode_records, filter_to_labelmap, load_ethec_json,
                    stratified_split)
from ..data.pipeline import LOADERS
from ..hierarchy import labelmap_from_records

#: where the ETHEC split jsons live: $ETHEC_SPLITS_DIR, as in the JAX
#: package; unset, --data_dir must be given
DEFAULT_DATA_DIR = os.environ.get("ETHEC_SPLITS_DIR")


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    """The port's one flag beyond the JAX package's."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, or cpu).")


def add_loader_flag(parser: argparse.ArgumentParser) -> None:
    """``--loader``: the image decode path, asked for by name (the JAX
    CLIs switch to their native loader on JPEG input by themselves)."""
    parser.add_argument("--loader", default="python", choices=list(LOADERS),
                        help="Image decode path: python (cv2/PIL threads) "
                             "or native (the C++ JPEG loader; JPEG files "
                             "only; its uint8 batches round once more).")


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--debug", help="Use DEBUG mode.", action="store_true")
    parser.add_argument("--lr", help="Input learning rate.", type=float,
                        default=0.001)
    parser.add_argument("--batch_size", help="Batch size.", type=int, default=8)
    parser.add_argument("--experiment_name", help="Experiment name.",
                        type=str, required=True)
    parser.add_argument("--experiment_dir", help="Experiment directory.",
                        type=str, required=True)
    parser.add_argument("--n_epochs", type=int, required=True,
                        help="Number of epochs to run training for.")
    parser.add_argument("--n_workers", help="Number of workers.", type=int,
                        default=4)
    parser.add_argument("--eval_interval", type=int, default=1,
                        help="Evaluate model every N intervals.")
    parser.add_argument("--resume", action="store_true",
                        help="Continue training from last checkpoint.")
    parser.add_argument("--optimizer_method", help="[adam, sgd]", type=str,
                        default="adam")
    parser.add_argument("--merged", action="store_true",
                        help="Use dataset which has genus and species combined.")
    parser.add_argument("--set_mode", type=str, required=True,
                        help="If use training or testing mode (loads best model).")
    parser.add_argument("--lr_step", nargs="*", default=[], type=int,
                        help="List of epochs to multiply lr by 0.1")
    parser.add_argument("--lr_decay", type=float, default=0.1,
                        help="Factor applied to the lr at each lr_step "
                             "epoch (reference MultiStepLR gamma).")
    parser.add_argument("--data_dir", type=str, default=DEFAULT_DATA_DIR,
                        help="Directory holding train/val/test.json splits "
                             "(default: $ETHEC_SPLITS_DIR).")
    parser.add_argument("--random_seed", type=int, default=0)
    parser.add_argument("--f32_input", action="store_true",
                        help="Transfer float32 pixels host->device instead "
                             "of the default uint8-with-on-device-scale.")
    add_device_flag(parser)


def inverse_class_weights(dataset, labelmap):
    """Inverse-class-frequency loss weights over the train multi-hot."""
    mh = dataset.multihot(labelmap)
    counts = np.maximum(mh.sum(axis=0), 1.0)
    return (1.0 / counts).astype(np.float32)


def load_ethec_data(data_dir: str, debug: bool = False,
                    n_debug_leaves: int = 12):
    """(labelmap, {split: EncodedDataset}, {split: records}).

    The labelmap is built over ALL available splits, so indices are stable
    whichever samples land in which split. Without train.json the records
    are split again with ``stratified_split``. --debug keeps only the first
    `n_debug_leaves` leaf classes."""
    if not data_dir:
        raise FileNotFoundError("no ETHEC split directory: pass --data_dir "
                                "or set ETHEC_SPLITS_DIR")
    records = {}
    for split in ("train", "val", "test"):
        path = os.path.join(data_dir, f"{split}.json")
        if os.path.exists(path):
            records[split] = load_ethec_json(path)
    if not records:
        raise FileNotFoundError(f"no ETHEC split json in {data_dir}")
    all_records = [r for rs in records.values() for r in rs]
    labelmap = labelmap_from_records(all_records)
    if "train" not in records:
        tr, va, te = stratified_split(all_records, labelmap)
        records = {"train": tr, "val": va, "test": te}
    if debug:
        keep = set(labelmap.ix_to_name[-1][:n_debug_leaves])
        small = [r for r in all_records
                 if f"{r['genus']}_{r['specific_epithet']}" in keep]
        labelmap = labelmap_from_records(small)
        records = {s: filter_to_labelmap(rs, labelmap)
                   for s, rs in records.items()}
    datasets = {s: encode_records(rs, labelmap) for s, rs in records.items()}
    return labelmap, datasets, records


def manifest_from_args(args: argparse.Namespace) -> Dict:
    return dict(vars(args))
