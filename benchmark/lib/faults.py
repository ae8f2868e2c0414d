"""Faults planted in the program, which the check has to catch: each
patches a method of the measured trainers for as long as its context is
open. Used by the benchmark's tests on the CPU and by ``calibrate.py``
on the card, never by a run.

* ``unchanged``: every optimizer step leaves the state as it was.
* ``half_batch``: a train step sees the first half of its batch (the
  classifier's mean over the rest; the joint step's first half of the
  positive edges).
* ``altered``: the eval step's scores of each batch's first row come out
  reversed (an answer altered where it is produced).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(name: str):
    from learning_embeddings_tpu_torch.train.classifier import \
        ClassifierTrainer
    from learning_embeddings_tpu_torch.train.joint_cnn import JointCNNTrainer

    if name == "unchanged":
        targets = [(torch.optim.Adam, "step",
                    lambda orig: lambda self, closure=None: None)]
    elif name == "half_batch":
        def train_step(orig):
            def f(self, state, images, level_labels, multihot):
                n = len(images) // 2
                return orig(self, state, images[:n], level_labels[:n],
                            multihot[:n])
            return f

        def prepare_batch(orig):
            def f(self, pos_from, pos_to):
                n = len(pos_from) // 2
                return orig(self, pos_from[:n], pos_to[:n])
            return f
        targets = [(ClassifierTrainer, "train_step", train_step),
                   (JointCNNTrainer, "prepare_batch", prepare_batch)]
    elif name == "altered":
        def eval_step(orig):
            def f(self, *args):
                loss, scores = orig(self, *args)
                scores = scores.clone()
                scores[0] = scores[0].flip(0)
                return loss, scores
            return f
        targets = [(ClassifierTrainer, "eval_step", eval_step)]
    else:
        raise ValueError(f"unknown fault {name!r}; expected {FAULTS}")
    saved = [(cls, attr, getattr(cls, attr)) for cls, attr, _ in targets]
    try:
        for cls, attr, make in targets:
            setattr(cls, attr, make(getattr(cls, attr)))
        yield
    finally:
        for cls, attr, orig in saved:
            setattr(cls, attr, orig)
