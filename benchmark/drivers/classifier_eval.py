"""Eval passes of the hierarchical classifier over a val split, as the
runner's ``_eval_pass`` makes them (``train/runner.py``): batch by batch
``ClassifierTrainer.put_batch`` of a host uint8 batch, then
``ClassifierTrainer.eval_step``, the scores read back to the host and the
loss read, with a ragged last batch. The weights, running statistics
included, come from the seed.

Traffic parameters: ``batch``, ``split_rows`` (images of the split),
``pool_batches`` (host batches made from the seed: batch j of the split
reads pool batch j mod pool_batches, its first rows for the ragged
one), ``trace_seconds`` (the window's traced part with ``--trace 1``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lib import check as checks
from ..lib import inputs
from ..lib.program import Stamps, sync
from ..reference import classifier as reference
from ..reference.resnet import fp8_round, identity
from ..reference.taxonomy import Taxonomy


class Driver:
    unit = "images"

    def __init__(self, seed: int, device: str, config: dict, params: dict):
        self.seed, self.device, self.config = seed, device, config
        self.params = params
        self.j, self.trace_j = 0, 0
        self.bad_rows = 0

    def make_inputs(self) -> None:
        c, p = self.config, self.params
        self.tax = tax = Taxonomy()
        B, S, n = p["batch"], c["image_size"], p["pool_batches"]
        self.batch, self.rows = B, p["split_rows"]
        self.n_batches = -(-self.rows // B)
        self.images = inputs.uint8_images(self.seed, "val_pool", n * B, S,
                                          self.device).reshape(n, B, S, S, 3)
        leaves = inputs.rng(self.seed, "val_leaves").randint(
            0, tax.levels[-1], self.rows)
        self.labels = tax.leaf_paths[leaves]
        self.multihot = tax.multihot(self.labels)
        self.scores = np.full((self.rows, tax.n_classes), np.nan, np.float32)
        self.scored = np.zeros(self.rows, bool)

    def setup(self) -> None:
        from learning_embeddings_tpu_torch.hierarchy import \
            butterfly200_labelmap
        from learning_embeddings_tpu_torch.train.classifier import (
            ClassifierConfig, ClassifierTrainer)

        stamp = Stamps()
        self.make_inputs()
        stamp("inputs")
        c, tax = self.config, self.tax
        labelmap = butterfly200_labelmap()
        if tuple(labelmap.levels) != tax.levels:
            raise ValueError(f"the program's taxonomy {labelmap.levels} is "
                             f"not the configuration's {tax.levels}")
        B, S = self.batch, c["image_size"]
        self.trainer = ClassifierTrainer(labelmap, ClassifierConfig(
            backbone=c["architecture"], criterion=c["criterion"],
            optimizer=c["optimizer"], lr=c["lr"], image_size=S,
            batch_size=B, seed=inputs.sub_seed(self.seed, "program"),
            dtype=getattr(torch, c["activations"]), bn_impl=c["bn_impl"],
            device=self.device))
        stamp("trainer")
        self.trainer.model.load_state_dict(inputs.resnet_params(
            self.seed, self.device, tax.n_classes, running_stats=True))
        stamp("weights")
        # one whole pass: every shape the window uses, the ragged one too
        for _ in range(self.n_batches):
            self.step()
        sync(self.device)
        stamp("warm-up pass")

    def window_start(self) -> None:
        self.trace_j = self.j
        self.scored[:] = False
        self.bad_rows = 0

    def trace_start(self) -> None:
        self.trace_j = self.j

    def step(self) -> int:
        j = self.j % self.n_batches
        self.j += 1
        lo, hi = j * self.batch, min((j + 1) * self.batch, self.rows)
        images = self.images[j % len(self.images)][:hi - lo]
        t = self.trainer
        b = t.put_batch(images, self.labels[lo:hi], self.multihot[lo:hi])
        loss, s = t.eval_step(t.state, *b)
        s = s.float().cpu().numpy()
        self.loss = float(loss)
        self.scores[lo:hi] = s
        self.scored[lo:hi] = True
        self.bad_rows += int((~np.isfinite(s)).any(axis=1).sum())
        return hi - lo

    def finish(self) -> None:
        pass

    def failed(self) -> int:
        return self.bad_rows

    def rates(self, window_s: float, units: int) -> dict:
        return {"eval_images_per_s": units / window_s}

    def info(self) -> dict:
        batches = self.j - self.trace_j
        full, rem = divmod(batches, self.n_batches)
        first = self.trace_j % self.n_batches
        images = full * self.rows + sum(
            min((k + 1) * self.batch, self.rows) - k * self.batch
            for k in ((first + i) % self.n_batches for i in range(rem)))
        return {"steps": batches, "images": images, "batch": self.batch,
                "image_size": self.config["image_size"],
                "n_out": self.tax.n_classes}

    def free(self) -> None:
        self.trainer = None

    def _reference(self, q=identity) -> np.ndarray:
        """The reference's scores of each pool image."""
        return reference.eval_scores(
            inputs.resnet_params(self.seed, self.device, self.tax.n_classes,
                                 running_stats=True),
            self.images.reshape((-1,) + self.images.shape[2:]), self.device,
            q=q)

    def _pool_rows(self, rows):
        B = self.batch
        return (rows // B % len(self.images)) * B + rows % B

    def check(self) -> dict:
        """Every row scored in the window against the reference's scores
        of its image."""
        rows = np.nonzero(self.scored)[0]
        return {"score_gap": checks.score_gap(
            self.scores[rows], self._reference()[self._pool_rows(rows)])}

    def control(self, q=fp8_round) -> dict:
        """The check's number with the reference in fp8 in the program's
        place, over a whole pass (after ``make_inputs``)."""
        rows = self._pool_rows(np.arange(self.rows))
        return {"score_gap": checks.score_gap(
            self._reference(q)[rows], self._reference()[rows])}
