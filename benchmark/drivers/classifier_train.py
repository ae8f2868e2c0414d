"""Closed-loop training of the hierarchical classifier, as the runner's
train loop drives it (``train/runner.py``, the classifier epoch): each
step ``ClassifierTrainer.put_batch`` of a host uint8 batch, then
``ClassifierTrainer.train_step``; the step losses are summed once, at the
window's end.

Traffic parameters: ``batch`` (images a step) and ``pool_batches`` (host
batches made from the seed, used in turn), ``check_steps`` (the first
steps, which the reference follows), ``trace_seconds`` (the window's
traced part with ``--trace 1``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lib import check as checks
from ..lib import inputs
from ..lib.program import change_norms, first_grad_norms, Stamps, sync
from ..reference import classifier as reference
from ..reference.resnet import fp8_round, identity
from ..reference.taxonomy import Taxonomy


class Driver:
    unit = "images"

    def __init__(self, seed: int, device: str, config: dict, params: dict):
        self.seed, self.device, self.config = seed, device, config
        self.params = params
        self.losses, self.k, self.trace_k = [], 0, 0
        self.program = {}

    def make_inputs(self) -> None:
        c, p = self.config, self.params
        self.tax = tax = Taxonomy()
        B, S, n = p["batch"], c["image_size"], p["pool_batches"]
        self.batch = B
        self.images = inputs.uint8_images(self.seed, "train_pool", n * B, S,
                                          self.device).reshape(n, B, S, S, 3)
        leaves = inputs.rng(self.seed, "train_leaves").randint(
            0, tax.levels[-1], (n, B))
        self.labels = tax.leaf_paths[leaves]
        self.multihot = np.stack([tax.multihot(ll) for ll in self.labels])

    def setup(self) -> None:
        from learning_embeddings_tpu_torch.hierarchy import \
            butterfly200_labelmap
        from learning_embeddings_tpu_torch.train.classifier import (
            ClassifierConfig, ClassifierTrainer)

        stamp = Stamps()
        self.make_inputs()
        stamp("inputs")
        c, p, tax = self.config, self.params, self.tax
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
        model = self.trainer.model
        stamp("trainer")
        model.load_state_dict(inputs.resnet_params(
            self.seed, self.device, tax.n_classes))
        stamp("weights")
        # the first steps go through the window's own call and feed, on
        # batches that all differ; the reference follows them
        for i in range(p["check_steps"]):
            self.step()
            if i == 0:
                self.program["grad_norms"] = first_grad_norms(
                    model.named_parameters(), self.trainer.state.optimizer)
        self.program["losses"] = [float(l) for l in self.losses]
        start = inputs.resnet_params(self.seed, self.device, tax.n_classes)
        self.program["change_norms"] = change_norms(
            model.named_parameters(), start)
        del start
        sync(self.device)
        stamp("check steps")

    def window_start(self) -> None:
        self.losses, self.trace_k = [], self.k

    def trace_start(self) -> None:
        self.trace_k = self.k

    def step(self) -> int:
        b = self.k % len(self.images)
        self.k += 1
        t = self.trainer
        batch = t.put_batch(self.images[b], self.labels[b], self.multihot[b])
        t.state, loss = t.train_step(t.state, *batch)
        self.losses.append(loss)
        return self.batch

    def finish(self) -> None:
        # the runner reads the epoch's loss once, at its end
        self.total = float(torch.stack(self.losses).double().sum())

    def failed(self) -> int:
        bad = ~torch.isfinite(torch.stack(self.losses))
        return int(bad.sum()) * self.batch

    def rates(self, window_s: float, units: int) -> dict:
        return {"train_images_per_s": units / window_s}

    def info(self) -> dict:
        steps = self.k - self.trace_k
        return {"steps": steps, "images": steps * self.batch,
                "batch": self.batch, "image_size": self.config["image_size"],
                "n_out": self.tax.n_classes}

    def free(self) -> None:
        self.trainer = None
        self.losses = []

    def _reference(self, q=identity) -> dict:
        n = self.params["check_steps"]
        return reference.train_steps(
            inputs.resnet_params(self.seed, self.device, self.tax.n_classes),
            [(self.images[i], self.labels[i]) for i in range(n)],
            self.tax.levels, self.config["lr"], self.device, q=q)

    def check(self) -> dict:
        ref = self._reference()
        self.details = checks.worst_leaves(self.program, ref)
        return checks.training_numbers(self.program, ref)

    def control(self, q=fp8_round) -> dict:
        """The check's numbers with the reference in fp8 in the program's
        place (after ``make_inputs``)."""
        ctl, ref = self._reference(q), self._reference()
        self.details = checks.worst_leaves(ctl, ref)
        return checks.training_numbers(ctl, ref)
