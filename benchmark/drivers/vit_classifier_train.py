"""Closed-loop training of the hierarchical classifier on a ViT trunk:
the flow of ``classifier_train.py`` (each step ``put_batch`` of a host
uint8 batch, then ``train_step``; the losses summed at the window's
end), with the configuration's ViT (``backbone``, and its shapes for the
reference and the operation counts) in place of the ResNet. The check
follows the first steps with ``reference/vit.py``, each batch in blocks
of images, leaf by leaf as the reference splits them
(``reference/vit.py::leaves``: the packed q, k, v projection as its three
parts).

Traffic parameters: those of ``classifier_train.py`` and ``ref_block``
(images a block of the reference). Set-up parameter: ``warmup_seconds``,
the train steps after the check steps and before the window, so that
the window starts on a card whose clocks, power draw and allocator are
those of the steady step (a ViT-L step draws near the card's power
limit).
"""

from __future__ import annotations

import time

import torch

from ..lib import inputs
from ..lib.program import Stamps, sync
from ..lib.vit_inputs import vit_params
from ..reference import vit as reference
from ..reference.resnet import identity
from . import classifier_train


def arch(config: dict) -> reference.Arch:
    c = config
    return reference.Arch(
        image_size=c["image_size"], patch=c["patch_size"],
        depth=c["num_hidden_layers"], width=c["hidden_size"],
        heads=c["num_attention_heads"], mlp_dim=c["intermediate_size"])


class Driver(classifier_train.Driver):

    def __init__(self, seed: int, device: str, config: dict, params: dict):
        super().__init__(seed, device, config, params)
        self.arch = arch(config)

    def weights(self) -> dict:
        return vit_params(self.seed, self.device, self.arch,
                          self.tax.n_classes)

    def trainer_config(self):
        from learning_embeddings_tpu_torch.train.classifier import \
            ClassifierConfig

        c = self.config
        return ClassifierConfig(
            backbone=c["backbone"], criterion=c["criterion"],
            optimizer=c["optimizer"], lr=c["lr"],
            image_size=c["image_size"], batch_size=self.batch,
            seed=inputs.sub_seed(self.seed, "program"),
            dtype=getattr(torch, c["activations"]), device=self.device)

    def setup(self) -> None:
        from learning_embeddings_tpu_torch.hierarchy import \
            butterfly200_labelmap
        from learning_embeddings_tpu_torch.train.classifier import \
            ClassifierTrainer

        stamp = Stamps()
        self.make_inputs()
        stamp("inputs")
        labelmap = butterfly200_labelmap()
        if tuple(labelmap.levels) != self.tax.levels:
            raise ValueError(f"the program's taxonomy {labelmap.levels} is "
                             f"not the configuration's {self.tax.levels}")
        self.trainer = ClassifierTrainer(labelmap, self.trainer_config())
        model = self.trainer.model
        stamp("trainer")
        model.load_state_dict(self.weights())
        stamp("weights")
        # the first steps go through the window's own call and feed, on
        # batches that all differ; the reference follows them
        for i in range(self.params["check_steps"]):
            self.step()
            if i == 0:
                self.program["grad_norms"] = self._first_grads(model)
        self.program["losses"] = [float(l) for l in self.losses]
        start = self.weights()
        with torch.no_grad():
            self.program["change_norms"] = reference.leaf_norms(
                (k, p.detach().float() - start[k])
                for k, p in model.named_parameters())
        del start
        sync(self.device)
        stamp("check steps")
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.params.get("warmup_seconds",
                                                          0):
            self.step()
        sync(self.device)
        stamp("warm-up steps")

    @torch.no_grad()
    def _first_grads(self, model, beta1: float = 0.9) -> dict:
        """Each leaf's first gradient as Adam got it (m₁ = (1 − β₁)·g₁),
        by the reference's leaves (``reference/vit.py::leaves``); a leaf
        with no state reads 0."""
        state = self.trainer.state.optimizer.state
        return reference.leaf_norms(
            (k, state[p]["exp_avg"] / (1 - beta1) if "exp_avg" in
             state.get(p, {}) else torch.zeros_like(p))
            for k, p in model.named_parameters())

    def info(self) -> dict:
        return dict(super().info(), arch=list(self.arch))

    def _reference(self, q=identity) -> dict:
        n = self.params["check_steps"]
        return reference.train_steps(
            self.weights(),
            [(self.images[i], self.labels[i]) for i in range(n)],
            self.tax.levels, self.config["lr"], self.device, self.arch,
            q=q, block=self.params.get("ref_block", 16))
