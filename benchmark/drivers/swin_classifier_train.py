"""Closed-loop training of the hierarchical classifier on a Swin trunk: the
flow of ``vit_classifier_train.py`` (each step ``put_batch`` of a host
uint8 batch, then ``train_step``; the losses summed at the window's end;
``warmup_seconds`` of train steps after the check steps), with the
configuration's Swin (``backbone``, and its shapes for the reference and
the operation counts) in place of the ViT. The check follows the first
steps with ``reference/swin.py``, each batch in blocks of images, leaf by
leaf as the reference splits them (``reference/swin.py::leaves``: the
packed q, k, v projection as its three parts; each block's
relative-bias table a leaf of its own), and the tables' first
gradients as one vector (``bias_grad_gap``).

Traffic parameters: those of ``classifier_train.py`` and ``ref_block``
(images a block of the reference). Set-up parameter:
``warmup_seconds``.
"""

from __future__ import annotations

import time

import torch

from ..lib import check as checks
from ..lib.program import Stamps, sync
from ..lib.swin_inputs import swin_params
from ..reference import swin as reference
from ..reference.resnet import fp8_round, identity
from . import classifier_train, vit_classifier_train


def arch(config: dict) -> reference.Arch:
    c = config
    return reference.Arch(
        image_size=c["image_size"], patch=c["patch_size"],
        embed_dim=c["embed_dim"], depths=tuple(c["depths"]),
        heads=tuple(c["num_heads"]), window=c["window_size"],
        mlp_ratio=c["mlp_ratio"])


class Driver(vit_classifier_train.Driver):

    def __init__(self, seed: int, device: str, config: dict, params: dict):
        # the ViT driver's own reads the ViT's shapes from the config
        classifier_train.Driver.__init__(self, seed, device, config, params)
        self.arch = arch(config)

    def weights(self) -> dict:
        return swin_params(self.seed, self.device, self.arch,
                           self.tax.n_classes)

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
        by the reference's leaves; a leaf with no state reads 0. Keeps
        the bias tables' whole, for ``bias_grad_gap``."""
        state = self.trainer.state.optimizer.state
        grads = {k: (state[p]["exp_avg"] / (1 - beta1) if "exp_avg" in
                     state.get(p, {}) else torch.zeros_like(p))
                 for k, p in model.named_parameters()}
        self.program["table_grads"] = {
            k: g.float().cpu() for k, g in grads.items()
            if k.endswith(reference.TABLE)}
        return reference.leaf_norms(grads.items())

    def _numbers(self, program: dict, ref: dict) -> dict:
        """The training cell's numbers, and ``bias_grad_gap``: the
        relative-bias tables' first gradients, all 24 as one vector,
        against the reference's, ‖Δ‖ / ‖reference‖. A gap of norms cannot
        see the shift mask left out: the tables' gradient then moves in
        direction more than in size. Each table's [gap, ‖program‖,
        ‖reference‖] goes into the details."""
        self.details = checks.worst_leaves(program, ref)
        got, want = [], []
        self.details["table_gaps"] = gaps = {}
        for k, g in ref["table_grads"].items():
            p = program["table_grads"].get(k, torch.zeros_like(g))
            gaps[k] = [checks.vector_gap(p, g, torch.ones_like(g)),
                       float(p.norm()), float(g.norm())]
            got.append(p.flatten())
            want.append(g.flatten())
        numbers = checks.training_numbers(program, ref)
        want = torch.cat(want)
        numbers["bias_grad_gap"] = checks.vector_gap(
            torch.cat(got), want, torch.ones_like(want))
        return numbers

    def check(self) -> dict:
        return self._numbers(self.program, self._reference())

    def control(self, q=fp8_round) -> dict:
        """The check's numbers with the reference in fp8 in the program's
        place (after ``make_inputs``)."""
        return self._numbers(self._reference(q), self._reference())

    def _reference(self, q=identity) -> dict:
        n = self.params["check_steps"]
        return reference.train_steps(
            self.weights(),
            [(self.images[i], self.labels[i]) for i in range(n)],
            self.tax.levels, self.config["lr"], self.device, self.arch,
            q=q, block=self.params.get("ref_block", 16))
