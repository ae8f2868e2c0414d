"""Joint image + label training with the CNN tower, as the runner drives
it (``train/runner.py::run_joint_cnn``): ``JointCNNTrainer.train_epoch``
called again and again, each call one epoch over a fresh seeded draw of
the graph's training edges, set as the trainer's ``train_edges``. The
epoch index lies past the curriculum, so no level is hidden. The host
samples each step's negatives and gathers its unique images (a pixel
loader over a seeded bank: image row r reads bank[r mod bank size]),
one step ahead of the device.

The graph: the taxonomy's labels plus ``graph_images`` image nodes, each
image's leaf drawn from the seed.

Traffic parameters: ``batch`` (positive edges a step), ``epoch_edges``
(edges an epoch), ``bank_images``, ``epoch`` (the epoch index passed),
``prefetch`` and ``inflight_steps`` (the trainer's), ``warm_rows`` (the
tower batch sizes warmed up before the window), ``check_steps``,
``trace_seconds`` (the window's traced part with ``--trace 1``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..lib import check as checks
from ..lib import inputs
from ..lib.program import change_norms, first_grad_norms, Stamps, sync
from ..reference import hypcone
from ..reference.resnet import fp8_round, identity
from ..reference.sampler import Graph
from ..reference.taxonomy import Taxonomy, observed_closure

LABELS = hypcone.LABELS


class Driver:
    unit = "edges"

    def __init__(self, seed: int, device: str, config: dict, params: dict):
        self.seed, self.device, self.config = seed, device, config
        self.params = params
        self.program = {}
        self.recording = False
        self.recorded_ids, self.recorded_losses = [], []
        self.prep_s, self.tower_images, self.steps = [], 0, 0
        self.epoch_losses, self.epoch_s = [], []

    def make_inputs(self) -> None:
        c, p = self.config, self.params
        self.tax = tax = Taxonomy()
        self.batch = p["batch"]
        leaves = inputs.rng(self.seed, "joint_leaves").randint(
            0, tax.levels[-1], c["graph_images"])
        self.paths = tax.leaf_paths[leaves]
        self.paths_global = self.paths + tax.level_start[None, :]
        self.edges = inputs.joint_edges(self.paths_global, tax.n_classes)
        self.edge_rng = inputs.rng(self.seed, "epoch_edges")
        self.order_rng = inputs.rng(self.seed, "epoch_order")
        self.bank = inputs.uint8_images(self.seed, "bank", p["bank_images"],
                                        c["image_size"], self.device)

    def setup(self) -> None:
        from learning_embeddings_tpu_torch.hierarchy import \
            butterfly200_labelmap
        from learning_embeddings_tpu_torch.losses.joint_sampling import \
            build_joint_graph
        from learning_embeddings_tpu_torch.train.joint_cnn import (
            JointCNNConfig, JointCNNTrainer)

        stamp = Stamps()
        self.make_inputs()
        stamp("inputs")
        c, p, tax = self.config, self.params, self.tax
        labelmap = butterfly200_labelmap()
        if tuple(labelmap.levels) != tax.levels:
            raise ValueError(f"the program's taxonomy {labelmap.levels} is "
                             f"not the configuration's {tax.levels}")
        S = c["image_size"]
        graph, _ = build_joint_graph(labelmap, self.paths)
        self.trainer = t = JointCNNTrainer(
            labelmap, graph, self.edges[:self.batch], self._load,
            JointCNNConfig(
                energy=c["energy"], backbone=c["architecture"],
                embedding_dim=c["embedding_dim"], image_size=S,
                lr_labels=c["lr_labels"], lr_images=c["lr_images"],
                batch_size=self.batch,
                neg_to_pos_ratio=c["neg_to_pos_ratio"], alpha=c["alpha"],
                optimizer_labels=c["optimizer_labels"],
                pick_per_level=c["pick_per_level"], K=c["K"],
                seed=inputs.sub_seed(self.seed, "program"),
                tower_dtype=c["activations"], pixel_bucket=self.batch,
                prefetch=p["prefetch"], inflight_steps=p["inflight_steps"],
                device=self.device))
        stamp("graph and trainer")
        t.featcnn.load_state_dict(self._tower0())
        with torch.no_grad():
            t.embedder.embedding.copy_(self._table0())
        self._instrument()
        stamp("weights")

        # the first steps go through the window's own call (epochs of one
        # and of two steps) and feed; the reference follows them
        self.check_edges = []
        self.recording = True
        for i, n in enumerate((1, p["check_steps"] - 1)):
            self._epoch(n * self.batch)
            if i == 0:
                self.program["grad_norms"] = first_grad_norms(
                    self._named(), t.optimizer)
        self.recording = False
        self.program["losses"] = [float(l) for l in self.recorded_losses]
        start = self._tower0()
        start[LABELS] = self._table0()
        self.program["change_norms"] = change_norms(self._named(), start)
        self.program["label_change"] = (
            t.embedder.embedding.detach().float() - start[LABELS]).cpu()
        del start
        self.program_ids = [[a.cpu().numpy() for a in ids]
                            for ids in self.recorded_ids]
        stamp("check steps")
        self._warm_up(p["warm_rows"])
        sync(self.device)
        stamp("warm-up")

    # ------------------------------------------------------------------
    def _tower0(self):
        return inputs.resnet_params(self.seed, self.device,
                                    self.config["embedding_dim"])

    def _table0(self):
        return inputs.label_table(self.seed, self.device, self.tax.n_classes,
                                  self.config["embedding_dim"],
                                  hypcone.inner_radius(self.config["K"]))

    def _named(self):
        return ([(LABELS, self.trainer.embedder.embedding)]
                + list(self.trainer.featcnn.named_parameters()))

    def _load(self, rows):
        rows = np.asarray(rows)
        self.tower_images += len(np.unique(rows))
        return self.bank[rows % len(self.bank)]

    def _instrument(self):
        """Times each ``prepare_batch`` (the instance's bound method,
        wrapped) and, during the check's steps, keeps the edges it drew
        and the losses of ``train_prepared``."""
        t = self.trainer
        prepare, train = t.prepare_batch, t.train_prepared

        def timed_prepare(pos_from, pos_to):
            t0 = time.perf_counter()
            out = prepare(pos_from, pos_to)
            self.prep_s.append(time.perf_counter() - t0)
            if self.recording:
                self.recorded_ids.append(out[1:5])
            return out

        def counted_train(prepared):
            out = train(prepared)
            self.steps += 1
            if self.recording:
                self.recorded_losses.append(out[0])
            return out

        t.prepare_batch = timed_prepare
        t.train_prepared = counted_train

    def _draw(self, n_edges: int) -> np.ndarray:
        """`n_edges` edges drawn for an epoch; during the check, the
        steps' positive edges kept in the order the epoch takes them
        (``epoch_edge_order``: one permutation of its rng)."""
        drawn = self.edges[self.edge_rng.randint(0, len(self.edges),
                                                 n_edges)]
        if self.recording:
            r = np.random.RandomState()
            r.set_state(self.order_rng.get_state())
            ordered = drawn[r.permutation(len(drawn))]
            for b in range(0, len(ordered), self.batch):
                e = ordered[b:b + self.batch]
                self.check_edges.append((e[:, 0], e[:, 1]))
        return drawn

    def _epoch(self, n_edges: int) -> int:
        """One ``train_epoch`` over `n_edges` drawn edges."""
        drawn = self._draw(n_edges)
        self.trainer.train_edges = drawn
        n0, c0, t0 = len(self.prep_s), time.thread_time(), time.perf_counter()
        out = self.trainer.train_epoch(self.params["epoch"], self.order_rng)
        # wall, the prefetch thread's prepare_batch and the main thread's
        # CPU seconds: the two threads take turns on the interpreter
        self.epoch_s.append((time.perf_counter() - t0,
                             sum(self.prep_s[n0:]),
                             time.thread_time() - c0))
        self.epoch_losses.append(out["loss"])
        return n_edges // self.batch * self.batch

    def _warm_up(self, rows):
        """One step at each tower batch size in `rows`: every positive
        edge label → image slot, every negative label → label."""
        nl, B = self.tax.n_classes, self.batch
        R = self.config["neg_to_pos_ratio"]
        dev = self.device

        def ids(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=dev)
        for n in rows:
            pix = torch.as_tensor(self.bank[np.arange(n) % len(self.bank)],
                                  device=dev)
            lab = np.arange(B) % nl
            neg = np.arange(2 * R * B) % nl
            self.trainer.train_prepared(
                (pix, ids(lab), ids(nl + np.arange(B)), ids(neg), ids(neg),
                 ids(-np.ones(B)), ids(np.arange(B) % n),
                 ids(-np.ones(2 * R * B)), ids(-np.ones(2 * R * B))))

    # ------------------------------------------------------------------
    def window_start(self) -> None:
        self.trace_start()
        self.epoch_losses, self.epoch_s = [], []

    def trace_start(self) -> None:
        self.prep_s, self.tower_images, self.steps = [], 0, 0

    def step(self) -> int:
        return self._epoch(self.params["epoch_edges"])

    def finish(self) -> None:
        prep = 1e3 * sum(self.prep_s) / max(len(self.prep_s), 1)
        print("[window] epoch seconds " + " ".join(
            f"{s:.3f}" for s, _, _ in self.epoch_s)
            + "; prepare_batch s " + " ".join(
            f"{p:.3f}" for _, p, _ in self.epoch_s)
            + "; main-thread CPU " + " ".join(
            f"{c:.3f}" for _, _, c in self.epoch_s)
            + f"; prepare_batch {prep:.3f} ms, {self.tower_images} tower "
              f"images in {self.steps} steps", file=sys.stderr)

    def failed(self) -> int:
        per_epoch = self.params["epoch_edges"] // self.batch * self.batch
        return per_epoch * sum(not np.isfinite(l) for l in self.epoch_losses)

    def rates(self, window_s: float, units: int) -> dict:
        return {"joint_edges_per_s": units / window_s}

    def info(self) -> dict:
        return {"steps": self.steps, "tower_images": self.tower_images,
                "prep_s": self.prep_s, "image_size": self.config["image_size"],
                "n_out": self.config["embedding_dim"]}

    def free(self) -> None:
        self.trainer = None
        self.recorded_ids, self.recorded_losses = [], []

    def _reference(self, q=identity) -> dict:
        c = self.config
        graph = Graph(observed_closure(self.paths_global, self.tax.n_classes),
                      self.paths_global, self.tax.level_start,
                      self.tax.level_stop)
        return hypcone.joint_steps(
            self._tower0(), self._table0(), graph, self.check_edges,
            np.random.RandomState(inputs.sub_seed(self.seed, "program")),
            self.bank, self.device, K=c["K"], alpha=c["alpha"],
            neg_to_pos_ratio=c["neg_to_pos_ratio"], lr_labels=c["lr_labels"],
            lr_images=c["lr_images"], bucket=self.batch, q=q)

    def check(self) -> dict:
        ref = self._reference()
        self.details = checks.worst_leaves(self.program, ref)
        numbers = checks.training_numbers(self.program, ref)
        numbers["label_change_gap"] = checks.vector_gap(
            self.program["label_change"], ref["label_change"],
            ref["label_rms"])
        # the edges each step trained on: positives and drawn negatives
        mismatch = abs(len(self.program_ids) - len(ref["negatives"]))
        for got, (pf, pt), (nf, nt) in zip(self.program_ids,
                                           self.check_edges,
                                           ref["negatives"]):
            for a, b in zip(got, (pf, pt, nf, nt)):
                mismatch += (int((a != b).sum()) if a.shape == b.shape
                             else max(len(a), len(b)))
        numbers["edges_mismatch"] = float(mismatch)
        return numbers

    def control(self, q=fp8_round) -> dict:
        """The check's numbers with the reference in fp8 in the program's
        place (after ``make_inputs``): the same edges and negatives."""
        self.recording, self.check_edges = True, []
        for n in (1, self.params["check_steps"] - 1):
            self._draw(n * self.batch)
        self.recording = False
        ctl, ref = self._reference(q), self._reference()
        self.details = checks.worst_leaves(ctl, ref)
        numbers = checks.training_numbers(ctl, ref)
        numbers["label_change_gap"] = checks.vector_gap(
            ctl["label_change"], ref["label_change"], ref["label_rms"])
        numbers["edges_mismatch"] = 0.0
        return numbers
