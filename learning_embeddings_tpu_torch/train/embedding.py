"""Label-hierarchy embedding trainer: the port of
``learning_embeddings_tpu/train/embedding.py``.

* the edge splits, closure and negative adjacency come from
  ``hierarchy.split_edges``;
* every step samples its negatives on the device
  (``losses.margin.make_negative_sampler``, from the trainer's device
  ``torch.Generator``), computes the margin loss and takes one optimizer
  step: ``rsgd`` (``RiemannianSGD``), ``radam`` (``RiemannianAdam``, then
  the annulus projection), ``adam`` or ``sgd`` with momentum 0.9; under
  ``hyp_cone`` the last two are the hybrid (gradients rescaled by (1/λ)²,
  the step, the annulus projection);
* ``lr_steps`` decay the lr at epoch boundaries counted in steps
  (epoch × steps_per_epoch), through ``torch.optim.lr_scheduler``;
* an epoch is a loop of device steps over the shuffled train edges; the
  host waits for the device only at its end (the JAX package runs it as
  one ``lax.scan``);
* ``evaluate`` calibrates the best-F1 threshold on val and reuses it on
  test, over negatives drawn once per split; ``reconstruction`` checks
  the label closure from the all-pairs energies (for the order energy,
  the kernel of ``ops/pairwise_order.py`` on the card).

On a mesh (``mesh=``) every rank draws the global batch's negatives from
the same generator and keeps its block of the edges (the 'data' shard:
its positives and their negatives); the table and the optimizer are
replicated and the gradients summed over 'data' (the loss is a sum), so a
step equals the one-device step. The reconstruction tiles its energies
over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..eval import (best_threshold_metrics, reconstruction_metrics,
                    threshold_metrics)
from ..geometry import ENERGY_FNS, inner_radius
from ..hierarchy import EdgeSplits, LabelMap
from ..losses.margin import (degree_neg_weights, level_weights_for_nodes,
                             make_negative_sampler, margin_loss)
from ..models.embedder import LabelEmbedder
from ..optim import (RiemannianAdam, RiemannianSGD, project_annulus_,
                     scale_by_conformal_factor_)
from ..parallel.mesh import (all_reduce_grads_, check_batch_divides,
                             global_step_outputs, shard_rows)
from .classifier import mesh_or_device

__all__ = ["EmbeddingTrainerConfig", "EmbeddingTrainer", "ENERGY_TO_MODE",
           "ENERGY_DEFAULT_K"]

ENERGY_TO_MODE = {"order": "euclidean", "euc_cone": "euc_cone",
                  "hyp_cone": "hyp_cone"}
ENERGY_DEFAULT_K = {"order": None, "euc_cone": 3.0, "hyp_cone": 0.1}
OPTIMIZERS = ("rsgd", "radam", "adam", "sgd")


@dataclasses.dataclass
class EmbeddingTrainerConfig:
    energy: str = "hyp_cone"
    embedding_dim: int = 10
    lr: float = 0.1
    batch_size: int = 10
    neg_to_pos_ratio: int = 5
    alpha: float = 1.0
    optimizer: str = "rsgd"          # rsgd | radam | adam | sgd
    pick_per_level: bool = False
    level_weights: Optional[Tuple[float, ...]] = None
    weigh_pos_term: bool = False   # level weights on the positive term
    #   only (by default negatives take their positive edge's weight)
    weigh_neg_term: bool = False   # negatives weigh n_nodes/ratio ×
    #   1/deg_tc(corrupted node)
    seed: int = 0
    K: Optional[float] = None        # default per energy
    lr_steps: Tuple[int, ...] = ()   # epochs where lr ×= lr_decay
    lr_decay: float = 0.1
    steps_per_epoch: int = 0         # 0: len(train) // batch_size
    device: str = "cuda"
    # The JAX config's `donate` has no counterpart: the torch step updates
    # the table and the optimizer state in place.


class EmbeddingTrainer:
    """Host-side epoch loop around device steps."""

    def __init__(self, labelmap: LabelMap, splits: EdgeSplits,
                 config: EmbeddingTrainerConfig, mesh=None):
        cfg = config
        self.device = mesh_or_device(mesh, cfg.device)
        check_batch_divides(cfg.batch_size, mesh)
        self.mesh = mesh
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}; "
                             f"expected one of {OPTIMIZERS}")
        if cfg.optimizer in ("rsgd", "radam") and cfg.energy != "hyp_cone":
            raise ValueError(f"{cfg.optimizer} requires the hyperbolic-cone "
                             "energy (it steps on the Poincaré ball)")
        self.labelmap = labelmap
        self.splits = splits
        self.cfg = cfg
        self.K = cfg.K if cfg.K is not None else ENERGY_DEFAULT_K[cfg.energy]
        self.n_nodes = n = splits.negatives.shape[0]
        self.model = LabelEmbedder(
            n, cfg.embedding_dim, mode=ENERGY_TO_MODE[cfg.energy], K=self.K,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.sampler = make_negative_sampler(
            splits.negatives, cfg.neg_to_pos_ratio,
            level_start=labelmap.level_start, level_stop=labelmap.level_stop,
            pick_per_level=cfg.pick_per_level, device=self.device)
        self.optimizer = self._make_optimizer()
        # lr_steps are epochs; the schedule counts optimizer steps: step k
        # runs at lr × lr_decay ** #{boundaries ≤ k}
        spe = max(cfg.steps_per_epoch,
                  max(len(splits.train) // cfg.batch_size, 1))
        self._boundaries = sorted({int(e) * spe for e in cfg.lr_steps})
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, self._lr_factor)
        hyp = cfg.energy == "hyp_cone"
        self._conformal = hyp and cfg.optimizer in ("adam", "sgd")
        self._project = hyp and cfg.optimizer != "rsgd"
        self._energy_kw = {} if self.K is None else {"K": self.K}
        if cfg.weigh_neg_term:
            tc = np.asarray(splits.closure, bool)
            self._in_deg = torch.as_tensor(tc.sum(0), device=self.device)
            self._out_deg = torch.as_tensor(tc.sum(1), device=self.device)
        self.optimal_threshold = None
        self._eval_negatives: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._epoch_rng: Optional[np.random.RandomState] = None

    # ------------------------------------------------------------------
    def _make_optimizer(self) -> torch.optim.Optimizer:
        cfg = self.cfg
        params = list(self.model.parameters())
        if cfg.optimizer == "rsgd":
            return RiemannianSGD(params, lr=cfg.lr, K=self.K)
        if cfg.optimizer == "radam":
            return RiemannianAdam(params, lr=cfg.lr, K=self.K)
        if cfg.optimizer == "adam":   # optax.adam's defaults
            return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)

    def _lr_factor(self, k: int) -> float:
        return self.cfg.lr_decay ** sum(k >= b for b in self._boundaries)

    def _loss(self, pos_from, pos_to, neg_from, neg_to):
        cfg = self.cfg
        pw = nw = None
        if cfg.level_weights is not None:
            pw = level_weights_for_nodes(pos_to, self.labelmap.level_stop,
                                         cfg.level_weights)
            if not cfg.weigh_pos_term:
                # negatives take their positive edge's level weight
                nw = pw.repeat_interleave(2 * cfg.neg_to_pos_ratio)
        if cfg.weigh_neg_term:
            dw = degree_neg_weights(neg_from, neg_to, self._in_deg,
                                    self._out_deg, cfg.neg_to_pos_ratio,
                                    self.n_nodes)
            nw = dw if nw is None else nw * dw
        f = self.model
        return margin_loss(f(pos_from), f(pos_to), f(neg_from), f(neg_to),
                           energy=cfg.energy, alpha=cfg.alpha,
                           pos_weights=pw, neg_weights=nw,
                           **self._energy_kw)

    def _ids(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a.astype(np.int64))
        return a.to(self.device, torch.int64)

    def train_step(self, pos_from, pos_to, neg_from, neg_to):
        """One optimizer step from the given positives and negatives
        (arrays or tensors of node ids; on a mesh the global batch, of
        which this rank takes its block). Returns (loss, e_pos, e_neg) of
        the global batch as device tensors."""
        loss, (e_pos, e_neg) = self._loss(
            *(self._ids(shard_rows(a, self.mesh))
              for a in (pos_from, pos_to, neg_from, neg_to)))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            all_reduce_grads_(self.model.parameters(), self.mesh.data_group,
                              average=False)
        if self._conformal:
            scale_by_conformal_factor_(self.model.parameters())
        self.optimizer.step()
        self.scheduler.step()
        if self._project:
            project_annulus_(self.model.parameters(), self.K)
        return global_step_outputs(self.mesh, loss.detach(), e_pos.detach(),
                                   e_neg.detach())

    def train_batch(self, pos_from, pos_to):
        """One step with negatives drawn on the device."""
        pf, pt = self._ids(pos_from), self._ids(pos_to)
        return self.train_step(pf, pt, *self.sampler.sample(self.generator,
                                                            pf, pt))

    # ------------------------------------------------------------------
    def _batched_train_edges(self, rng: np.random.RandomState):
        edges = self.splits.train
        perm = rng.permutation(len(edges))
        bs = self.cfg.batch_size
        n_batches = max(len(edges) // bs, 1)
        take = n_batches * bs
        idx = perm[:take] if take <= len(edges) else np.resize(perm, take)
        e = self._ids(edges[idx].reshape(n_batches, bs, 2))
        return e[..., 0], e[..., 1]

    def train_epoch(self, epoch_rng: Optional[np.random.RandomState] = None):
        """One pass over the shuffled train edges (the ragged tail is
        dropped); returns the loss sum and the mean energies."""
        if epoch_rng is None:
            # one RandomState across calls: a fresh RandomState(seed) per
            # epoch would repeat the same permutation every epoch
            if self._epoch_rng is None:
                self._epoch_rng = np.random.RandomState(self.cfg.seed)
            epoch_rng = self._epoch_rng
        pf, pt = self._batched_train_edges(epoch_rng)
        losses, eps, ens = [], [], []
        for b in range(pf.shape[0]):
            loss, e_pos, e_neg = self.train_batch(pf[b], pt[b])
            losses.append(loss)
            eps.append(e_pos)
            ens.append(e_neg)
        return {"loss": float(torch.stack(losses).sum()),
                "e_pos_mean": float(torch.stack(eps).mean()),
                "e_neg_mean": float(torch.stack(ens).mean())}

    # ------------------------------------------------------------------
    def checkpoint_payload(self) -> dict:
        """params, opt_state (optimizer and schedule) and
        optimal_threshold, NaN for "no calibrated threshold yet" (0.0 is a
        legitimate threshold for cone energies)."""
        return {"params": {k: v.detach() for k, v in
                           self.model.state_dict().items()},
                "opt_state": {"optimizer": self.optimizer.state_dict(),
                              "scheduler": self.scheduler.state_dict()},
                "optimal_threshold": (
                    float("nan") if self.optimal_threshold is None
                    else float(self.optimal_threshold))}

    def restore_payload(self, payload: dict) -> None:
        self.model.load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"]["optimizer"])
        self.scheduler.load_state_dict(payload["opt_state"]["scheduler"])
        thr = float(payload["optimal_threshold"])
        self.optimal_threshold = None if np.isnan(thr) else thr

    # ------------------------------------------------------------------
    def load_embedding_table(self, table: np.ndarray) -> None:
        """Warm start from an external table (--load_cosine_emb /
        --load_emb_from). Under hyp_cone the rows are always rescaled into
        the annulus: norms map linearly onto r0 + (1 − 2·r0)·‖x‖/max‖x‖."""
        table = np.asarray(table, np.float32)
        if self.cfg.energy == "hyp_cone":
            r0 = inner_radius(self.K)
            norms = np.maximum(np.linalg.norm(table, axis=1, keepdims=True),
                               1e-12)
            table = table / norms * (r0 + (1 - 2 * r0) * norms / norms.max())
        with torch.no_grad():
            for p in self.model.parameters():
                if tuple(p.shape) == table.shape:
                    p.copy_(torch.as_tensor(table))

    @torch.no_grad()
    def all_embeddings(self) -> torch.Tensor:
        return self.model(torch.arange(self.n_nodes, device=self.device))

    def _edge_set_with_negatives(self, split: str):
        """2·ratio corrupted pairs per positive of a split, drawn once from
        a generator seeded per split."""
        if split not in self._eval_negatives:
            edges = getattr(self.splits, split)
            # a fixed per-split seed (python's hash() is randomized)
            salt = int.from_bytes(split.encode(), "little") % (2**20)
            gen = torch.Generator(device=self.device).manual_seed(
                salt + self.cfg.seed)
            nf, nt = self.sampler.sample(gen, self._ids(edges[:, 0]),
                                         self._ids(edges[:, 1]))
            self._eval_negatives[split] = (nf.cpu().numpy(),
                                           nt.cpu().numpy())
        return self._eval_negatives[split]

    def evaluate(self, split: str):
        """Energies of a split's positives and its negatives: val sweeps
        the best-F1 threshold and stores it, test reuses it."""
        edges = getattr(self.splits, split)
        nf, nt = self._edge_set_with_negatives(split)
        emb = self.all_embeddings()
        efn = ENERGY_FNS[self.cfg.energy]
        e_pos = efn(emb[self._ids(edges[:, 0])], emb[self._ids(edges[:, 1])],
                    **self._energy_kw)
        e_neg = efn(emb[self._ids(nf)], emb[self._ids(nt)],
                    **self._energy_kw)
        if split == "test" and self.optimal_threshold is not None:
            return threshold_metrics(e_pos, e_neg, self.optimal_threshold)
        m = best_threshold_metrics(e_pos, e_neg)
        if split == "val":
            self.optimal_threshold = float(m.threshold)
        return m

    def reconstruction(self, threshold: Optional[float] = None):
        """All closure edges against all non-edges of the label subgraph."""
        nl = self.labelmap.n_classes
        return reconstruction_metrics(
            self.all_embeddings()[:nl], self.splits.closure[:nl, :nl],
            energy=self.cfg.energy, threshold=threshold, mesh=self.mesh,
            **self._energy_kw)
