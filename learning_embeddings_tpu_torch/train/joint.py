"""The fc7 joint image + label trainer and the pieces the joint trainers
share: the port of ``learning_embeddings_tpu/train/joint.py``. The
``--use_CNN`` trainer is ``train/joint_cnn.py``.

Node ids: labels are global labelmap indices, train images
``n_labels + row``. ``JointEmbeddingTrainer`` embeds an image as
``FeatNet`` of its precomputed fc7 feature row (one (n_images,
feature_dim) f32 table, moved to the device once), a label as its table
row; a batch's ids go through one unified lookup that computes both
branches and selects by id. One step is, all on the device:

1. negatives from ``make_joint_negative_sampler`` (the trainer's device
   ``torch.Generator``), one sampler per curriculum stage;
2. the loss (``variant_loss``: margin, vendrov or nll);
3. one optimizer step (``JointOptimization``, shared with the
   ``--use_CNN`` trainer). FeatNet takes a ``torch.optim.Adam`` step at
   ``lr_images``; the labels, by ``optimizer_labels``:
   - ``adam``: a group of the same Adam at ``lr_labels``; under
     ``hyp_cone`` the reference's hybrid: the label gradients rescaled
     by (1/λ)² before the step, the table projected into the Poincaré
     annulus after it;
   - ``rsgd`` (``hyp_cone`` only): ``RiemannianSGD``, no projection;
   - ``radam`` (``hyp_cone`` only): ``RiemannianAdam``, then the
     projection.

An epoch orders its edges on the host (the numpy ``RandomState`` passed
in, as the JAX package does), copies them to the device once and loops
over device steps; the losses and energies are summed on the device and
read once, at its end (the JAX package runs the epoch as one
``lax.scan``). The eval takes its all-pairs energies from
``geometry/pairwise.py``: with the order energy, the kernel of
``ops/pairwise_order.py`` on the card; the cone energies through their
Gram form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..eval import (best_threshold_metrics, reconstruction_metrics,
                    threshold_metrics)
from ..eval.ranking import joint_classification_metrics
from ..geometry import ENERGY_FNS, inner_radius
from ..losses.joint_sampling import (JointGraph, filter_stage_edges,
                                     make_joint_negative_sampler,
                                     sample_joint_negatives_np)
from ..losses.margin import variant_loss
from ..models.embedder import FeatNet, LabelEmbedder
from ..optim import (RiemannianAdam, RiemannianSGD, project_annulus_,
                     scale_by_conformal_factor_)
from ..parallel.mesh import (all_gather_rows, all_reduce_grads_,
                             check_batch_divides, global_step_outputs,
                             shard_rows)
from .classifier import mesh_or_device

__all__ = ["JOINT_MODE", "DEFAULT_K", "DEFAULT_CURRICULUM",
           "epoch_edge_order", "curriculum_levels_for_epoch",
           "load_label_table", "joint_edge_metrics", "check_joint_options",
           "JointOptimization", "JointTrainerConfig",
           "JointEmbeddingTrainer"]

JOINT_MODE = {"order": "euclidean", "euc_cone": "euc_cone",
              "hyp_cone": "hyp_cone_exp0"}
DEFAULT_K = {"order": None, "euc_cone": 3.0, "hyp_cone": 0.1}
# the reference's curriculum of hidden levels, by starting epoch
DEFAULT_CURRICULUM = {0: (1, 2, 3), 20: (2, 3), 50: (3,), 100: ()}


def epoch_edge_order(graph: JointGraph, edges: np.ndarray,
                     rng: np.random.RandomState,
                     half_half: bool) -> np.ndarray:
    """Shuffle; with half_half, resample to 50% (label, label) and 50%
    (label, image) edges."""
    nl = graph.n_labels
    if half_half:
        is_img = edges[:, 1] >= nl
        img_edges = edges[is_img]
        lab_edges = edges[~is_img]
        n = max(len(img_edges), len(lab_edges))
        if len(img_edges) and len(lab_edges):
            take = lambda arr: arr[rng.randint(0, len(arr), n)]
            edges = np.concatenate([take(img_edges), take(lab_edges)])
    return edges[rng.permutation(len(edges))]


def curriculum_levels_for_epoch(curriculum: Dict[int, Tuple[int, ...]],
                                epoch: int) -> Tuple[int, ...]:
    """Hidden levels active at `epoch` (the latest stage whose start is at
    or before it)."""
    current: Tuple[int, ...] = ()
    for start in sorted(curriculum):
        if epoch >= start:
            current = tuple(curriculum[start])
    return current


def load_label_table(params, table: np.ndarray, energy: str,
                     K: Optional[float]) -> None:
    """Warm-start a label-embedding table from an external one, in place:
    `table` must match the shape of exactly one tensor of `params` (an
    iterable of parameters), else this raises. Under ``hyp_cone`` a table
    not already in the Poincaré annulus [r0, 1) (a 2-D cosine embedding,
    say) is first rescaled into it: row norms map linearly onto
    r0 + (1 − 2·r0)·‖x‖ / max‖x‖."""
    table = np.asarray(table, np.float32)
    if energy == "hyp_cone":
        r0 = inner_radius(K)
        norms = np.linalg.norm(table, axis=1, keepdims=True)
        if norms.max() >= 1.0 or norms.min() < r0:
            norms = np.maximum(norms, 1e-12)
            target = r0 + (1 - 2 * r0) * norms / norms.max()
            table = table / norms * target
    table = torch.as_tensor(table)
    hits = [p for p in params if tuple(p.shape) == tuple(table.shape)]
    if len(hits) != 1:
        raise ValueError(
            f"warm-start table shape {tuple(table.shape)} matched "
            f"{len(hits)} label-embedding params (expected exactly 1)")
    with torch.no_grad():
        hits[0].copy_(table)


def joint_edge_metrics(label_emb, image_emb, img_paths_global, graph,
                       *, energy: str, neg_to_pos_ratio: int,
                       pick_per_level: bool, seed: int,
                       threshold=None, **energy_kw):
    """Edge-classification F1 on a held-out split: positives are every
    (ancestor label → image) edge of the split's images; negatives are
    2·ratio corrupted pairs per positive, drawn on the host from
    RandomState(seed) with empty_image_complement='widen'.

    label_emb: (n_labels, d); image_emb: (n_split_images, d), tensors or
    arrays (moved to the labels' device). threshold=None sweeps the best
    F1 (val); a float reuses it (test)."""
    paths = np.asarray(img_paths_global, np.int32)
    nl = graph.n_labels
    split_graph = JointGraph(
        label_closure=graph.label_closure,
        image_paths_global=paths,
        level_start=graph.level_start,
        level_stop=graph.level_stop)
    n_img, L = paths.shape
    pos_from = paths.reshape(-1)
    pos_to = (nl + np.repeat(np.arange(n_img), L)).astype(np.int32)
    rng = np.random.RandomState(seed)
    # widen: a label covering every image of a small split must yield a
    # metric, not fail an eval
    neg_from, neg_to = sample_joint_negatives_np(
        split_graph, neg_to_pos_ratio, rng, pos_from, pos_to,
        pick_per_level=pick_per_level, empty_image_complement="widen")

    lab = torch.as_tensor(label_emb)
    img = torch.as_tensor(image_emb, device=lab.device)

    def emb(ids):
        ids = torch.as_tensor(ids, dtype=torch.int64, device=lab.device)
        lab_e = lab[torch.clamp_max(ids, nl - 1)]
        img_e = img[torch.clamp_min(ids - nl, 0)]
        return torch.where((ids >= nl)[:, None], img_e, lab_e)

    efn = ENERGY_FNS[energy]
    e_pos = efn(emb(pos_from), emb(pos_to), **energy_kw)
    e_neg = efn(emb(neg_from), emb(neg_to), **energy_kw)
    if threshold is None:
        return best_threshold_metrics(e_pos, e_neg)
    return threshold_metrics(e_pos, e_neg, threshold)


def check_joint_options(cfg) -> None:
    """The label optimizers and loss variants the joint trainers accept,
    as the JAX package's do."""
    if cfg.optimizer_labels not in ("adam", "rsgd", "radam"):
        raise ValueError(
            f"unknown optimizer_labels {cfg.optimizer_labels!r}")
    if cfg.optimizer_labels != "adam" and cfg.energy != "hyp_cone":
        raise ValueError(f"{cfg.optimizer_labels} requires the "
                         "hyperbolic-cone energy")
    if cfg.loss_variant == "nll" and cfg.energy != "order":
        # squared-Euclidean distance is meaningless on cone coordinates
        raise ValueError("loss_variant='nll' requires the euclidean "
                         "order energy (--loss order_emb_loss)")


class JointOptimization:
    """The optimizer step both joint trainers take, over their label table
    (``self.embedder``) and image parameters: one ``torch.optim.Adam``
    over the image parameters at ``lr_images``; the labels, by
    ``optimizer_labels``: a first group of that Adam at ``lr_labels``
    (under ``hyp_cone`` the hybrid: gradients rescaled by (1/λ)² before
    the step, the table projected into the annulus after it),
    ``RiemannianSGD`` (no projection) or ``RiemannianAdam`` (then the
    projection)."""

    def _init_optimizers(self, image_params) -> None:
        cfg = self.cfg
        groups = [{"params": list(image_params), "lr": cfg.lr_images}]
        label_params = list(self.embedder.parameters())
        self.label_optimizer = None
        if cfg.optimizer_labels == "adam":
            groups.insert(0, {"params": label_params, "lr": cfg.lr_labels})
        else:
            ball = (RiemannianSGD if cfg.optimizer_labels == "rsgd"
                    else RiemannianAdam)
            self.label_optimizer = ball(label_params, lr=cfg.lr_labels,
                                        K=self.K)
        # optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root
        self.optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999),
                                          eps=1e-8)
        self._optimizers = [o for o in (self.optimizer, self.label_optimizer)
                            if o is not None]
        hyp = cfg.energy == "hyp_cone"
        self._conformal = hyp and cfg.optimizer_labels == "adam"
        self._project = hyp and cfg.optimizer_labels != "rsgd"

    def _update(self, loss: torch.Tensor) -> None:
        for opt in self._optimizers:
            opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            # the losses are sums: the shards' gradients add up
            all_reduce_grads_([p for opt in self._optimizers
                               for g in opt.param_groups
                               for p in g["params"]],
                              self.mesh.data_group, average=False)
        if self._conformal:
            scale_by_conformal_factor_(self.embedder.parameters())
        for opt in self._optimizers:
            opt.step()
        if self._project:
            project_annulus_(self.embedder.parameters(), self.K)


@dataclasses.dataclass
class JointTrainerConfig:
    energy: str = "hyp_cone"            # order | euc_cone | hyp_cone
    embedding_dim: int = 10
    feature_dim: int = 2048
    lr_labels: float = 1e-2
    lr_images: float = 1e-3
    batch_size: int = 10
    neg_to_pos_ratio: int = 5
    alpha: float = 0.05
    optimizer_labels: str = "adam"      # adam | rsgd | radam
    pick_per_level: bool = True
    hide_levels: bool = False           # the reference's curriculum
    curriculum: Optional[Dict[int, Tuple[int, ...]]] = None
    half_half: bool = False             # 50/50 (l,l)/(l,img) edge resample
    seed: int = 0
    K: Optional[float] = None
    loss_variant: str = "margin"        # margin | vendrov | nll
    device: str = "cuda"
    # The JAX config's `donate` has no counterpart: the torch step updates
    # parameters and optimizer state in place.


class JointEmbeddingTrainer(JointOptimization):
    def __init__(self, labelmap, graph: JointGraph, train_edges: np.ndarray,
                 features: np.ndarray, cfg: JointTrainerConfig, mesh=None):
        """train_edges: (E, 2) node-id pairs (label→label and label→image)
        of the train skeleton. features: (n_images, feature_dim) fc7 rows
        of the train images, an array or a tensor. mesh: a
        ``parallel.mesh.Mesh`` or None."""
        check_joint_options(cfg)
        self.device = mesh_or_device(mesh, cfg.device)
        check_batch_divides(cfg.batch_size, mesh)
        self.mesh = mesh
        self.labelmap = labelmap
        self.graph = graph
        self.cfg = cfg
        self.K = cfg.K if cfg.K is not None else DEFAULT_K[cfg.energy]
        mode = JOINT_MODE[cfg.energy]
        self.train_edges = np.asarray(train_edges, np.int32)
        self.features = torch.as_tensor(features, dtype=torch.float32) \
            .to(self.device)

        gen = torch.Generator().manual_seed(cfg.seed)
        self.embedder = LabelEmbedder(graph.n_labels, cfg.embedding_dim,
                                      mode=mode, K=self.K,
                                      generator=gen).to(self.device)
        self.featnet = FeatNet(cfg.feature_dim, cfg.embedding_dim,
                               mode=mode, K=self.K,
                               generator=gen).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self._init_optimizers(self.featnet.parameters())
        self._energy_kw = {} if self.K is None else {"K": self.K}
        self.optimal_threshold = None
        self.curriculum = (cfg.curriculum if cfg.curriculum is not None
                           else (DEFAULT_CURRICULUM if cfg.hide_levels
                                 else {0: ()}))
        self._stage_cache: Dict[Tuple[int, ...], tuple] = {}

    # ------------------------------------------------------------------
    def node_embeddings(self, ids: torch.Tensor) -> torch.Tensor:
        """Unified lookup: the label table's row or FeatNet of the fc7 row,
        selected by id (both branches are computed for every id)."""
        nl = self.graph.n_labels
        lab = self.embedder(torch.clamp_max(ids, nl - 1))
        img = self.featnet(self.features[torch.clamp_min(ids - nl, 0)])
        return torch.where((ids >= nl)[:, None], img, lab)

    def levels_for_epoch(self, epoch: int) -> Tuple[int, ...]:
        return curriculum_levels_for_epoch(self.curriculum, epoch)

    def load_embedding_table(self, table: np.ndarray) -> None:
        """Warm-start the label table (--load_emb_from / --load_cosine_emb);
        under hyp_cone a table outside the annulus is rescaled into it
        first."""
        load_label_table(self.embedder.parameters(), table, self.cfg.energy,
                         self.K)

    def checkpoint_payload(self) -> Dict:
        """params, opt_state (the Adam's; with rsgd or radam also
        label_opt_state) and optimal_threshold, NaN for none (0.0 is a
        legitimate threshold for cone energies)."""
        payload = {
            "params": {"labels": detached(self.embedder.state_dict()),
                       "images": detached(self.featnet.state_dict())},
            "opt_state": self.optimizer.state_dict(),
            "optimal_threshold": (
                float("nan") if self.optimal_threshold is None
                else float(self.optimal_threshold))}
        if self.label_optimizer is not None:
            payload["label_opt_state"] = self.label_optimizer.state_dict()
        return payload

    def restore_payload(self, payload: Dict) -> None:
        self.embedder.load_state_dict(payload["params"]["labels"])
        self.featnet.load_state_dict(payload["params"]["images"])
        self.optimizer.load_state_dict(payload["opt_state"])
        if self.label_optimizer is not None:
            self.label_optimizer.load_state_dict(payload["label_opt_state"])
        thr = float(payload["optimal_threshold"])
        self.optimal_threshold = None if np.isnan(thr) else thr

    def _stage(self, hidden: Tuple[int, ...]):
        """(filtered train edges, sampler) of a curriculum stage."""
        if hidden not in self._stage_cache:
            self._stage_cache[hidden] = (
                filter_stage_edges(self.graph, self.train_edges, hidden),
                make_joint_negative_sampler(
                    self.graph, self.cfg.neg_to_pos_ratio,
                    pick_per_level=self.cfg.pick_per_level,
                    levels_to_hide=hidden, device=self.device))
        return self._stage_cache[hidden]

    # ------------------------------------------------------------------
    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(self.device, torch.int64)

    def train_step(self, pos_from, pos_to, neg_from, neg_to):
        """One optimizer step from the given positives and negatives
        (arrays or tensors of node ids; on a mesh the global batch, of
        which this rank takes its block). Returns (loss, e_pos, e_neg) of
        the global batch as device tensors: the caller decides when to
        wait for them."""
        cfg = self.cfg
        ids = [self._ids(shard_rows(a, self.mesh))
               for a in (pos_from, pos_to, neg_from, neg_to)]
        # one lookup over all four id sets, split after
        emb = self.node_embeddings(torch.cat(ids)).split(
            [len(i) for i in ids])
        loss, (e_pos, e_neg) = variant_loss(
            cfg.loss_variant, *emb, energy=cfg.energy, alpha=cfg.alpha,
            neg_to_pos_ratio=cfg.neg_to_pos_ratio, **self._energy_kw)
        self._update(loss)
        return global_step_outputs(self.mesh, loss.detach(), e_pos.detach(),
                                   e_neg.detach())

    def train_batch(self, pos_from, pos_to, hidden: Tuple[int, ...] = ()):
        """One step with negatives drawn on the device by the sampler of
        the curriculum stage that hides `hidden`."""
        pf, pt = self._ids(pos_from), self._ids(pos_to)
        sampler = self._stage(tuple(hidden))[1]
        return self.train_step(pf, pt, *sampler(self.generator, pf, pt))

    def train_epoch(self, epoch: int, rng: np.random.RandomState):
        """One epoch over the current curriculum stage (the ragged tail is
        dropped; a stage smaller than a batch repeats to one); returns the
        loss sum and the mean energies."""
        hidden = self.levels_for_epoch(epoch)
        edges = epoch_edge_order(self.graph, self._stage(hidden)[0], rng,
                                 self.cfg.half_half)
        bs = self.cfg.batch_size
        if len(edges) < bs:
            edges = np.resize(edges, (bs, 2))
        nb = max(len(edges) // bs, 1)
        e = self._ids(edges[:nb * bs].reshape(nb, bs, 2))
        losses, eps, ens = [], [], []
        for b in range(nb):
            loss, e_pos, e_neg = self.train_batch(e[b, :, 0], e[b, :, 1],
                                                  hidden)
            losses.append(loss)
            eps.append(e_pos)
            ens.append(e_neg)
        return {"loss": float(torch.stack(losses).sum()),
                "e_pos_mean": float(torch.cat(eps).mean()),
                "e_neg_mean": float(torch.cat(ens).mean())}

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def label_embeddings(self) -> torch.Tensor:
        return self.embedder(torch.arange(self.graph.n_labels,
                                          device=self.device))

    @torch.no_grad()
    def image_embeddings(self, features=None) -> torch.Tensor:
        """FeatNet embeddings of fc7 rows (the train features by
        default). On a mesh the rows shard over 'data' (a ragged count is
        padded with the last row, and the padding dropped) and the
        embeddings are gathered."""
        feats = (self.features if features is None else
                 torch.as_tensor(features, dtype=torch.float32)
                 .to(self.device))
        if self.mesh is None or self.mesh.n_data == 1:
            return self.featnet(feats)
        n, q = feats.shape[0], self.mesh.n_data
        padded = torch.cat([feats, feats[-1:].expand((-n) % q, -1)])
        emb = self.featnet(shard_rows(padded, self.mesh))
        return all_gather_rows(emb, self.mesh.data_group,
                               "eval_embeddings")[:n]

    def classification_metrics(self, img_paths_global=None, features=None,
                               ks=(1, 3, 5)):
        """hit@k / m-F1 of ranking labels per image by energy; the train
        images by default."""
        paths = (self.graph.image_paths_global
                 if img_paths_global is None else img_paths_global)
        return joint_classification_metrics(
            self.label_embeddings(), self.image_embeddings(features),
            np.asarray(paths), self.labelmap, energy=self.cfg.energy,
            ks=ks, mesh=self.mesh, **self._energy_kw)

    def reconstruction(self, threshold=None):
        nl = self.labelmap.n_classes
        return reconstruction_metrics(
            self.label_embeddings()[:nl],
            self.graph.label_closure[:nl, :nl],
            energy=self.cfg.energy, threshold=threshold, mesh=self.mesh,
            **self._energy_kw)

    def edge_metrics(self, img_paths_global, features, *, threshold=None,
                     seed: int = 17):
        """Edge-classification F1 on a held-out split with this trainer's
        FeatNet embeddings. threshold=None sweeps the best F1 (val); a
        float reuses it (test)."""
        return joint_edge_metrics(
            self.label_embeddings(), self.image_embeddings(features),
            img_paths_global, self.graph, energy=self.cfg.energy,
            neg_to_pos_ratio=self.cfg.neg_to_pos_ratio,
            pick_per_level=self.cfg.pick_per_level,
            seed=seed + self.cfg.seed, threshold=threshold,
            **self._energy_kw)


def detached(tensors):
    """A state dict's tensors, detached (for checkpoint payloads)."""
    return {k: v.detach() for k, v in tensors.items()}
