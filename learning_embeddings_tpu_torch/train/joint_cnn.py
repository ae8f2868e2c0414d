"""End-to-end CNN joint trainer, the ``--use_CNN`` path: the port of
``learning_embeddings_tpu/train/joint_cnn.py``.

Image embeddings come from a CNN tower on raw pixels (``FeatCNN``), trained
jointly with the label table. One step is:

1. on the host, negatives are sampled by the numpy sampler
   (``sample_joint_negatives_np`` from the trainer's ``RandomState``), the
   unique images of the batch are gathered once and padded to a bucket with
   ``np.resize`` (which repeats rows from the start), and each endpoint gets
   its image slot, or −1 for a label (``prepare_batch``);
2. on the device, the uint8 pixels scale to [0, 1], the tower runs once
   over the padded unique images with train-mode BatchNorm (the repeated
   rows take part in its statistics; its reductions are the kernels of
   ``ops/bn_triton.py`` on the card), and each endpoint picks an image
   embedding by slot or a label embedding by id; the loss (``variant_loss``
   in f32) and the optimizer step (``train_prepared``). The image tower
   takes a ``torch.optim.Adam`` step at ``lr_images``; the labels, by
   ``optimizer_labels``:
   - ``adam``: a group of the same Adam at ``lr_labels``; under
     ``hyp_cone`` this is the reference's hybrid: the label gradients are
     rescaled by (1/λ)² before the step and the table is projected into
     the Poincaré annulus after it;
   - ``rsgd`` (``hyp_cone`` only): ``RiemannianSGD``, no projection;
   - ``radam`` (``hyp_cone`` only): ``RiemannianAdam``, then the
     projection.

The eval (``classification_metrics``, ``edge_metrics``, ``reconstruction``)
takes its all-pairs energies from ``geometry/pairwise.py``: with the order
energy, the kernel of ``ops/pairwise_order.py`` on the card; the cone
energies through their Gram form.

Ported: the ``order``, ``euc_cone`` and ``hyp_cone`` energies with every
label optimizer, every backbone of ``models/resnet.py``, ``remat`` and
``bn_stats_dtype`` (the tower's trunk options), the warm start of the
tower's trunk from a classifier checkpoint (``load_tower_trunk``), and
meshes.

On a mesh (``mesh=``, as the JAX package's GSPMD step): every rank draws
the global batch's negatives from the same ``RandomState`` and loads the
same padded unique images (bucketed to a multiple of lcm(bucket,
n_data)), then keeps its block of the images and of the edge slots over
'data'. Each rank runs the tower on its images, with the BatchNorm
statistics of the global tower batch, and the embeddings are gathered to
every rank with a gradient that flows back to the rank that owns each
image. The label table and the tower are replicated; the gradients are
summed over 'data' (the losses are sums). The eval embeddings shard over
'data' too, and the ranking and reconstruction tile their energies over
the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import prefetch_one
from ..eval.ranking import joint_classification_metrics
from ..eval.reconstruction import reconstruction_metrics
from ..losses.joint_sampling import (JointGraph, filter_stage_edges,
                                     sample_joint_negatives_np)
from ..losses.margin import variant_loss
from ..models.embedder import FeatCNN, LabelEmbedder
from ..models.resnet import init_params_
from ..ops.bn import set_batch_norm_group
from ..ops.image import device_scale
from ..parallel.mesh import (all_gather_rows, check_batch_divides,
                             gather_rows, global_step_outputs, shard_rows)
from ..utils import profiling
from .classifier import mesh_or_device, to_device
from .joint import (DEFAULT_CURRICULUM, DEFAULT_K, JOINT_MODE,
                    JointOptimization, check_joint_options,
                    curriculum_levels_for_epoch, detached, epoch_edge_order,
                    joint_edge_metrics, load_label_table)

__all__ = ["JointCNNConfig", "JointCNNTrainer"]

@dataclasses.dataclass
class JointCNNConfig:
    energy: str = "hyp_cone"            # order | euc_cone | hyp_cone
    backbone: str = "resnet50"
    embedding_dim: int = 10
    image_size: int = 448
    lr_labels: float = 1e-2
    lr_images: float = 1e-3
    batch_size: int = 10
    neg_to_pos_ratio: int = 5
    alpha: float = 0.05
    optimizer_labels: str = "adam"
    pick_per_level: bool = True
    levels_to_hide: Tuple[int, ...] = ()
    hide_levels: bool = False           # the reference's curriculum
    curriculum: Optional[Dict[int, Tuple[int, ...]]] = None
    half_half: bool = False             # 50/50 (l,l)/(l,img) edge resample
    loss_variant: str = "margin"        # margin | vendrov | nll
    seed: int = 0
    K: Optional[float] = None
    tower_dtype: str = "bfloat16"  # the trunk's activations; params are f32
    bn_stats_dtype: str = "float32"  # 'bfloat16' = bf16 BN statistics
    #   in the tower (GhostBatchNorm over all rows)
    pixel_bucket: Optional[int] = None  # unique-image pad granularity;
    #   default batch_size
    prefetch: bool = True  # overlap host batch prep with the device step
    #   through a one-deep background thread
    inflight_steps: int = 4  # wait for the loss this many steps back, so
    #   at most this many steps' inputs stay queued on the device
    remat: bool = False  # recompute the tower's residual blocks in the
    #   backward pass (activation memory against recompute)
    freeze_bn: bool = False  # eval-mode BN in the tower (runs no BN kernel)
    freeze_images: bool = False  # only the tower's `fc` trains; the trunk's
    #   running statistics still move in train mode
    device: str = "cuda"
    # The JAX config's `donate` has no counterpart: the torch step updates
    # parameters and optimizer state in place.


class JointCNNTrainer(JointOptimization):
    def __init__(self, labelmap, graph: JointGraph, train_edges: np.ndarray,
                 pixel_loader: Callable[[np.ndarray], np.ndarray],
                 cfg: JointCNNConfig, mesh=None):
        """pixel_loader(image_rows) -> (n, S, S, 3) uint8 (or f32 in
        [0, 1]) NHWC pixels, a numpy array or a tensor on any device.
        mesh: a ``parallel.mesh.Mesh`` or None."""
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
        self.pixel_loader = pixel_loader

        gen = torch.Generator().manual_seed(cfg.seed)
        self.embedder = LabelEmbedder(graph.n_labels, cfg.embedding_dim,
                                      mode=mode, K=self.K, generator=gen)
        self.featcnn = FeatCNN(cfg.backbone, cfg.embedding_dim, mode=mode,
                               K=self.K,
                               dtype=getattr(torch, cfg.tower_dtype),
                               remat=cfg.remat,
                               bn_stats_dtype=cfg.bn_stats_dtype)
        init_params_(self.featcnn, gen)
        self.embedder.to(self.device)
        self.featcnn.to(device=self.device,
                        memory_format=torch.channels_last)
        if mesh is not None:
            set_batch_norm_group(self.featcnn, mesh.data_group)
        if cfg.freeze_images:
            # feature-extracting tower: only `fc` trains (the JAX
            # package's set_to_zero route for the trunk)
            self.featcnn.trunk.requires_grad_(False)
        self._init_optimizers(p for p in self.featcnn.parameters()
                              if p.requires_grad)
        self._energy_kw = {} if self.K is None else {"K": self.K}
        self._rng = np.random.RandomState(cfg.seed)
        self.optimal_threshold = None
        # no explicit curriculum: a plain levels_to_hide config is a
        # single-stage curriculum (train_epoch re-applies it every epoch)
        self.curriculum = (cfg.curriculum if cfg.curriculum is not None
                           else (DEFAULT_CURRICULUM if cfg.hide_levels
                                 else {0: tuple(cfg.levels_to_hide)}))

    # ------------------------------------------------------------------
    def load_embedding_table(self, table: np.ndarray) -> None:
        """Warm-start the label table (--load_emb_from); under hyp_cone a
        table outside the annulus is rescaled into it first."""
        load_label_table(self.embedder.parameters(), table, self.cfg.energy,
                         self.K)

    def load_tower_trunk(self, trunk_params, trunk_stats) -> None:
        """Warm-start the image tower's trunk from a finetuned classifier:
        `trunk_params` and `trunk_stats` map the names of the classifier
        trunk's parameters and buffers, relative to the trunk (a
        classifier payload's ``trunk.*`` entries without the prefix), to
        tensors. The projection head ``fc`` stays freshly initialised: the
        classifier's head has classifier shapes. Both models build the
        trunk from the same ``BACKBONES`` entry, so the names line up."""
        trunk = self.featcnn.trunk
        cur = set(dict(trunk.named_parameters())) | set(
            dict(trunk.named_buffers()))
        new = set(trunk_params) | set(trunk_stats)
        if cur != new:
            raise ValueError(
                f"trunk param mismatch: only-ours={sorted(cur - new)[:4]} "
                f"only-theirs={sorted(new - cur)[:4]} (stem/backbone must "
                f"match the classifier's)")
        trunk.load_state_dict({**trunk_params, **trunk_stats}, strict=True)

    def levels_for_epoch(self, epoch: int) -> Tuple[int, ...]:
        return curriculum_levels_for_epoch(self.curriculum, epoch)

    def checkpoint_payload(self) -> Dict:
        """params, batch_stats, opt_state (the Adam's; with rsgd or radam
        also label_opt_state) and optimal_threshold, NaN for none."""
        payload = {
            "params": {"labels": detached(self.embedder.state_dict()),
                       "images": detached(dict(
                           self.featcnn.named_parameters()))},
            "batch_stats": detached(dict(self.featcnn.named_buffers())),
            "opt_state": self.optimizer.state_dict(),
            "optimal_threshold": (
                float("nan") if self.optimal_threshold is None
                else float(self.optimal_threshold))}
        if self.label_optimizer is not None:
            payload["label_opt_state"] = self.label_optimizer.state_dict()
        return payload

    def restore_payload(self, payload: Dict) -> None:
        self.embedder.load_state_dict(payload["params"]["labels"])
        self.featcnn.load_state_dict({**payload["params"]["images"],
                                      **payload["batch_stats"]}, strict=True)
        self.optimizer.load_state_dict(payload["opt_state"])
        if self.label_optimizer is not None:
            self.label_optimizer.load_state_dict(payload["label_opt_state"])
        thr = float(payload["optimal_threshold"])
        self.optimal_threshold = None if np.isnan(thr) else thr

    # ------------------------------------------------------------------
    def prepare_batch(self, pos_from: np.ndarray, pos_to: np.ndarray):
        """Host side of one step: negative sampling, unique-pixel gather,
        slot indexing. Returns the argument tuple of `train_prepared`, on
        the trainer's device: on a mesh this rank's block of the pixels
        and of the edges (the slots index the global unique images)."""
        g = self.graph
        nl = g.n_labels
        with profiling.span("joint.sample"):
            nf, nt = sample_joint_negatives_np(
                g, self.cfg.neg_to_pos_ratio, self._rng, pos_from, pos_to,
                pick_per_level=self.cfg.pick_per_level,
                levels_to_hide=self.cfg.levels_to_hide)
        all_ids = np.concatenate([pos_from, pos_to, nf, nt])
        img_rows = np.unique(all_ids[all_ids >= nl]) - nl
        if len(img_rows) == 0:
            img_rows = np.zeros((1,), np.int64)   # one dummy image
        # pad the unique-image count to a multiple of the bucket: the pad
        # repeats rows from the start, and they enter the BN statistics
        q = self.cfg.pixel_bucket or self.cfg.batch_size
        if self.mesh is not None:
            q = math.lcm(q, self.mesh.n_data)
        bucket = -(-len(img_rows) // q) * q
        padded = np.resize(img_rows, bucket)
        # every rank loads the same images (one draw of any augmentation)
        # and keeps its block
        pixels = shard_rows(self.pixel_loader(padded), self.mesh)

        def pix_idx(ids):
            # img_rows is sorted and unique: slot lookup by searchsorted
            ids = np.asarray(ids)
            rows = ids - nl
            slots = np.searchsorted(img_rows, rows)
            slots = np.minimum(slots, len(img_rows) - 1)
            valid = (ids >= nl) & (img_rows[slots] == rows)
            return np.where(valid, slots, -1)

        ids = [pos_from, pos_to, nf, nt]
        return (to_device(pixels, self.device),
                *(to_device(shard_rows(np.asarray(a), self.mesh),
                            self.device, torch.int64) for a in ids),
                *(to_device(shard_rows(pix_idx(a), self.mesh), self.device,
                            torch.int64) for a in ids))

    def _loss(self, pixels, pf, pt, nf, nt, pix_pf, pix_pt, pix_nf, pix_nt):
        cfg = self.cfg
        nl = self.graph.n_labels
        self.featcnn.train(not cfg.freeze_bn)
        # NHWC (the JAX layout) → NCHW view, channels_last in memory
        img_embs = self.featcnn(device_scale(pixels).permute(0, 3, 1, 2))
        if self.mesh is not None:
            # every rank's edges may read every rank's images
            img_embs = gather_rows(img_embs, self.mesh.data_group,
                                   reduce_grad=True, tag="tower_embeddings")

        def emb(ids, pix):
            lab = self.embedder(torch.clamp_max(ids, nl - 1))
            img = img_embs[torch.clamp_min(pix, 0)]
            return torch.where((pix >= 0)[:, None], img, lab)

        return variant_loss(
            cfg.loss_variant, emb(pf, pix_pf), emb(pt, pix_pt),
            emb(nf, pix_nf), emb(nt, pix_nt), energy=cfg.energy,
            alpha=cfg.alpha, neg_to_pos_ratio=cfg.neg_to_pos_ratio,
            **self._energy_kw)

    def train_prepared(self, prepared):
        """Device side of one step. Returns (loss, e_pos, e_neg) of the
        global batch as device tensors: the caller decides when to wait for
        them."""
        loss, (e_pos, e_neg) = self._loss(*prepared)
        self._update(loss)
        return global_step_outputs(self.mesh, loss.detach(), e_pos.detach(),
                                   e_neg.detach())

    def train_batch(self, pos_from: np.ndarray, pos_to: np.ndarray):
        """One step: host prep + update. Returns (loss, e_pos, e_neg)."""
        loss, e_pos, e_neg = self.train_prepared(
            self.prepare_batch(pos_from, pos_to))
        return float(loss), e_pos, e_neg

    def set_levels_to_hide(self, levels: Tuple[int, ...]) -> None:
        """Curriculum stage switch: hidden levels are excluded from
        negative sampling, and their edges from the epoch."""
        self.cfg = dataclasses.replace(self.cfg,
                                       levels_to_hide=tuple(levels))

    def train_epoch(self, epoch: int, rng: np.random.RandomState):
        """One epoch over the current curriculum stage; returns the loss
        sum and the mean energies."""
        self.set_levels_to_hide(self.levels_for_epoch(epoch))
        stage = filter_stage_edges(self.graph, self.train_edges,
                                   self.cfg.levels_to_hide)
        edges = epoch_edge_order(self.graph, stage, rng, self.cfg.half_half)
        bs = self.cfg.batch_size
        if len(edges) < bs:
            edges = np.resize(edges, (bs, 2))
        nb = max(len(edges) // bs, 1)

        def prepared_batches():
            for b in range(nb):
                e = edges[b * bs:(b + 1) * bs]
                yield self.prepare_batch(e[:, 0], e[:, 1])

        batches = prepared_batches()
        if self.cfg.prefetch:
            # host prep of batch k+1 overlaps the device step of batch k
            batches = prefetch_one(batches)
        # wait on the loss K steps back: the host runs ahead of the device
        # by at most K steps, whose inputs stay allocated until they run
        losses, eps, ens = [], [], []
        K = max(self.cfg.inflight_steps, 1)
        try:
            for _ in range(nb):
                with profiling.span("joint.wait_batch"):
                    prepared = next(batches)
                with profiling.span("joint.launch"):
                    loss, e_pos, e_neg = self.train_prepared(prepared)
                    losses.append(loss)
                    eps.append(e_pos.mean())
                    ens.append(e_neg.mean())
                if len(losses) % K == 0:
                    losses[-K].item()
        finally:
            batches.close()
        return {"loss": float(torch.stack(losses).sum()),
                "e_pos_mean": float(torch.stack(eps).mean()),
                "e_neg_mean": float(torch.stack(ens).mean())}

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def image_embeddings_for_rows(self, rows, loader=None,
                                  batch_size: int = 32) -> np.ndarray:
        """Embed image rows through the tower in chunks of `batch_size`;
        the ragged tail is padded to a whole chunk with np.resize
        (harmless: BN runs in eval mode). On a mesh each chunk shards over
        'data', so the chunk size rounds up to a multiple of the data
        shards. Returns (n, dim) numpy."""
        loader = loader or self.pixel_loader
        rows = np.asarray(rows)
        if self.mesh is not None:
            q = self.mesh.n_data
            batch_size = -(-batch_size // q) * q
        out = []
        for i in range(0, len(rows), batch_size):
            chunk = rows[i:i + batch_size]
            n = len(chunk)
            if n < batch_size:
                chunk = np.resize(chunk, batch_size)
            emb = self.image_embeddings_from_pixels(loader(chunk))
            out.append(emb[:n].cpu().numpy())
        return np.concatenate(out)

    @torch.no_grad()
    def image_embeddings_from_pixels(self, pixels) -> torch.Tensor:
        """Eval forward of the tower (eval-mode BN) on NHWC pixels; on a
        mesh each rank embeds its block over 'data' and the embeddings are
        gathered (the row count must divide over the data shards)."""
        self.featcnn.eval()
        x = device_scale(to_device(shard_rows(pixels, self.mesh),
                                   self.device))
        emb = self.featcnn(x.permute(0, 3, 1, 2))
        if self.mesh is None:
            return emb
        return all_gather_rows(emb, self.mesh.data_group, "eval_embeddings")

    @torch.no_grad()
    def label_embeddings(self) -> torch.Tensor:
        return self.embedder(torch.arange(self.graph.n_labels,
                                          device=self.device))

    def classification_metrics(self, img_paths_global, image_embs,
                               ks=(1, 3, 5)):
        """hit@k / m-F1 of ranking labels per image by energy."""
        return joint_classification_metrics(
            self.label_embeddings(), image_embs,
            np.asarray(img_paths_global), self.labelmap,
            energy=self.cfg.energy, ks=ks, mesh=self.mesh, **self._energy_kw)

    def edge_metrics(self, img_paths_global, image_embs, *,
                     threshold=None, seed: int = 17):
        """Edge-classification F1 on a held-out split. threshold=None
        sweeps the best F1 (val); a float reuses it (test)."""
        return joint_edge_metrics(
            self.label_embeddings(), image_embs, img_paths_global,
            self.graph, energy=self.cfg.energy,
            neg_to_pos_ratio=self.cfg.neg_to_pos_ratio,
            pick_per_level=self.cfg.pick_per_level,
            seed=seed + self.cfg.seed, threshold=threshold,
            **self._energy_kw)

    def reconstruction(self, threshold=None):
        nl = self.labelmap.n_classes
        return reconstruction_metrics(
            self.label_embeddings()[:nl],
            self.graph.label_closure[:nl, :nl],
            energy=self.cfg.energy, threshold=threshold, mesh=self.mesh,
            **self._energy_kw)

