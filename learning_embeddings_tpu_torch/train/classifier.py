"""Multi-head CNN classifier trainer: the port of
``learning_embeddings_tpu/train/classifier.py``.

One train step is: uint8 NHWC images scaled on the device, a ResNet trunk
with train-mode BatchNorm (its reductions in the kernels of
``ops/bn_triton.py`` on the card), a criterion-matched f32 head, the
criterion, and Adam (or SGD with momentum 0.9) with the epoch-based step
decay of the JAX package. The criterion picks the head and the scores the
evaluator reads:

| criterion        | head         | eval scores                     |
|------------------|--------------|---------------------------------|
| multi_level_ce   | multi_head   | raw logits                      |
| last_level_ce    | leaf         | bottom-up propagated probs      |
| masked_ce        | multi_head   | predicted-chain-masked logits   |
| multi_label_sm   | multi_head   | raw logits                      |
| hsoftmax         | hsoftmax     | chained log-probs               |

Options as in the JAX package: ``head_override`` ('bottleneck2d'),
``freeze_bn`` (BN in inference mode: no BN kernel runs),
``freeze_trunk`` (only the head is updated; the trunk's parameters take
no gradient, so no backward pass runs through it, while its BN running
statistics still move in train mode), ``grad_accum`` (k micro-batches
average into one optimizer update, as ``optax.MultiSteps`` does; the BN
statistics update on every micro-batch), grayscale input and
``load_backbone_state_dict``; the trunk options ``remat``, ``stem`` and
the BatchNorm routes of ``ops/bn.py``: ``bn_stats_rows`` /
``bn_stats_dtype`` (``GhostBatchNorm``) before ``bn_impl`` ('pallas', the
fused reductions, the port's default; 'flax', the library's BatchNorm).
``backbone="vit_l_16"`` (``models/vit.py``) and ``backbone="swin_l"``
(``models/swin.py``) have no BatchNorm: the BatchNorm options are
accepted and change nothing, the ViT's position embedding and the Swin's
masks are sized by ``image_size``, and each runs on one device (a mesh
of several ranks or ``spatial_partition`` raises ValueError).

On a mesh (``mesh=``, ``parallel/mesh.py``), as the JAX package's GSPMD
step: the batch shards over 'data' (``put_batch`` keeps this rank's rows
of the global batch) and the parameters are replicated, except those
``param_shardings`` shards over 'model' by ``cfg.tp_patterns`` (the
head's ``fc/kernel``: column-parallel when the fan-out divides, else
row-parallel), each rank keeping the Adam state of its block. The
BatchNorm statistics are those of the global batch (``ops/bn.py``). The
gradients are all-reduced over 'data' once per optimizer update, after
the `grad_accum`-th micro-batch: averaged for the criteria that are batch
means, summed for ``masked_ce``, whose loss is the batch sum. The loss
``train_step`` returns and the loss and scores of ``eval_step`` are the
global batch's. A checkpoint holds the sharded head gathered whole, so it
loads on any mesh and on one device.

``spatial_partition=True`` on a mesh with ``n_model > 1`` (JAX's images
on ``P("data", "model")``): ``put_batch`` also keeps this rank's block of
the images' H over 'model', and the trunk runs H-sharded with halo
exchanges while its layers' rows split evenly, then gathered and
replicated (``parallel/spatial.py``, ``models/resnet.py``), in the train
and the eval step. The gradients of the sharded layers are summed over
'model' (each model rank holds a part of their rows) before the reduction
over 'data'; the replicated layers' and the head's are reduced over
'data' only. With no mesh or one model rank the field changes nothing, as
JAX's spec reduces to data sharding there.

State: PyTorch updates in place, which is what the JAX step's buffer
donation amounts to. ``train_step`` returns the state it was given, with
its model and optimizer updated and its step count advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..hierarchy import LabelMap
from ..losses.classification import (
    _PerDevice,
    hierarchical_softmax_nll,
    make_hierarchical_softmax,
    make_last_level_ce,
    make_masked_ce,
    make_multi_level_ce,
    multi_label_soft_margin,
)
from ..models.heads import HierarchicalCNN
from ..models.resnet import (init_params_, s2d_stem_kernel,
                             spatial_parameters)
from ..ops.bn import BN_IMPLS, make_norm, set_batch_norm_group
from ..ops.image import device_scale
from ..parallel.mesh import (Mesh, all_gather_rows, all_reduce_,
                             all_reduce_grads_, param_shardings,
                             shard_height, shard_linear_layers_, shard_rows)
from ..parallel.spatial import SpatialShards
from ..utils import profiling, staging

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState",
           "make_criterion", "resolve_device", "mesh_or_device", "to_device",
           "CRITERIA", "CRITERION_TO_HEAD", "BN_IMPLS", "SUMMED_CRITERIA"]

CRITERIA = ("multi_level_ce", "last_level_ce", "masked_ce",
            "multi_label_sm", "hsoftmax")

CRITERION_TO_HEAD = {
    "multi_level_ce": "multi_head",
    "last_level_ce": "leaf",
    "masked_ce": "multi_head",
    "multi_label_sm": "multi_head",
    "hsoftmax": "hsoftmax",
}

#: criteria whose loss is a batch sum (their gradients add over shards)
SUMMED_CRITERIA = ("masked_ce",)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    present. Nothing moves to the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA card is available; "
            "pass device='cpu' to run on the CPU")
    return device


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array (or tensor) as a tensor on `device`, its dtype kept
    unless `dtype` is given. From the host to a card the copy goes through
    that card's pinned ring on its copy stream, and the calling thread's
    current stream waits on it: the host does not (``utils/staging.py``;
    the array itself is read before this returns). Otherwise the copy
    alone runs in the host span "copy.h2d". Each ``cudaMemcpyAsync`` call
    lies in a "copy.h2d" span
    (``utils/profiling.py::trace_offset_ns`` puts the spans on the
    trace's clock by these)."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    dtype = dtype or t.dtype
    if device.type == "cuda" and t.device.type == "cpu":
        return staging.to_cuda(t, device, dtype)
    with profiling.span("copy.h2d"):
        return t.to(device, dtype=dtype, non_blocking=True)


def mesh_or_device(mesh, device) -> torch.device:
    """The device a trainer runs on: the mesh's (whose device type must
    be the config's), or `device` (``resolve_device``) without a mesh.
    Raises for anything but a ``parallel.mesh.Mesh`` or None."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh) "
                        f"or None, got {type(mesh).__name__}")
    if mesh.device.type != torch.device(device).type:
        raise ValueError(f"the mesh runs on {mesh.device}, the config asks "
                         f"for {device!r}")
    return mesh.device


@dataclasses.dataclass
class ClassifierConfig:
    backbone: str = "resnet50"
    criterion: str = "multi_level_ce"
    lr: float = 1e-5
    optimizer: str = "adam"            # adam | sgd (momentum 0.9)
    lr_steps: Sequence[int] = ()       # epochs where lr ×= lr_decay
    lr_decay: float = 0.1
    steps_per_epoch: int = 1           # converts lr_steps (epochs) → steps
    level_weights: Optional[Sequence[float]] = None
    class_weights: Optional[np.ndarray] = None
    freeze_trunk: bool = False         # only the head trains
    image_size: int = 448
    batch_size: int = 64
    seed: int = 0
    dtype: torch.dtype = torch.bfloat16  # trunk activations; params are f32
    head_override: Optional[str] = None  # e.g. 'bottleneck2d' (--use_2d)
    remat: bool = False  # recompute residual blocks in backward (memory)
    stem: str = "conv7"  # 's2d' = space-to-depth stem (equivalent)
    freeze_bn: bool = False  # train with BN in inference mode (frozen
    #                          running statistics; runs no BN kernel)
    bn_stats_rows: int = 0   # >0: ghost-batch BN statistics (GhostBatchNorm)
    bn_impl: str = "pallas"  # 'pallas' = fused-reduction BN (ops.bn +
    #                          ops.bn_triton); 'flax' = the library's BN
    bn_stats_dtype: str = "float32"  # 'bfloat16' = bf16 BN statistics
    grad_accum: int = 1      # micro-batches per optimizer update
    spatial_partition: bool = False  # shard the images' H over 'model'
    #                                  (on a mesh with n_model > 1)
    tp_patterns: Sequence[str] = ("fc/kernel",)   # sharded over 'model'
    device: str = "cuda"


@dataclasses.dataclass
class TrainState:
    step: int
    model: HierarchicalCNN
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    micro: int = 0   # micro-batches accumulated towards the next update
    #: the image height of the update's micro-batches (spatial partitioning)
    height: Optional[int] = None


def make_criterion(labelmap: LabelMap, cfg: ClassifierConfig):
    """Returns loss_and_scores(raw, level_labels, multihot) -> (loss,
    scores), `scores` being what the evaluator consumes. Class weights
    follow the scores' device."""
    name = cfg.criterion
    if name == "multi_level_ce":
        f = make_multi_level_ce(labelmap, cfg.level_weights,
                                cfg.class_weights)
        return lambda raw, ll, mh: (f(raw, ll), raw)
    if name == "last_level_ce":
        f = make_last_level_ce(labelmap, cfg.level_weights,
                               cfg.class_weights)

        def fn(raw, ll, mh):
            probs, loss = f(raw, ll)
            return loss, probs
        return fn
    if name == "masked_ce":
        f = make_masked_ce(labelmap, cfg.level_weights)

        def fn(raw, ll, mh):
            outputs, loss = f(raw, ll)
            return loss, outputs
        return fn
    if name == "multi_label_sm":
        weights = _PerDevice(None if cfg.class_weights is None else
                             np.asarray(cfg.class_weights, np.float32))

        def fn(raw, ll, mh):
            (w,) = weights.on(raw.device)
            return multi_label_soft_margin(raw, mh, w), raw
        return fn
    if name == "hsoftmax":
        norm = make_hierarchical_softmax(labelmap)

        def fn(raw, ll, mh):
            all_lp, leaf_lp = norm(raw)
            return hierarchical_softmax_nll(leaf_lp, ll), all_lp
        return fn
    raise ValueError(f"unknown criterion {name!r}; expected {CRITERIA}")


def _check_options(cfg: ClassifierConfig) -> None:
    # the BatchNorm route is checked for every backbone, AlexNet's too
    make_norm(cfg.bn_impl, cfg.bn_stats_rows, cfg.bn_stats_dtype)
    if cfg.optimizer not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be ≥ 1, got {cfg.grad_accum}")


def _check_trunk(trunk, cfg: ClassifierConfig, mesh) -> None:
    # a trunk with no spatial units (ViT, Swin) runs whole, on one device
    if hasattr(trunk, "spatial_units"):
        return
    if cfg.spatial_partition:
        raise ValueError(f"spatial_partition: the {cfg.backbone} trunk has "
                         f"no windows of H to shard; train it without "
                         f"spatial partitioning")
    if mesh is not None and mesh.size > 1:
        raise ValueError(f"the {cfg.backbone} trunk runs on one device; "
                         f"a mesh of {mesh.size} ranks is not supported "
                         f"for it")


class ClassifierTrainer:
    """Builds the model, optimizer and steps on `cfg.device`, or on this
    rank's place of `mesh`; `grayscale` gives the trunk one input
    channel."""

    def __init__(self, labelmap: LabelMap, cfg: ClassifierConfig,
                 mesh: Optional[Mesh] = None, grayscale: bool = False):
        _check_options(cfg)
        self.labelmap = labelmap
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh_or_device(mesh, cfg.device)
        self.criterion = make_criterion(labelmap, cfg)
        self.n_channels = 1 if grayscale else 3
        model = HierarchicalCNN(
            backbone=cfg.backbone, levels=tuple(labelmap.levels),
            head=cfg.head_override or CRITERION_TO_HEAD[cfg.criterion],
            dtype=cfg.dtype, in_channels=self.n_channels, remat=cfg.remat,
            stem=cfg.stem, bn_stats_rows=cfg.bn_stats_rows,
            bn_impl=cfg.bn_impl, bn_stats_dtype=cfg.bn_stats_dtype,
            image_size=cfg.image_size)
        _check_trunk(model.trunk, cfg, mesh)
        init_params_(model, torch.Generator().manual_seed(cfg.seed))
        model.to(device=self.device, memory_format=torch.channels_last)
        #: the full-shape name of each sharded weight → its layer
        self._sharded = {}
        if mesh is not None:
            shardings = param_shardings(model, mesh, cfg.tp_patterns)
            for owner in shard_linear_layers_(model, mesh, shardings):
                self._sharded[owner + ".weight"] = model.get_submodule(owner)
            set_batch_norm_group(model, mesh.data_group)
        #: H-sharded over 'model' (spatial partitioning)
        self.spatial = (cfg.spatial_partition and mesh is not None
                        and mesh.n_model > 1)
        if self.spatial:
            model.trunk.spatial = SpatialShards(mesh)
        self._sum_grads = cfg.criterion in SUMMED_CRITERIA
        if cfg.freeze_trunk:
            model.trunk.requires_grad_(False)

        # reference MultiStepLR steps once per EPOCH while the schedule
        # counts optimizer updates: update k runs at lr × Π{decay : b ≤ k}
        # (optax.piecewise_constant_schedule semantics); under gradient
        # accumulation an epoch has steps_per_epoch // grad_accum updates
        spe = max(int(cfg.steps_per_epoch) // cfg.grad_accum, 1)
        self._boundaries = sorted({int(b) * spe for b in cfg.lr_steps})
        named = [(k, p) for k, p in model.named_parameters()
                 if p.requires_grad]
        #: the optimizer's parameters and their names, in its order
        self._opt_names = [k for k, _ in named]
        params = self._params = [p for _, p in named]
        if cfg.optimizer == "adam":   # optax.adam defaults
            opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                   eps=1e-8)
        else:
            opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, self._lr_factor)
        self.model = model
        self.state = TrainState(step=0, model=model, optimizer=opt,
                                scheduler=sched)

    # ------------------------------------------------------------------
    def _lr_factor(self, k: int) -> float:
        return self.cfg.lr_decay ** sum(k >= b for b in self._boundaries)

    def lr_schedule(self, k: int) -> float:
        """Learning rate of optimizer update `k` (0-based)."""
        return self.cfg.lr * self._lr_factor(k)

    def _forward(self, model, images):
        # NHWC (the JAX layout) → NCHW view, channels_last in memory
        return model(device_scale(images).permute(0, 3, 1, 2))

    def train_step(self, state: TrainState, images, level_labels, multihot):
        """One micro-batch from ``put_batch``; every `grad_accum`-th one
        applies the optimizer update to the mean of their gradients.
        Returns (state, loss) with the loss as a 0-d device tensor."""
        k = self.cfg.grad_accum
        state.model.train(not self.cfg.freeze_bn)
        if state.micro == 0:
            state.optimizer.zero_grad(set_to_none=True)
        if self.spatial:
            # which layers run H-sharded follows from the height
            if state.micro == 0 or state.height is None:
                state.height = images.shape[1]
            elif images.shape[1] != state.height:
                raise ValueError(
                    f"the micro-batches of one update must share their "
                    f"height: {images.shape[1]} rows after {state.height}")
        with profiling.span("classifier.forward", self.device):
            raw = self._forward(state.model, images)
            loss, _ = self.criterion(raw, level_labels, multihot)
        with profiling.span("classifier.backward", self.device):
            (loss / k if k > 1 else loss).backward()
        state.micro += 1
        if state.micro == k:
            if self.spatial:
                ids = {id(p) for p in spatial_parameters(
                    state.model.trunk, state.height * self.mesh.n_model,
                    self.mesh.n_model)}
                all_reduce_grads_([p for p in self._params if id(p) in ids],
                                  self.mesh.model_group, average=False,
                                  tag="grads_model")
            if self.mesh is not None:
                all_reduce_grads_(self._params, self.mesh.data_group,
                                  average=not self._sum_grads)
            with profiling.span("classifier.optimizer", self.device):
                state.optimizer.step()
                state.scheduler.step()
            state.micro = 0
        state.step += 1
        return state, self._global_loss(loss.detach())

    def _global_loss(self, loss):
        if self.mesh is None:
            return loss
        return all_reduce_(loss.clone(), self.mesh.data_group, "loss",
                           average=not self._sum_grads)

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, level_labels, multihot):
        """(loss, scores) of the global batch."""
        state.model.eval()
        raw = self._forward(state.model, images)
        loss, scores = self.criterion(raw, level_labels, multihot)
        if self.mesh is None:
            return loss, scores
        return (self._global_loss(loss),
                all_gather_rows(scores.contiguous(), self.mesh.data_group,
                                "eval_scores"))

    # ------------------------------------------------------------------
    def load_backbone_state_dict(self, path: str) -> None:
        """Start the trunk from a torchvision ResNet state-dict file (the
        reference's pretrained=True backbones; --load_backbone_from). The
        port's names are torchvision's: the file's ``fc.*`` and
        ``num_batches_tracked`` entries are dropped and the rest loads
        strictly. Under ``stem='s2d'`` the 7×7 ``conv1`` is converted with
        ``s2d_stem_kernel``; a grayscale trunk keeps its fresh ``conv1``."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")
              and not k.endswith("num_batches_tracked")}
        trunk = self.state.model.trunk
        if self.cfg.stem == "s2d":
            sd["conv1.weight"] = s2d_stem_kernel(sd["conv1.weight"])
        if self.n_channels != 3:
            sd["conv1.weight"] = trunk.conv1.weight.detach()
        trunk.load_state_dict(sd, strict=True)

    def load_weights(self, state_dict) -> None:
        """Parameters and running statistics from a one-device state dict
        (whole tensors or arrays); on a mesh each rank keeps its blocks."""
        self.state.model.load_state_dict(
            {k: self._block(k, torch.as_tensor(v))
             for k, v in state_dict.items()}, strict=True)

    def whole_state_dict(self) -> dict:
        """The model's state dict with every sharded weight gathered whole:
        a collective on a mesh, so every rank calls it."""
        return {k: self._whole(k, v.detach())
                for k, v in self.state.model.state_dict().items()}

    # ------------------------------------------------------------------
    def checkpoint_payload(self) -> dict:
        """Trainer half of the checkpoint contract: params, batch_stats
        and opt_state (optimizer, lr-schedule position and, between the
        micro-batches of one update, the gradients accumulated so far)."""
        st = self.state
        acc = ({k: self._whole(k, p.grad.detach().clone())
                for k, p in st.model.named_parameters()
                if p.grad is not None} if st.micro else {})
        return {"params": {k: self._whole(k, v.detach())
                           for k, v in st.model.named_parameters()},
                "batch_stats": dict(st.model.named_buffers()),
                "opt_state": {"optimizer": self._optimizer_state(
                                  self._whole),
                              "scheduler": st.scheduler.state_dict(),
                              "step": st.step, "micro": st.micro,
                              "acc_grads": acc}}

    def _whole(self, name, t):
        """A tensor shaped like parameter `name` on this rank, whole (the
        blocks of a sharded weight gathered over 'model')."""
        layer = self._sharded.get(name)
        return t if layer is None else layer.gather(t)

    def _block(self, name, t):
        """This rank's block of a whole tensor shaped like parameter
        `name`."""
        layer = self._sharded.get(name)
        return t if layer is None else layer.shard(t).clone()

    def _optimizer_state(self, fn, sd=None):
        """The optimizer's state dict with `fn(name, t)` applied to every
        per-parameter tensor (moments; not Adam's 0-d step count)."""
        sd = sd if sd is not None else self.state.optimizer.state_dict()
        if not self._sharded:
            return sd
        return {**sd, "state": {
            i: {k: (fn(self._opt_names[i], v)
                    if torch.is_tensor(v) and v.ndim else v)
                for k, v in st.items()}
            for i, st in sd["state"].items()}}

    def restore_payload(self, payload: dict) -> None:
        st = self.state
        params = {k: self._block(k, v) for k, v in payload["params"].items()}
        st.model.load_state_dict({**params, **payload["batch_stats"]},
                                 strict=True)
        opt_state = payload["opt_state"]
        st.optimizer.load_state_dict(self._optimizer_state(
            self._block, opt_state["optimizer"]))
        st.scheduler.load_state_dict(opt_state["scheduler"])
        st.step = int(opt_state["step"])
        st.micro = int(opt_state.get("micro", 0))
        acc = opt_state.get("acc_grads", {})
        for k, p in st.model.named_parameters():
            p.grad = (self._block(k, acc[k]).to(p.device)
                      if st.micro and k in acc else None)

    # ------------------------------------------------------------------
    def put_batch(self, images, level_labels, multihot):
        """Host (numpy) or device batch → tensors on the trainer's device:
        images keep their dtype (uint8 is the transfer format), labels
        become int64, the multi-hot f32. On a mesh, this rank's rows of the
        global batch, and under spatial partitioning this rank's block of
        the images' H (NHWC) over 'model'."""
        images = shard_rows(images, self.mesh)
        if self.spatial:
            images = shard_height(images, self.mesh)
        return (to_device(images, self.device),
                to_device(shard_rows(level_labels, self.mesh), self.device,
                          torch.int64),
                to_device(shard_rows(multihot, self.mesh), self.device,
                          torch.float32))
