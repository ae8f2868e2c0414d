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
from ..models.resnet import init_params_, s2d_stem_kernel
from ..ops.bn import BN_IMPLS, make_norm
from ..ops.image import device_scale

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState",
           "make_criterion", "resolve_device", "CRITERIA",
           "CRITERION_TO_HEAD", "BN_IMPLS"]

CRITERIA = ("multi_level_ce", "last_level_ce", "masked_ce",
            "multi_label_sm", "hsoftmax")

CRITERION_TO_HEAD = {
    "multi_level_ce": "multi_head",
    "last_level_ce": "leaf",
    "masked_ce": "multi_head",
    "multi_label_sm": "multi_head",
    "hsoftmax": "hsoftmax",
}

def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    present. Nothing moves to the CPU unless the caller asked for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA card is available; "
            "pass device='cpu' to run on the CPU")
    return device


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
    device: str = "cuda"


@dataclasses.dataclass
class TrainState:
    step: int
    model: HierarchicalCNN
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    micro: int = 0   # micro-batches accumulated towards the next update


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


class ClassifierTrainer:
    """Builds the model, optimizer and steps on `cfg.device`; `grayscale`
    gives the trunk one input channel."""

    def __init__(self, labelmap: LabelMap, cfg: ClassifierConfig,
                 grayscale: bool = False):
        _check_options(cfg)
        self.labelmap = labelmap
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.criterion = make_criterion(labelmap, cfg)
        self.n_channels = 1 if grayscale else 3
        model = HierarchicalCNN(
            backbone=cfg.backbone, levels=tuple(labelmap.levels),
            head=cfg.head_override or CRITERION_TO_HEAD[cfg.criterion],
            dtype=cfg.dtype, in_channels=self.n_channels, remat=cfg.remat,
            stem=cfg.stem, bn_stats_rows=cfg.bn_stats_rows,
            bn_impl=cfg.bn_impl, bn_stats_dtype=cfg.bn_stats_dtype)
        init_params_(model, torch.Generator().manual_seed(cfg.seed))
        model.to(device=self.device, memory_format=torch.channels_last)
        if cfg.freeze_trunk:
            model.trunk.requires_grad_(False)

        # reference MultiStepLR steps once per EPOCH while the schedule
        # counts optimizer updates: update k runs at lr × Π{decay : b ≤ k}
        # (optax.piecewise_constant_schedule semantics); under gradient
        # accumulation an epoch has steps_per_epoch // grad_accum updates
        spe = max(int(cfg.steps_per_epoch) // cfg.grad_accum, 1)
        self._boundaries = sorted({int(b) * spe for b in cfg.lr_steps})
        params = [p for p in model.parameters() if p.requires_grad]
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
        raw = self._forward(state.model, images)
        loss, _ = self.criterion(raw, level_labels, multihot)
        if state.micro == 0:
            state.optimizer.zero_grad(set_to_none=True)
        (loss / k if k > 1 else loss).backward()
        state.micro += 1
        if state.micro == k:
            state.optimizer.step()
            state.scheduler.step()
            state.micro = 0
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, level_labels, multihot):
        state.model.eval()
        raw = self._forward(state.model, images)
        return self.criterion(raw, level_labels, multihot)

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

    # ------------------------------------------------------------------
    def checkpoint_payload(self) -> dict:
        """Trainer half of the checkpoint contract: params, batch_stats
        and opt_state (optimizer, lr-schedule position and, between the
        micro-batches of one update, the gradients accumulated so far)."""
        st = self.state
        acc = ({k: p.grad.detach().clone()
                for k, p in st.model.named_parameters()
                if p.grad is not None} if st.micro else {})
        return {"params": {k: v.detach()
                           for k, v in st.model.named_parameters()},
                "batch_stats": dict(st.model.named_buffers()),
                "opt_state": {"optimizer": st.optimizer.state_dict(),
                              "scheduler": st.scheduler.state_dict(),
                              "step": st.step, "micro": st.micro,
                              "acc_grads": acc}}

    def restore_payload(self, payload: dict) -> None:
        st = self.state
        st.model.load_state_dict({**payload["params"],
                                  **payload["batch_stats"]}, strict=True)
        opt_state = payload["opt_state"]
        st.optimizer.load_state_dict(opt_state["optimizer"])
        st.scheduler.load_state_dict(opt_state["scheduler"])
        st.step = int(opt_state["step"])
        st.micro = int(opt_state.get("micro", 0))
        acc = opt_state.get("acc_grads", {})
        for k, p in st.model.named_parameters():
            p.grad = (acc[k].to(p.device) if st.micro and k in acc
                      else None)

    # ------------------------------------------------------------------
    def put_batch(self, images, level_labels, multihot):
        """Host (numpy) or device batch → tensors on the trainer's device:
        images keep their dtype (uint8 is the transfer format), labels
        become int64, the multi-hot f32."""
        def put(a, dtype=None):
            t = torch.as_tensor(a)
            return t.to(self.device, dtype=dtype or t.dtype,
                        non_blocking=True)
        return (put(images), put(level_labels, torch.int64),
                put(multihot, torch.float32))
