"""Multi-head CNN classifier trainer: the port of
``learning_embeddings_tpu/train/classifier.py``.

One train step is: uint8 NHWC images scaled on the device, a ResNet trunk
with train-mode BatchNorm (its reductions in the kernels of
``ops/bn_triton.py`` on the card), one f32 linear head over all taxonomy
nodes, ``multi_level_ce`` and Adam (or SGD with momentum 0.9) with the
epoch-based step decay of the JAX package.

Ported so far: criterion ``multi_level_ce``, ``bn_impl='pallas'`` (the
fused-reduction BatchNorm, under the JAX package's name so configurations
map one-to-one), ``freeze_bn``, one device. Still to come (ROADMAP.md):
the other criteria and heads, flax/ghost BatchNorm, bf16 statistics, the
s2d stem, remat, ``freeze_trunk``, ``grad_accum``, meshes and spatial
partitioning.

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
from ..losses.classification import make_multi_level_ce
from ..models.heads import HierarchicalCNN
from ..models.resnet import init_params_
from ..ops.image import device_scale

__all__ = ["ClassifierConfig", "ClassifierTrainer", "TrainState",
           "make_criterion", "resolve_device", "CRITERIA"]

CRITERIA = ("multi_level_ce", "last_level_ce", "masked_ce",
            "multi_label_sm", "hsoftmax")

BN_IMPLS = ("pallas",)


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
    image_size: int = 448
    batch_size: int = 64
    seed: int = 0
    dtype: torch.dtype = torch.bfloat16  # trunk activations; params are f32
    freeze_bn: bool = False  # train with BN in inference mode (frozen
    #                          running statistics; runs no BN kernel)
    bn_impl: str = "pallas"  # the fused-reduction BN (ops.bn + ops.bn_triton)
    device: str = "cuda"


@dataclasses.dataclass
class TrainState:
    step: int
    model: HierarchicalCNN
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def make_criterion(labelmap: LabelMap, cfg: ClassifierConfig):
    """Returns loss_and_scores(raw, level_labels, multihot) -> (loss,
    scores), `scores` being what the evaluator consumes. Class weights
    follow the scores' device."""
    name = cfg.criterion
    if name == "multi_level_ce":
        f = make_multi_level_ce(labelmap, cfg.level_weights,
                                cfg.class_weights)
        return lambda raw, ll, mh: (f(raw, ll), raw)
    if name in CRITERIA:
        raise NotImplementedError(
            f"criterion {name!r} is not ported yet (ROADMAP.md queue A "
            "item 5: losses/classification.py)")
    raise ValueError(f"unknown criterion {name!r}; expected {CRITERIA}")


class ClassifierTrainer:
    """Builds the model, optimizer and steps on `cfg.device`."""

    def __init__(self, labelmap: LabelMap, cfg: ClassifierConfig):
        if cfg.bn_impl not in BN_IMPLS:
            raise NotImplementedError(
                f"bn_impl={cfg.bn_impl!r} is not ported yet; ported: "
                f"{BN_IMPLS} (ROADMAP.md queue A item 18)")
        if cfg.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.labelmap = labelmap
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.criterion = make_criterion(labelmap, cfg)
        model = HierarchicalCNN(backbone=cfg.backbone,
                                levels=tuple(labelmap.levels),
                                dtype=cfg.dtype)
        init_params_(model, torch.Generator().manual_seed(cfg.seed))
        model.to(device=self.device, memory_format=torch.channels_last)

        # reference MultiStepLR steps once per EPOCH while the schedule
        # counts optimizer updates: update k runs at lr × Π{decay : b ≤ k}
        # (optax.piecewise_constant_schedule semantics)
        spe = max(int(cfg.steps_per_epoch), 1)
        self._boundaries = sorted({int(b) * spe for b in cfg.lr_steps})
        params = list(model.parameters())
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
        """One optimizer update on a batch from ``put_batch``; returns
        (state, loss) with the loss as a 0-d device tensor."""
        state.model.train(not self.cfg.freeze_bn)
        raw = self._forward(state.model, images)
        loss, _ = self.criterion(raw, level_labels, multihot)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, level_labels, multihot):
        state.model.eval()
        raw = self._forward(state.model, images)
        return self.criterion(raw, level_labels, multihot)

    # ------------------------------------------------------------------
    def checkpoint_payload(self) -> dict:
        """Trainer half of the checkpoint contract: params, batch_stats
        and opt_state (optimizer + lr-schedule position)."""
        st = self.state
        buffers = dict(st.model.named_buffers())
        return {"params": {k: v.detach()
                           for k, v in st.model.named_parameters()},
                "batch_stats": buffers,
                "opt_state": {"optimizer": st.optimizer.state_dict(),
                              "scheduler": st.scheduler.state_dict(),
                              "step": st.step}}

    def restore_payload(self, payload: dict) -> None:
        st = self.state
        st.model.load_state_dict({**payload["params"],
                                  **payload["batch_stats"]}, strict=True)
        opt_state = payload["opt_state"]
        st.optimizer.load_state_dict(opt_state["optimizer"])
        st.scheduler.load_state_dict(opt_state["scheduler"])
        st.step = int(opt_state["step"])

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
