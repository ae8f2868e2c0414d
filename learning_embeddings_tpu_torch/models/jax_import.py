"""Carry weights over from the JAX package's flax trees.

The port's own copy of the name and layout mapping of the JAX package's
``models/torch_import.py::export_torchvision_resnet`` (lines 94-123),
extended to a whole trunk + head model: the ``HierarchicalCNN``
classifier (any head: ``fc``, or ``bottleneck`` and ``level_fc{l}``) and
the joint trainer's ``FeatCNN`` image tower, whose flax trees have
{"trunk", head Dense layers} params and {"trunk"} batch_stats; and to the
label table and the fc7 path's image projectors (``FeatNet``: Dense
``fc1``; ``MatrixApproximation``: ``diag``, ``u``, ``v`` as they are):

  conv kernel   HWIO → OIHW          Dense kernel (in, out) → weight (out, in)
  BN scale/bias/mean/var → weight/bias/running_mean/running_var
  layer{i}_{j}  → layer{i}.{j}       downsample_conv/bn → downsample.0/.1

Inputs are nested dicts of numpy arrays (``jax.device_get`` of the
variables); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "label_table_from_jax",
           "label_table_from_jax_checkpoint", "feat_net_from_jax"]


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        stage_sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``HierarchicalCNN`` or ``FeatCNN`` from
    the JAX model's ``params`` ({"trunk": ..., "fc": ...} or another
    head's Dense layers) and
    ``batch_stats`` ({"trunk": ...}); loads with
    ``load_state_dict(strict=True)``."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def conv(name, p):
        put(f"{name}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def bn(name, p, s):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])
        put(f"{name}.running_mean", s["mean"])
        put(f"{name}.running_var", s["var"])

    tp, ts = params["trunk"], batch_stats["trunk"]
    conv("trunk.conv1", tp["conv1"])
    bn("trunk.bn1", tp["bn1"], ts["bn1"])
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            ours = f"trunk.layer{i + 1}.{j}"
            blk, blk_s = tp[f"layer{i + 1}_{j}"], ts[f"layer{i + 1}_{j}"]
            for k in range(1, 4):
                if f"conv{k}" in blk:
                    conv(f"{ours}.conv{k}", blk[f"conv{k}"])
                    bn(f"{ours}.bn{k}", blk[f"bn{k}"], blk_s[f"bn{k}"])
            if "downsample_conv" in blk:
                conv(f"{ours}.downsample.0", blk["downsample_conv"])
                bn(f"{ours}.downsample.1", blk["downsample_bn"],
                   blk_s["downsample_bn"])
    for name, dense in params.items():     # the head's Dense layers
        if name == "trunk":
            continue
        put(f"{name}.weight", np.asarray(dense["kernel"]).T)
        if "bias" in dense:
            put(f"{name}.bias", dense["bias"])
    return out


def label_table_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``LabelEmbedder`` from a JAX
    ``LabelEmbedder``'s variables ({"params": {"embedding": (n, d)}})."""
    return {"embedding": torch.from_numpy(np.array(
        variables["params"]["embedding"], dtype=np.float32))}


def feat_net_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``FeatNet`` (JAX params {"fc1": {kernel
    (in, out), bias}}) or ``MatrixApproximation`` (params {diag, u, v})
    from the JAX module's variables."""
    p = variables["params"]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    if "fc1" in p:
        return {"fc1.weight": t(np.asarray(p["fc1"]["kernel"]).T),
                "fc1.bias": t(p["fc1"]["bias"])}
    return {k: t(p[k]) for k in ("diag", "u", "v")}


def label_table_from_jax_checkpoint(
        tree: Mapping) -> Tuple[Dict[str, torch.Tensor], Optional[float]]:
    """(``LabelEmbedder`` state dict, calibrated threshold or None) from the
    numpy tree of a JAX label-only or joint checkpoint, as the JAX
    ``Checkpointer.load_raw`` returns it. A label-only payload holds the
    table at params/params/embedding, a joint one at
    params/labels/params/embedding; ``optimal_threshold`` is NaN where none
    was calibrated."""
    params = tree["params"]
    variables = params["labels"] if "labels" in params else params
    thr = float(tree.get("optimal_threshold", float("nan")))
    return label_table_from_jax(variables), (None if np.isnan(thr) else thr)
