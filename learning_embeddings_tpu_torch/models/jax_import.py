"""Carry weights over from the JAX package's flax trees.

The port's own copy of the name and layout mapping of the JAX package's
``models/torch_import.py::export_torchvision_resnet`` (lines 94-123),
extended to the whole ``HierarchicalCNN`` (trunk + multi_head fc):

  conv kernel   HWIO → OIHW          fc kernel (in, out) → weight (out, in)
  BN scale/bias/mean/var → weight/bias/running_mean/running_var
  layer{i}_{j}  → layer{i}.{j}       downsample_conv/bn → downsample.0/.1

Inputs are nested dicts of numpy arrays (``jax.device_get`` of the
variables); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        stage_sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``HierarchicalCNN`` from the JAX model's
    ``params`` ({"trunk": ..., "fc": ...}) and ``batch_stats``
    ({"trunk": ...}); loads with ``load_state_dict(strict=True)``."""
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
    put("fc.weight", np.asarray(params["fc"]["kernel"]).T)
    put("fc.bias", params["fc"]["bias"])
    return out
