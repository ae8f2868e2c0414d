"""attention_roofline.vit: the attention's share of its bound a ViT train
step: the FLOP bound of its products (``lib/vit_flops.py``: 3 × 4·N²·D
a block and image, over the card's dense bf16 peak of 989 TFLOP/s; at
batch 64, 785 tokens, width 1024 and 24 blocks 11.76 ms) over
``attention_ms.vit``'s device ms a step. Recomputation is not counted,
so the same work reads the same whatever implements it. Layer: kernels.
Moves train_images_per_s."""

import importlib.util
import os

from benchmark.lib.flops import H100_BF16_FLOPS
from benchmark.lib.vit_flops import attention_train_flops
from benchmark.reference.vit import Arch


def bound_ms(batch: int, arch: Arch) -> float:
    return 1e3 * batch * attention_train_flops(arch) / H100_BF16_FLOPS


def _attention_ms():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "attention_ms.vit.py")
    spec = importlib.util.spec_from_file_location("_attention_ms_vit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.step_ms()


def read(window, info):
    if "arch" not in info:
        return None
    ms = _attention_ms()
    if not ms:
        return None
    return 100.0 * bound_ms(info["batch"], Arch(*info["arch"])) / ms
