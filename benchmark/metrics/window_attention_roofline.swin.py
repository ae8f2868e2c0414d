"""window_attention_roofline.swin: the window attention's share of its
bound a Swin train step: the larger of its FLOP bound (3 × 4·N·T·C a
block and image over the card's dense bf16 peak of 989 TFLOP/s) and its
byte bound (24·T·C bytes a block and image in bf16 over 3.35 TB/s), from
``lib/swin_flops.py``; at batch 64, Swin-L at 384² with window 12,
1.53 ms and 6.29 ms, so the bytes bound it. Over
``window_attention_ms.swin``'s device ms a step. The bias table and any
bias made from it are not counted, and recomputation is not, so that the
same work reads the same whatever implements it. Layer: kernels. Moves
train_images_per_s."""

import importlib.util
import os

from benchmark.lib.flops import H100_BF16_FLOPS
from benchmark.lib.swin_flops import (H100_HBM_BYTES, attention_train_bytes,
                                      attention_train_flops)
from benchmark.reference.swin import Arch


def bound_ms(batch: int, arch: Arch) -> float:
    return 1e3 * batch * max(attention_train_flops(arch) / H100_BF16_FLOPS,
                             attention_train_bytes(arch) / H100_HBM_BYTES)


def _window_attention_ms():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "window_attention_ms.swin.py")
    spec = importlib.util.spec_from_file_location("_window_attention_ms",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.step_ms()


def read(window, info):
    if "arch" not in info:
        return None
    ms = _window_attention_ms()
    if not ms:
        return None
    return 100.0 * bound_ms(info["batch"], Arch(*info["arch"])) / ms
