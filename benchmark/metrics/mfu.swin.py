"""mfu.swin: the Swin classifier train step's share of the card's dense
bf16 peak (989 TFLOP/s, at 700 W): the Swin's operations for each
trained image (``lib/swin_flops.py``: 3 forward passes of the patch
embedding, the linear layers and patch merging, the window attention's
products and the head) times the images per second of the window's
untraced part. Layer: model step. Moves train_images_per_s."""

from benchmark.lib.flops import H100_BF16_FLOPS
from benchmark.lib.swin_flops import train_flops
from benchmark.reference.swin import Arch


def read(window, info):
    host = info.get("host", {})
    images = host.get("images")
    if not images or host["window_s"] <= 0 or "arch" not in info:
        return None
    rate = images / host["window_s"]
    return 100.0 * train_flops(Arch(*info["arch"]), info["n_out"]) * rate \
        / H100_BF16_FLOPS
