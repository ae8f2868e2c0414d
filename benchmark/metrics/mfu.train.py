"""mfu.train: the classifier train step's share of the card's dense bf16
peak (989 TFLOP/s, at 700 W): ResNet-50's operations for each trained
image (``lib/flops.py``: 3 forward passes of the convolutions and the
head) times the images per second of the window's untraced part. Layer:
model step. Moves train_images_per_s."""

from benchmark.lib.flops import H100_BF16_FLOPS, train_flops


def read(window, info):
    host = info.get("host", {})
    images = host.get("images")
    if not images or host["window_s"] <= 0:
        return None
    rate = images / host["window_s"]
    return 100.0 * train_flops(info["image_size"], info["n_out"]) * rate \
        / H100_BF16_FLOPS
