"""mfu.joint: the joint step's share of the card's dense bf16 peak (989
TFLOP/s, at 700 W): ResNet-50's train operations (``lib/flops.py``) for
each unique image the tower embedded in the window's untraced part, per
second. The rows that pad a step's images to its bucket are waste and
are not counted, nor is the label side's arithmetic. Layer: model step.
Moves joint_edges_per_s."""

from benchmark.lib.flops import H100_BF16_FLOPS, train_flops


def read(window, info):
    host = info.get("host", {})
    images = host.get("tower_images")
    if not images or host["window_s"] <= 0:
        return None
    rate = images / host["window_s"]
    return 100.0 * train_flops(info["image_size"], info["n_out"]) * rate \
        / H100_BF16_FLOPS
