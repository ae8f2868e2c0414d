"""window_attention_ms.swin: device milliseconds a Swin train step of the
window attention, forward and backward: the program's device spans
"attention.fwd" and "attention.bwd" (``ops/attention.py``: the fused
biased call, and its backward node, the bias's gradient included), each
timed by its event pair on the compute stream, summed over the traced
part and divided by its steps (``attention_ms.vit.py::step_ms``). A
program without these spans reads nothing. Layer: ops. Moves
train_images_per_s."""

import importlib.util
import os

SPANS = ("attention.fwd", "attention.bwd")


def step_ms(names=SPANS):
    """Device ms a traced step of the spans `names`, or None."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "attention_ms.vit.py")
    spec = importlib.util.spec_from_file_location("_attention_ms_vit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.step_ms(names)


def read(window, info):
    return step_ms()
