"""window_shuffle_ms.swin: device milliseconds a Swin train step of the
windows' shuffles: the program's device spans "swin.windows" (the cyclic
shift and window partition before each block's attention, and the
reverse and unshift after it) and "swin.windows.bwd" (their backward),
summed over the traced part and divided by its steps
(``attention_ms.vit.py::step_ms``). A program without
these spans reads nothing. Layer: ops. Moves train_images_per_s."""

import importlib.util
import os

SPANS = ("swin.windows", "swin.windows.bwd")


def read(window, info):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "attention_ms.vit.py")
    spec = importlib.util.spec_from_file_location("_attention_ms_vit", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.step_ms(SPANS)
