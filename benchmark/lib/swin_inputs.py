"""The Swin cell's seeded weights, handed to both the program and the
reference (``reference/swin.py``), drawn as ``vit_inputs.py`` draws the
ViT's: on the run's device, by a generator of the stream's own seed, in a
few large calls."""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference.swin import Arch, shapes
from .inputs import generator

#: the relative-bias tables' scale: of the order of a trained Swin's, so
#: that B moves the scores as it does in a fine-tuning
TABLE_STD = 0.5


def swin_params(seed: int, device, arch: Arch, n_out: int,
                tag: str = "weights") -> Dict[str, torch.Tensor]:
    """f32 Swin weights under the program's names (``trunk.*``, ``fc.*``):
    linear and conv weights normal with std 1/sqrt(fan_in), cut at two
    standard deviations; their biases 0.02·N; LayerNorm scales 1 + 0.1·N
    and biases 0.1·N; the relative-bias tables ``TABLE_STD``·N; the
    head's bias 0.1·N."""
    gen = generator(seed, tag, device)
    table = shapes(arch, n_out)
    weights = [k for k, s in table.items() if k.endswith("weight")
               and len(s) > 1]
    total = sum(math.prod(table[k]) for k in weights)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for k in weights:
        s = table[k]
        n = math.prod(s)
        out[k] = z[at:at + n].view(s) / math.sqrt(n // s[0]) / 0.8796256610
        at += n
    rest = [k for k in table if k not in out]
    u = torch.randn(sum(math.prod(table[k]) for k in rest), generator=gen,
                    device=device)
    at = 0
    for k in rest:
        n = math.prod(table[k])
        v = u[at:at + n].view(table[k])
        at += n
        # a LayerNorm's scale is the one 1-D weight; its bias goes with it
        norm = len(table.get(k.rsplit(".", 1)[0] + ".weight", ())) == 1
        if k.endswith("relative_position_bias_table"):
            out[k] = TABLE_STD * v
        elif norm:
            out[k] = (1.0 + 0.1 * v) if k.endswith("weight") else 0.1 * v
        elif k == "fc.bias":
            out[k] = 0.1 * v
        else:
            out[k] = 0.02 * v
    return {k: out[k].contiguous() for k in table}
