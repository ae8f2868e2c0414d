"""Times PyTorch's fused scaled-dot-product attention on its flash and
cuDNN backends at ViT-L/16's 448² shape, forward and backward, on one
card (the port's ``ops/attention.py`` pins the faster, cuDNN):

    python3 tools/attention_backends.py [--batch 64] [--repeats 20]

For each backend: device milliseconds of one forward and of one
backward (CUDA events around `repeats` calls, after warm-up), and both
for the 24 blocks of a train step. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.nn.functional import scaled_dot_product_attention as sdpa


def _ms(fn, repeats):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(repeats):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / repeats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--repeats", type=int, default=20)
    a = p.parse_args(argv)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(a.batch, 16, 785, 64, device="cuda", generator=g)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    dout = torch.randn(a.batch, 16, 785, 64, device="cuda",
                       generator=g).to(torch.bfloat16)
    out = {"batch": a.batch, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "torch": torch.__version__}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):

        def fwd():
            with torch.no_grad():
                sdpa(q, k, v)

        def both():
            sdpa(q, k, v).backward(dout)
        with sdpa_kernel([backend]):
            f = _ms(fwd, a.repeats)
            fb = _ms(both, a.repeats)
        out[name] = {"fwd_ms": f, "bwd_ms": fb - f,
                        "step_ms_24_blocks": 24 * fb}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
