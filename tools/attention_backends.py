"""Times PyTorch's fused scaled-dot-product attention on one card, forward
and backward, at the shapes the port's ``ops/attention.py`` serves:

    python3 tools/attention_backends.py [--batch 64] [--repeats 20]

* ViT-L/16 at 448² (16 heads, 785 tokens of 64), no bias: the flash and
  cuDNN backends (the port pins cuDNN for the call without a bias).
* Swin-L at 384² with window 12 (``models/swin.py``): at each of its four
  stages, q, k, v of (B, nW·H, 144, 32), the windows folded into the
  heads, and an additive bf16 bias of (1, nW·H, 144, 144) that takes a
  gradient: the memory-efficient backend with the bias as a float
  ``attn_mask``, cuDNN's with the same mask, and the math backend as a
  yardstick (the port pins the faster of the fused ones that gives the
  bias its gradient). A route that raises is reported with its error.
* The same four stage shapes through ``ops/window_attention.py``, which
  the Swin trunk calls: q, k, v packed as the qkv projection's (B, nW,
  144, 3C) output, the same bias, its kernel pair ("kernel") and its plain
  route ("plain": the softmax math in f32 on the card), the forward with
  autograd recording (as in a train step: the kernel saves its
  log-sum-exp).

For each route: device milliseconds of one forward and of one backward
(CUDA events around `repeats` calls, after warm-up), and both over the
blocks of a train step (24 for ViT-L; the stage's depth for Swin-L,
summed over the stages). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.nn.functional import scaled_dot_product_attention as sdpa

# the port, for the window attention's routes
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: Swin-L at 384², window 12: (windows, heads, blocks) of each stage
SWIN_STAGES = ((64, 6, 2), (16, 12, 2), (4, 24, 18), (1, 48, 2))


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


def _time(backend, q, k, v, dout, repeats, bias=None):
    """{"fwd_ms", "bwd_ms"} of one call on `backend`, or {"error"}."""

    def fwd():
        with torch.no_grad():
            sdpa(q, k, v, attn_mask=bias)

    def both():
        grads = [t for t in (q, k, v, bias) if t is not None]
        torch.autograd.grad(sdpa(q, k, v, attn_mask=bias), grads, dout)
    try:
        with sdpa_kernel([backend]):
            f = _ms(fwd, repeats)
            fb = _ms(both, repeats)
    except RuntimeError as e:
        return {"error": str(e).splitlines()[0][:300]}
    return {"fwd_ms": f, "bwd_ms": fb - f}


def _tensors(g, shape, n):
    return [torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
            .requires_grad_(True) for _ in range(n)]


def _time_call(fn, inputs, dout, repeats):
    """{"fwd_ms", "bwd_ms"} of `fn()`, its forward recorded for autograd
    and its backward to `inputs` from `dout`."""
    f = _ms(fn, repeats)
    fb = _ms(lambda: torch.autograd.grad(fn(), inputs, dout), repeats)
    return {"fwd_ms": f, "bwd_ms": fb - f}


def vit(batch, repeats, g):
    q, k, v, dout = _tensors(g, (batch, 16, 785, 64), 4)
    out = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        r = _time(backend, q, k, v, dout, repeats)
        if "fwd_ms" in r:
            r["step_ms_24_blocks"] = 24 * (r["fwd_ms"] + r["bwd_ms"])
        out[name] = r
    return out


def swin(batch, repeats, g):
    routes = (("efficient", SDPBackend.EFFICIENT_ATTENTION),
              ("cudnn", SDPBackend.CUDNN_ATTENTION),
              ("math", SDPBackend.MATH))
    out = {name: {"stages": []} for name, _ in routes}
    for nW, H, depth in SWIN_STAGES:
        q, k, v, dout = _tensors(g, (batch, nW * H, 144, 32), 4)
        (bias,) = _tensors(g, (1, nW * H, 144, 144), 1)
        for name, backend in routes:
            r = _time(backend, q, k, v, dout, repeats, bias)
            out[name]["stages"].append(dict(r, windows=nW, heads=H,
                                            blocks=depth))
        del q, k, v, dout, bias
        torch.cuda.empty_cache()
    for name, _ in routes:
        st = out[name]["stages"]
        if all("fwd_ms" in s for s in st):
            out[name]["step_ms"] = sum(s["blocks"] * (s["fwd_ms"]
                                                      + s["bwd_ms"])
                                       for s in st)
    return out


def swin_window(batch, repeats, g):
    from learning_embeddings_tpu_torch.ops import window_attention as wa

    routes = (("kernel", wa.window_attention),
              ("plain", wa.window_attention_plain))
    out = {name: {"stages": []} for name, _ in routes}
    for nW, H, depth in SWIN_STAGES:
        (qkv,) = _tensors(g, (batch, nW, 144, 3 * H * 32), 1)
        (bias,) = _tensors(g, (1, nW * H, 144, 144), 1)
        (dout,) = _tensors(g, (batch, nW, 144, H * 32), 1)
        for name, fn in routes:
            r = _time_call(lambda: fn(qkv, bias, H), (qkv, bias), dout,
                           repeats)
            out[name]["stages"].append(dict(r, windows=nW, heads=H,
                                            blocks=depth))
        del qkv, bias, dout
        torch.cuda.empty_cache()
    for name, _ in routes:
        st = out[name]["stages"]
        out[name]["step_ms"] = sum(s["blocks"] * (s["fwd_ms"] + s["bwd_ms"])
                                   for s in st)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--repeats", type=int, default=20)
    a = p.parse_args(argv)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"batch": a.batch, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "torch": torch.__version__}
    out["vit_l16_448"] = vit(a.batch, a.repeats, g)
    out["swin_l_384_biased"] = swin(a.batch, a.repeats, g)
    out["swin_l_384_window"] = swin_window(a.batch, a.repeats, g)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
