"""Reproduces a fault of oneDNN's bfloat16 convolution weight gradient on
the CPU, the reason the joint CLI tests (tests/test_torch_cli.py) turn
oneDNN off.

The conv is the first 3×3, stride-2, padding-1 conv of a ResNet-18's
layer4 at 16² images: a 1×1 input map, so of the nine kernel taps only the
centre one meets the input and the other eight see padding alone. Their
true gradient is exactly 0. The script calls the weight gradient of that
conv 200 times with oneDNN on and 200 times with it off, on 2 threads and
seeded random bfloat16 inputs, and counts the calls whose result is
non-finite, is non-zero at a padding-only tap, or differs bit-wise from
the first call. It takes about three minutes.

    python3 onednn_dw_repro.py

Runs on the CPU only; on a CPU where oneDNN takes another path the fault
may not show.
"""

import json

import torch

CALLS, THREADS = 200, 2


def weight_grad(gout, x, w):
    return torch.ops.aten.convolution_backward(
        gout, x, w, None, [2, 2], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]


def main():
    torch.set_num_threads(THREADS)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(48, 256, 1, 1, generator=gen).bfloat16()
    gout = (torch.randn(48, 512, 1, 1, generator=gen) * 1e-2).bfloat16()
    w = (torch.randn(512, 256, 3, 3, generator=gen) * 0.02).bfloat16()
    padding_only = torch.ones(3, 3, dtype=torch.bool)
    padding_only[1, 1] = False
    ref = torch.ops.aten.convolution_backward(
        gout.double(), x.double(), w.double(), None, [2, 2], [1, 1], [1, 1],
        False, [0, 0], 1, [False, True, False])[1]
    out = {"torch": torch.__version__, "calls": CALLS, "threads": THREADS}
    for name, on in (("onednn", True), ("native", False)):
        torch.backends.mkldnn.enabled = on
        grads = [weight_grad(gout, x, w) for _ in range(CALLS)]
        first = torch.nan_to_num(grads[0])
        finite = [g for g in grads if bool(torch.isfinite(g).all())]
        out[name] = {
            "non_finite": len(grads) - len(finite),
            "nonzero_at_padding_taps": sum(
                bool(g[:, :, padding_only].ne(0).any()) for g in grads),
            "bitwise_equal_to_first": sum(
                torch.equal(torch.nan_to_num(g), first) for g in grads),
            "centre_tap_max_abs_err_vs_f64": max(
                (float((g[:, :, 1, 1].double() - ref[:, :, 1, 1]).abs().max())
                 for g in finite), default=None),
        }
    out["centre_tap_max_abs_f64"] = float(ref[:, :, 1, 1].abs().max())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
