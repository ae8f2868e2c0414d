#!/usr/bin/env python3
"""Where the time of K3's exact_d kernel goes, on one NVIDIA card.

Usage, from the root of a checkout:   python3 k3_variants.py

Builds copies of `learning_embeddings_tpu_torch/csrc/pairwise_order.cu`
with one part of the exact_d kernel cut out, and times each beside the
kernel as it is (and the generic kernel), at the joint eval's shapes, D =
10, the way `chip_smoke.py` times kernels (`device_ms`: 20 calls in one
CUDA graph, inputs rotated past the 50 MB L2):

  kernel       the kernel as built (checked against the plain version)
  no_store     computes every output but stores none (a store under a
               condition that never holds keeps the arithmetic live)
  store_only   no arithmetic: stores zeros, so the compiler drops the loads
  no_load      u and v rows set from a compare of their address instead of
               loaded; arithmetic and stores as built
  empty        returns at once: the cost of a launch of this grid

Prints one line per shape and variant, with the card's nvidia-smi name and
power limit, and writes the numbers to chiprun_out/k3_variants.json. The
cut variants compute wrong values by design and only time.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(344, 5286, 10), (344, 344, 10), (344, 5049, 10),
          (723, 5286, 10), (723, 723, 10), (723, 5049, 10)]

STORE = "if (j < N) orow[j] = acc[p][c];"
DLOOP = ("      for (int d = 0; d < D; ++d)\n#pragma unroll\n"
         "        for (int p = 0; p < kPassRows; ++p)")
LOADS = ("load_row<D>(u + ", "load_row<D>(v + ")
BODY = "  const int lane = threadIdx.x;\n  for (long long t = blockIdx.x;"
FAKE = '''
template <int D>
__device__ __forceinline__ void fake_row(const float* row, float (&x)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
    x[d] = static_cast<float>(d) - (row == nullptr ? 3.f : 2.5f);
}

template <int D>
__global__ void __launch_bounds__(32, kMinBlocksPerSm)
pairwise_order_exact_kernel('''


def variant_sources(src):
    """name → source text of each variant; raises if the kernel's source
    no longer holds a statement a variant cuts."""
    for part in (STORE, DLOOP, BODY) + LOADS:
        if part not in src:
            raise SystemExit(f"k3_variants: the source has no {part!r}")
    head = ("template <int D>\n__global__ void __launch_bounds__(32, "
            "kMinBlocksPerSm)\npairwise_order_exact_kernel(")
    no_load = src.replace(head, FAKE, 1)
    for call in LOADS:
        no_load = no_load.replace(call, call.replace("load_row", "fake_row"))
    return {
        "kernel": src,
        "no_store": src.replace(STORE,
                                "if (acc[p][c] == -1.f) orow[j] = 0.f;"),
        "store_only": src.replace(DLOOP, DLOOP.replace("d < D", "d < 0")),
        "no_load": no_load,
        "empty": src.replace(BODY, "  if (tiles >= 0) return;\n" + BODY),
    }


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: no CUDA card is available")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from learning_embeddings_tpu_torch.ops import pairwise_order as k3

    smi = cs.smi_line()
    cs.log(f"[k3_variants] {smi}")
    with open(k3._SOURCE) as f:
        sources = variant_sources(f.read())
    out_dir = os.path.join(HERE, ".torch_kernels", "k3_variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        libs[name] = k3.load_library(k3.build_library(path))
        cs.log(f"[k3_variants] {name}: built in "
               f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    try:
        for M, N, D in SHAPES:
            copies = [(torch.randn((M, D), device="cuda", generator=gen),
                       torch.randn((N, D), device="cuda", generator=gen))
                      for _ in range(cs.n_copies(4 * (M * D + N * D + M * N)))]
            k3._LIB = libs["kernel"]
            row = {"M": M, "N": N, "D": D,
                   "bound_ms": cs.k3_bound(M, N, D)[0],
                   "generic_ms": cs.device_ms(k3.pairwise_order_generic,
                                              copies)}
            for name, lib in libs.items():
                k3._LIB = lib
                if name == "kernel":
                    u, v = copies[0]
                    cs.k3_compare(f"k3_variants {(M, N, D)}",
                                  k3.pairwise_order(u, v),
                                  k3.pairwise_order_plain(u, v))
                row[name + "_ms"] = cs.device_ms(k3.pairwise_order, copies)
            rows.append(row)
            cs.log(f"[k3_variants] {M}x{N}x{D}: " + ", ".join(
                f"{k[:-3]} {v * 1e3:.2f}" for k, v in row.items()
                if k.endswith("_ms")) + " us")
    finally:
        k3._LIB = None
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k3_variants.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "shapes": rows}, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
