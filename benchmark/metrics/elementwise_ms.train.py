"""elementwise_ms.train: device milliseconds a classifier train step of
elementwise and reduction kernels (the BatchNorm epilogues, residual
adds, ReLUs, casts, Adam's passes), from the profiled window. Kernels are
classed by name, the first class that matches; memcpys and memsets are
a class of their own. Layer: ops. Moves train_images_per_s."""

#: (class, name patterns), the first match counts
CLASSES = (
    ("bn_kernels_of_the_port", ("bn_stats_kernel", "bn_corr_kernel")),
    ("library_bn", ("bn_fw", "bn_bw", "batch_norm", "batchnorm",
                    "BatchNorm", "bn_")),
    ("conv", ("conv", "xmma", "cutlass", "gemm", "dgrad", "wgrad",
              "implicit", "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("memory", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce",
                     "copy", "fill")))


def op_class(name: str) -> str:
    return next((c for c, pats in CLASSES if any(p in name for p in pats)),
                "other")


def read(window, info):
    steps = info.get("steps")
    if not steps:
        return None
    s = window.seconds_by(lambda n: op_class(n) == "elementwise")
    return 1e3 * s / steps if s > 0 else None
