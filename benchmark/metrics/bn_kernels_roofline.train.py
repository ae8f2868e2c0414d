"""bn_kernels_roofline.train: the share of their roofline that the
BatchNorm reductions of a classifier train step reach: Σx, Σx² of each
of ResNet-50's 53 BatchNorm inputs (K1, ``bn_stats_kernel``) and Σdy,
Σdy·x in the backward pass (K2, ``bn_corr_kernel``). The least time is
each launch's bf16 inputs read once and its two f32 (C,) outputs written
once at 3.35 TB/s, or 3 f32 operations an element at 67 TFLOP/s,
whichever is longer (the bytes, at these shapes); it is divided by the
profiled device time of those kernels. A run whose step launches neither
kernel reads nothing. Layer: kernels. Moves train_images_per_s."""

from benchmark.lib.flops import bn_shapes

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
KERNELS = ("bn_stats_kernel", "bn_corr_kernel")


def launch_s(R: int, C: int, n_in: int, itemsize: int = 2) -> float:
    """Least seconds of one launch over an (R, C) matrix with `n_in`
    inputs."""
    by_bytes = (n_in * R * C * itemsize + 2 * C * 4) / HBM_BYTES_PER_S
    return max(by_bytes, 3 * R * C / F32_FLOPS)


def step_bound_s(batch: int, image_size: int):
    """(K1, K2) least seconds of one train step."""
    shapes = [(r * batch, c) for r, c in bn_shapes(image_size)]
    return (sum(launch_s(R, C, 1) for R, C in shapes),
            sum(launch_s(R, C, 2) for R, C in shapes))


def read(window, info):
    steps = info.get("steps")
    s = window.seconds_by(lambda n: any(k in n for k in KERNELS))
    if not steps or s <= 0:
        return None
    return 100.0 * sum(step_bound_s(info["batch"], info["image_size"])) \
        * steps / s
