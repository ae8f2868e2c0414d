"""device_idle.eval: the share of the traced window in which no
operation ran on the card (kernels, memcpys, memsets; their union), over
the classifier's eval passes. Layer: device. Moves eval_images_per_s."""


def read(window, info):
    if window.window_s <= 0 or window.busy_s <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
