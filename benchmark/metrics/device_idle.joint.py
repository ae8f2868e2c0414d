"""device_idle.joint: the share of the traced window in which no
operation ran on the card (kernels, memcpys, memsets; their union), over
the joint image + label train steps. Layer: device. Moves joint_edges_per_s."""


def read(window, info):
    if window.window_s <= 0 or window.busy_s <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
