"""The share of the traced window (of training steps or of evaluations)
in which no kernel, copy or fill ran on the device."""


def read(view):
    if view.window_s <= 0 or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
