"""device_idle_share (%): the share of the traced window in which no
device operation ran, from the union of the operations' intervals.
Layer: device."""


def read(trace):
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
