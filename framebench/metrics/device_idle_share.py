"""The share of the traced window of graph frames in which no kernel ran
on the device, in %: one minus the union of kernel intervals over the
window (the device layer)."""


def read(r):
    if not r.kernels or r.traced_window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.traced_window_s)
