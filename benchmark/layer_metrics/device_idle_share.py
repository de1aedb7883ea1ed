"""The share of the traced stretch in which no operation ran on the
device: 1 - (union of the kernels', copies' and sets' intervals) over
the stretch's host time, in percent. ``device_idle_share.step``, the same
quantity in the cells that count steps, reads it here too."""


def read(t):
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
