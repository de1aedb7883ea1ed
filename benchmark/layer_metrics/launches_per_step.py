"""Kernel launches a value-and-grad step: every kernel the traced steps
ran on the device, over the steps."""


def read(t):
    return None if t is None else t.per_unit(len(t.kernels))
