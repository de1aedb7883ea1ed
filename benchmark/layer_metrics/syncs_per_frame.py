"""Host syncs a frame: the program's waits for the device (stream,
device and event synchronises, a scalar read among them) over the traced
frames; the harness's own are left out."""


def read(t):
    return None if t is None else t.per_unit(t.syncs)
