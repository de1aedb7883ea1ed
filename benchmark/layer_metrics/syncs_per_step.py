"""Host syncs a value-and-grad step: the program's waits for the device
(stream, device and event synchronises, a scalar read among them) over
the traced steps; the harness's own are left out."""


def read(t):
    return None if t is None else t.per_unit(t.syncs)
