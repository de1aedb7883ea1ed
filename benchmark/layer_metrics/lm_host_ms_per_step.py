"""Host milliseconds a Levenberg-Marquardt step under the profiler: the
length of the program's ``lm.step`` spans over the traced steps, its one
host sync (the rms read of the trust rule) included
(``harness.spans``)."""


def read(t):
    span = None if t is None else (t.extras.get("spans") or {}).get("lm.step")
    return None if span is None else t.per_unit(span["host_s"] * 1e3)
