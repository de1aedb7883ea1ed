"""The program's spans in a traced stretch: each device operation placed in
the innermost span open when it was launched, and each span's host time.

The program names its stages with ``tsdf_tpu_torch.utils.profiling.trace``
(function-scope records on the profiler's clock, none on the device's
timeline). This module reads them from the stopped profiler a driver's
:class:`~harness.common.Tracer` holds and hands the per-layer readers its
result in ``TraceSummary.extras["spans"]``: by span name, the instances
(``count``), their host seconds (``host_s``) and the device seconds of the
kernels, copies and sets launched inside them or a span they hold
(``device_s``); and, over the stretch, the device seconds in all
(``device_s``) and inside any of the spans (``inside_s``).

On the card a device operation is placed by its correlation id: the
runtime call that launched it (the CUDA API event of the same id), else
the operator the profiler linked it to. On the CPU, where the harness's
tests run the plain twins, the operators that stand for device operations
are the top-level ``aten::`` operators of the stretch, and the program's
spans are allowed above them: ``harness.trace`` takes only operators with
no parent but the window's record.
"""

from __future__ import annotations

import bisect
import sys
from unittest import mock

from . import trace as tracing


def summarize(tracer, units: int, extras: dict, prefix: str) -> tracing.TraceSummary:
    """``tracer.summarize`` with ``extras["spans"]``: the spans whose name
    starts with ``prefix``, and the device time placed in them."""
    on_card = tracer.ctx.device.type == "cuda"
    if on_card:
        spans, ops, window = _card_events(tracer.prof, prefix)
        summary = tracer.summarize(units, extras)
    else:
        spans, ops, window = _cpu_events(tracer.prof, prefix)
        with mock.patch.object(tracing, "_on_host_only", _under_spans(prefix)):
            summary = tracer.summarize(units, extras)
    summary.extras["spans"] = placed = attribute(spans, ops, *window)
    share = 100.0 * placed["inside_s"] / placed["device_s"] if placed["device_s"] else 0.0
    print(f"spans {prefix}*: {share:.3f} % of the traced device time inside them; "
          + ", ".join(f"{name} {v['count']}x host {v['host_s'] * 1e3:.3f} ms "
                      f"device {v['device_s'] * 1e3:.3f} ms"
                      for name, v in placed.items() if isinstance(v, dict)),
          file=sys.stderr)
    return summary


def attribute(spans, ops, w0: float, w1: float) -> dict:
    """Place each device operation ``(launch, start, end)`` in the
    innermost of ``spans`` ``[(name, start, end)]`` open at its launch,
    and count it in that span's ancestors too. Only what lies in the
    window [w0, w1] counts; operations are clipped to it."""
    spans = sorted((s for s in spans if w0 <= s[1] <= w1), key=lambda s: (s[1], -s[2]))
    parent, stack = [], []
    for i, (_name, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] < s:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    starts = [s for _n, s, _e in spans]
    out: dict = {}
    for name, s, e in spans:
        v = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
        v["count"] += 1
        v["host_s"] += e - s
    total = inside = 0.0
    for launch, s, e in ops:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        total += e - s
        i = _innermost(spans, starts, launch)
        if i is not None:
            inside += e - s
        while i is not None:
            out[spans[i][0]]["device_s"] += e - s
            i = parent[i]
    out["device_s"], out["inside_s"] = total, inside
    return out


def _innermost(spans, starts, t: float):
    """The index of the innermost span open at ``t``: the latest to start
    among those that have not ended (spans nest)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][2] >= t:
            return i
        i -= 1
    return None


def _card_events(prof, prefix: str):
    """(spans, device operations, window) in seconds from the profiler's
    Kineto events."""
    events = prof.profiler.kineto_results.events()
    frontend, runtime, spans, devices, window = {}, {}, [], [], None
    for ev in events:
        s = ev.start_ns() / 1e9
        e = s + ev.duration_ns() / 1e9
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if name != "bench.window":
                devices.append((ev.correlation_id(), ev.linked_correlation_id(), s, e))
            continue
        if ev.linked_correlation_id() > 0:
            runtime[ev.correlation_id()] = s
            continue
        frontend[ev.correlation_id()] = s
        if name == "bench.window":
            window = (s, e)
        elif name.startswith(prefix):
            spans.append((name, s, e))
    if window is None:
        raise RuntimeError("the trace holds no bench.window record")
    ops = []
    for corr, linked, s, e in devices:
        launch = runtime.get(corr, frontend.get(linked))
        ops.append((s if launch is None else launch, s, e))
    return spans, ops, window


def _cpu_events(prof, prefix: str):
    """(spans, operators standing for device operations, window) in
    seconds from the profiler's events of a run on the CPU."""
    on_host_only = _under_spans(prefix)
    spans, ops, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.name == "bench.window":
            window = (s, e)
        elif ev.name.startswith(prefix):
            spans.append((ev.name, s, e))
        elif on_host_only(ev):
            ops.append((s, s, e))
    if window is None:
        raise RuntimeError("the trace holds no bench.window record")
    return spans, ops, window


def _under_spans(prefix: str):
    """``harness.trace``'s test of a CPU run's top-level operator, with the
    spans named ``prefix...`` allowed between the operator and the
    window."""
    def on_host_only(e) -> bool:
        parent = e.cpu_parent
        while parent is not None and parent.name.startswith(prefix):
            parent = parent.cpu_parent
        return e.name.startswith("aten::") and (
            parent is None or parent.name == "bench.window")
    return on_host_only
