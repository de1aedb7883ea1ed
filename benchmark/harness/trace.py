"""The traced run: a bounded stretch of the window under ``torch.profiler``,
reduced to what the per-layer readers and the result's ``breakdown``
need.

Nothing here knows a metric: each reader in ``benchmark/layer_metrics/``
takes a :class:`TraceSummary` and returns its number, or None where the
trace holds nothing for it.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from pathlib import Path

# host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
_MEM_OPS = ("Memcpy", "Memset")


@dataclasses.dataclass
class TraceSummary:
    """One traced stretch of a window."""

    window_s: float  # host time of the traced stretch
    units: int  # frames or steps in it
    kernels: list  # [(name, start_s, end_s)] kernels on the device
    mem_ops: list  # [(name, start_s, end_s)] copies and sets on the device
    syncs: int  # the program's host syncs (the harness's own left out)
    gaps: list  # [(label, seconds)] device idle gaps by host activity
    port_kernels: frozenset  # names of the kernels built from csrc/
    extras: dict  # what the driver counted for the readers (bounds, calls)

    def busy_s(self) -> float:
        """The union of the intervals in which any operation ran on the
        device."""
        return union_s([(s, e) for _n, s, e in self.kernels + self.mem_ops])

    def per_unit(self, count: float):
        """``count`` over the traced frames or steps; None where the
        stretch holds none."""
        return count / self.units if self.units else None

    def is_port_kernel(self, name: str) -> bool:
        return kernel_base_name(name) in self.port_kernels

    def kernel_time_s(self, names) -> tuple[float, int]:
        """(device seconds, launches) of the port's kernels whose base
        name is in ``names``."""
        total, n = 0.0, 0
        for name, s, e in self.kernels:
            if kernel_base_name(name) in names:
                total += e - s
                n += 1
        return total, n


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        elif e > end:
            end = e
    if end is not None:
        total += end - start
    return total


def idle_gaps(intervals, t0: float, t1: float):
    """The (start, end) gaps in [t0, t1] that no interval covers."""
    gaps, cursor = [], t0
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
        if cursor >= t1:
            break
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(s, e) for s, e in gaps if e > s]


_GLOBAL = re.compile(
    r"__global__ (?:static )?void (?:__launch_bounds__ ?\([^)]*\) ?)?"
    r"([A-Za-z_]\w*) ?\(")


def port_kernel_names(csrc: Path) -> frozenset:
    """The names of the ``__global__`` functions in the program's CUDA
    sources: the kernels that are the port's own."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(re.sub(r"\s+", " ", path.read_text())))
    return frozenset(names)


def kernel_base_name(name: str) -> str:
    """A demangled kernel name without return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::walk<float,
    true>(float*, ...)`` is ``walk``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), 1)[0]
    words = head.split()
    return words[-1].split("::")[-1] if words else name


def _label(host, starts, mid: float) -> str:
    """What the host was doing at ``mid``: the innermost host event that
    spans it among the latest that began before it, else the last that
    ended before it."""
    i = bisect.bisect_right(starts, mid)
    spanning = [h for h in host[max(0, i - 64):i] if h[2] >= mid]
    if spanning:
        return min(spanning, key=lambda h: h[2] - h[1])[0]
    return host[i - 1][0] + " (after)" if i else "host"


def _on_host_only(e) -> bool:
    """A top-level operator of a run on the CPU: the harness's tests read
    those as a CPU run's device operations."""
    parent = e.cpu_parent
    return e.name.startswith("aten::") and (
        parent is None or parent.name == "bench.window")


def summarize(prof, units: int, harness_syncs: int, port_kernels: frozenset,
              extras: dict, on_card: bool = True) -> TraceSummary:
    """Reduce a stopped ``torch.profiler.profile`` to a TraceSummary.
    The stretch is the span of the ``bench.window`` record the driver
    opened around it."""
    events = prof.events()
    window = [e for e in events if e.name == "bench.window"]
    if not window:
        raise RuntimeError("the trace holds no bench.window record")
    w0 = min(e.time_range.start for e in window) / 1e6
    w1 = max(e.time_range.end for e in window) / 1e6
    kernels, mem_ops, host, syncs = [], [], [], 0
    for e in events:
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if str(e.device_type).endswith("CUDA") or (
                not on_card and _on_host_only(e)):
            # the harness's own record shows on the device's timeline too
            if e.name == "bench.window" or t < w0 or s > w1:
                continue
            s, t = max(s, w0), min(t, w1)
            if e.name.startswith(_MEM_OPS):
                mem_ops.append((e.name, s, t))
            else:
                kernels.append((e.name, s, t))
            continue
        if e.name in SYNC_CALLS and w0 <= s <= w1:
            syncs += 1
        if e.name != "bench.window" and w0 <= s <= w1:
            host.append((e.name, s, t))
    if not kernels:
        raise RuntimeError("the trace holds no kernel on the device")
    device = [(s, e) for _n, s, e in kernels + mem_ops]
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = [(_label(host, starts, (s + e) / 2), e - s)
            for s, e in idle_gaps(device, w0, w1)]
    return TraceSummary(window_s=w1 - w0, units=units, kernels=kernels,
                        mem_ops=mem_ops,
                        syncs=max(syncs - harness_syncs, 0), gaps=gaps,
                        port_kernels=port_kernels, extras=extras)


def breakdown(t: TraceSummary, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each summed by name, at most ``top`` of each."""
    ops: dict = {}
    for name, s, e in t.kernels + t.mem_ops:
        key = kernel_base_name(name) if "(" in name else name
        ops[key] = ops.get(key, 0.0) + (e - s)
    gaps: dict = {}
    for label, sec in t.gaps:
        gaps[label] = gaps.get(label, 0.0) + sec
    order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gorder = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in gorder]}
