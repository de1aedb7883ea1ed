"""Observability: device-true sync, timed spans, profiler traces, and
the two timing helpers every number of the port's record rests on.

Port of ``tsdf_tpu/utils/profiling.py`` on the card's own tools:

  * ``sync(x)``: wait for the device of the first tensor leaf of ``x``
    and return that leaf's sum as a float;
  * ``Timer``: a wall-clock span that syncs its result, with derived
    rates, logged as one JSON line on the logger ``tsdf_tpu_torch``;
  * ``trace(name, index=None)``: the program's span, a region of the
    ``torch.profiler`` trace (on the kernels' clock), and nothing at all
    when no profiler runs;
  * ``count(name, n)``, ``count_tensor(name, t)`` and ``counting()``:
    the program's counters, read once when counting closes;
  * ``profile_to(dir)``: a ``torch.profiler`` trace file written into
    ``dir`` (TensorBoard's and Perfetto's format);
  * ``median_ms``: the median CUDA-event time of a call, its launches
    queued behind a ~20 ms blocker so that the host's launch latency is
    not what is timed;
  * ``profile_step``: a call under ``torch.profiler``: the card's busy
    time, kernel launches and host syncs a call, and the top kernels and
    host operators.

``median_ms`` and ``profile_step`` need an NVIDIA card; the rest also run
on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Optional

import numpy as np
import torch

log = logging.getLogger("tsdf_tpu_torch")


def _first_tensor(x) -> torch.Tensor:
    """The first tensor leaf of a nest of tensors, dataclasses (fields in
    order), dicts (keys sorted, as JAX orders a dict's leaves), lists and
    tuples."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        children = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        children = [x[k] for k in sorted(x)]
    elif isinstance(x, (list, tuple)):
        children = list(x)
    else:
        children = []
    for child in children:
        try:
            return _first_tensor(child)
        except ValueError:
            continue
    raise ValueError(f"no tensor in {type(x).__name__}")


def sync(x) -> float:
    """Block until the first tensor leaf of ``x`` is computed; returns
    the float sum of that leaf (of it alone, not of the whole nest)."""
    leaf = _first_tensor(x)
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return float(leaf.to(torch.float32).sum())


class Timer:
    """A timed span with derived rates.

    >>> with Timer("integrate", voxels=512**3) as t:
    ...     vol = integrate(vol, depth, cam)
    ...     t.result = vol
    """

    def __init__(self, name: str, **counts):
        self.name = name
        self.counts = counts
        self.result = None
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.result is not None:
            sync(self.result)
        self.elapsed = time.perf_counter() - self._t0
        rates = {
            f"{k}_per_s": v / self.elapsed for k, v in self.counts.items()
        }
        log.info(
            "%s",
            json.dumps(
                {"span": self.name, "ms": round(self.elapsed * 1e3, 3), **rates}
            ),
        )
        return False

    def rate(self, key: str) -> float:
        return self.counts[key] / self.elapsed


# The span with no profiler running: one shared context that does nothing.
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
_Span = torch._C._profiler._RecordFunctionFast


def trace(name: str, index: Optional[int] = None):
    """The program's span: a region named ``name`` in the running
    ``torch.profiler`` trace. Spans nest as the regions are entered; the
    kernels a region launches are its children by their correlation ids.
    ``index`` (the frame or step number) is the record's keyword argument
    ``index``, which the trace shows where the profiler records inputs
    (``record_shapes=True``).

    The region is a function-scope record, entered without the
    dispatcher: unlike a ``record_function`` user annotation it puts no
    copy of itself on the device's timeline, so the trace's device events
    are the kernels, copies and sets alone. With no profiler running the
    call is one flag check and returns a shared context that does
    nothing: no operator, launch or sync either way."""
    if not _profiler_enabled():
        return _NO_SPAN
    if index is None:
        return _Span(name)
    return _Span(name, (), {"index": index})


class Counts:
    """The program's counters while a ``counting()`` block is open: sums
    of host numbers, and 0-d tensors the program already computed, kept
    by reference and summed only in :meth:`totals`."""

    def __init__(self):
        self.host: dict[str, float] = {}
        self.tensors: dict[str, list[torch.Tensor]] = {}

    def totals(self) -> dict:
        """Every counter's total, by name: an int where every value was
        integral, else a float. Each tensor counter is summed on its device
        and read once (a host sync apiece): call it after the measured
        stretch."""
        out = dict(self.host)
        for name, ts in self.tensors.items():
            total = torch.stack([t.reshape(()).to(torch.float64) for t in ts]).sum()
            integral = not any(t.is_floating_point() for t in ts)
            out[name] = out.get(name, 0) + (int(total) if integral else float(total))
        return dict(sorted(out.items()))


_COUNTS: Optional[Counts] = None


@contextlib.contextmanager
def counting():
    """Open the program's counters for the block; yields the
    :class:`Counts` that ``count`` and ``count_tensor`` add to. A nested
    block counts on its own and restores the outer one's on exit."""
    global _COUNTS
    outer, counts = _COUNTS, Counts()
    _COUNTS = counts
    try:
        yield counts
    finally:
        _COUNTS = outer


def count(name: str, n=1) -> None:
    """Add ``n``, a number the host already holds, to counter ``name``;
    with counting closed, one check and nothing else."""
    counts = _COUNTS
    if counts is not None:
        counts.host[name] = counts.host.get(name, 0) + n


def count_tensor(name: str, t: torch.Tensor) -> None:
    """Add the 0-d tensor ``t`` to counter ``name`` by reference: no copy,
    launch or read until ``Counts.totals``; with counting closed, one
    check and nothing else."""
    counts = _COUNTS
    if counts is not None:
        counts.tensors.setdefault(name, []).append(t)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host operators,
    and the card's kernels where there is a card) into a file in
    ``log_dir``, which is made if need be."""
    from torch.profiler import profile, tensorboard_trace_handler

    with profile(
        activities=_activities(),
        on_trace_ready=tensorboard_trace_handler(log_dir),
    ):
        yield


def configure_logging(level=logging.INFO) -> None:
    """One-JSON-line logging to stderr. Idempotent: a handler is added
    once, and a repeated call only sets the level."""
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(message)s")
        )
        log.addHandler(handler)
    log.setLevel(level)


# Clock cycles the card spins before each timed run (about 20 ms): the
# launches under test queue up behind it, so a kernel of a few
# microseconds is timed back to back with its neighbours and not by the
# time the host takes to launch it.
BLOCKER_CYCLES = 40_000_000


def median_ms(fn, reps: int, warmup: int = 1, inner: int = 1) -> float:
    """Median CUDA-event time of one ``fn()`` over ``reps`` runs of
    ``inner`` calls each, queued behind a blocker on the stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BLOCKER_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


# the host-side events of a sync: a scalar read, or an explicit wait
_SYNC_EVENTS = (
    "aten::_local_scalar_dense",
    "cudaStreamSynchronize",
    "cudaDeviceSynchronize",
)


def profile_step(fn, n: int = 3) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``. Returns, a call:
    ``busy_ms`` (the card's kernel time), ``launches`` (kernels),
    ``syncs`` (host syncs), ``top`` (the five kernels of most device
    time, each [name, launches a call, ms a call]) and ``host`` (the four
    host operators of most self time, each [name, calls a call, ms a
    call, µs a single call])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    syncs = sum(e.count for e in events if e.key in _SYNC_EVENTS) / n
    top = [[e.key[:60], e.count // n, e.self_device_time_total / 1e3 / n]
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]]
    cpu = [e for e in events if not str(e.device_type).endswith("CUDA")]
    host = [[e.key[:40], e.count // n, e.self_cpu_time_total / 1e3 / n,
             e.self_cpu_time_total / max(e.count, 1)]
            for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:4]]
    return dict(busy_ms=busy_ms, launches=launches, syncs=syncs, top=top,
                host=host)
