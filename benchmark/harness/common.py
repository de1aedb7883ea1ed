"""What every driver shares: the run's context, the frame window, the
traced stretch and the outcome a driver hands back."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from . import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "tsdf_tpu_torch" / "csrc"


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    # the control: the program with its lower-precision storage switched
    # on ("bfloat16"); None in every benchmark run
    control: Optional[str] = None

    @property
    def storage(self) -> torch.dtype:
        return torch.bfloat16 if self.control == "bfloat16" else torch.float32

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    """What a driver measured and checked."""

    attempted: int
    failed: int
    metrics: dict  # end-to-end candidates by name
    checks: list  # [(name, value, limit)]: correct iff every value <= limit
    window_start: float  # perf_counter at the window's start
    memory_peak_bytes: int
    trace: Optional[tracing.TraceSummary] = None


class Tracer:
    """The profiler over a bounded stretch at the window's start."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.prof = None
        self.record = None
        self.active = False
        self.harness_syncs = 0  # the harness's own syncs while tracing

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.record = torch.profiler.record_function("bench.window")
        self.record.__enter__()
        self.active = True

    def stop(self) -> None:
        self.ctx.sync()
        self.harness_syncs += 1
        self.record.__exit__(None, None, None)
        self.prof.stop()
        self.active = False

    def summarize(self, units: int, extras: dict) -> tracing.TraceSummary:
        return tracing.summarize(self.prof, units, self.harness_syncs,
                                 tracing.port_kernel_names(CSRC), extras,
                                 on_card=self.ctx.device.type == "cuda")


class FrameWindow:
    """Hands a program's loop its frames: ``warmup`` frames of set-up,
    then frames until ``seconds`` have passed since the window opened.

    With ``one_in_flight`` the next frame is handed over only when the
    device has finished the last (one host sync of the harness a frame),
    and each window frame's latency runs from its hand-over to that
    point. Without it frames stream with no wait, as a replay of saved
    frames does, and one sync ends the window (``close``)."""

    def __init__(self, ctx: Ctx, warmup: int, one_in_flight: bool,
                 trace_frames: int = 0):
        self.ctx = ctx
        self.warmup = warmup
        self.one_in_flight = one_in_flight
        self.trace_frames = trace_frames if ctx.trace else 0
        self.tracer = Tracer(ctx) if self.trace_frames else None
        self.handed = 0  # frames handed over, set-up included
        self.window_frames = 0
        self.latencies: list[float] = []
        self.start: Optional[float] = None
        self.end: Optional[float] = None

    def _open(self) -> None:
        self.ctx.sync()
        if self.tracer:
            self.tracer.start()
        self.start = time.perf_counter()

    def frames(self, frame_at: Callable[[int], object]) -> Iterator:
        """Yield ``frame_at(i)`` for i = 0, 1, ... until the window's
        time is up."""
        while True:
            if self.handed == self.warmup:
                self._open()
            in_window = self.handed >= self.warmup
            if in_window and time.perf_counter() - self.start >= self.ctx.seconds:
                return
            item = frame_at(self.handed)
            t_in = time.perf_counter()
            self.handed += 1
            yield item
            if self.one_in_flight:
                self.ctx.sync()
                if self.tracer and self.tracer.active:
                    self.tracer.harness_syncs += 1
                if in_window:
                    self.latencies.append(time.perf_counter() - t_in)
            if in_window:
                self.window_frames += 1
                if self.tracer and self.window_frames == self.trace_frames:
                    self.tracer.stop()

    def close(self) -> None:
        """The window's end: the device has finished every frame."""
        self.ctx.sync()
        self.end = time.perf_counter()
        if self.tracer and self.window_frames < self.trace_frames:
            self.tracer.stop()

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def rate(self) -> float:
        return self.window_frames / self.seconds

    def p95_ms(self) -> float:
        return float(np.percentile(np.asarray(self.latencies), 95)) * 1e3


def memory_peak(ctx: Ctx) -> int:
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.device))


def sample(rng: np.random.Generator, population: int, k: int) -> list[int]:
    """k indices of range(population) drawn from the seed, sorted, the
    last one always among them."""
    k = min(k, population)
    if k <= 0:
        return []
    rest = rng.choice(population - 1, size=k - 1, replace=False) if k > 1 else []
    return sorted({*map(int, rest), population - 1})
