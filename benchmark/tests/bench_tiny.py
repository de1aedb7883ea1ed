"""Tiny versions of the cells for the harness's tests on the CPU."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def resize(config: dict, traffic: dict) -> None:
    """Cut a configuration to a 40^3 volume and 160x120 frames, and the
    mix to a few frames of set-up and trace."""
    config["volume"]["size"] = 40
    cam = config["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] /= 4
    cam["width"], cam["height"] = 160, 120
    if "trajectory" in config:
        config["trajectory"]["period"] = 60
    if "scenefusion" in config:
        config["scenefusion"]["max_cubes"] = 16384
    for key in ("warmup_frames",):
        if key in traffic:
            traffic[key] = min(traffic[key], 3)
    for key in ("trace_frames", "trace_recoveries"):
        if key in traffic:
            traffic[key] = 2
    if "problems" in traffic:
        traffic["problems"] = 2


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 1.5,
             trace: int = 0, control=None) -> dict:
    import torch

    import run

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, control=control)
    return run.run(args, device=torch.device("cpu"), resize=resize)
