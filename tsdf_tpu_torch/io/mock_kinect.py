"""RGBD device abstraction with a disk-replay mock.

The port's own copy of ``tsdf_tpu/io/mock_kinect.py``, on the port's PNG
codec (the reference's ``RGBDDevice`` ABC + MockKinect, ref:
src/include/RGBDDevice.hpp:10-53, src/RGBDDevice/MockKinect.cpp): an
initialise/start/stop device with a single observer callback, and a
mock that replays ``colour_NNNNN.png`` / ``depth_NNNNN.png`` pairs from
a directory, checking that frame indices line up
(ref: MockKinect.cpp:19-100).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

import numpy as np

from .png import load_png

Observer = Callable[[np.ndarray, Optional[np.ndarray]], None]


class RGBDDevice:
    """Depth+RGB source firing an observer per frame."""

    def __init__(self):
        self._observer: Optional[Observer] = None

    def add_observer(self, observer: Observer) -> None:
        # single observer, like the reference (RGBDDevice.hpp:36-47)
        self._observer = observer

    def notify(self, depth: np.ndarray, colour: Optional[np.ndarray]):
        if self._observer is not None:
            self._observer(depth, colour)

    def initialise(self) -> None:
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass


_DEPTH_RE = re.compile(r"depth_(\d{5})\.png")
_COLOUR_RE = re.compile(r"colou?r_(\d{5})\.png")


class MockKinect(RGBDDevice):
    """Replays depth/colour PNG pairs from a directory.

    ref: MockKinect.cpp:19-100 — enumerates matching pairs, asserts the
    indices line up, fires the observer once per pair on start().
    """

    def __init__(self, directory: str):
        super().__init__()
        self.directory = directory
        self.pairs: list[tuple[str, Optional[str]]] = []

    def initialise(self) -> None:
        depths = {}
        colours = {}
        for f in os.listdir(self.directory):
            m = _DEPTH_RE.fullmatch(f)
            if m:
                depths[int(m.group(1))] = f
            m = _COLOUR_RE.fullmatch(f)
            if m:
                colours[int(m.group(1))] = f
        self.pairs = []
        for idx in sorted(depths):
            if colours and idx not in colours:
                raise ValueError(
                    f"depth frame {idx} has no matching colour frame"
                )
            self.pairs.append(
                (
                    os.path.join(self.directory, depths[idx]),
                    os.path.join(self.directory, colours[idx])
                    if colours
                    else None,
                )
            )

    def start(self) -> None:
        for depth_path, colour_path in self.pairs:
            depth = load_png(depth_path)
            colour = load_png(colour_path) if colour_path else None
            self.notify(depth, colour)
