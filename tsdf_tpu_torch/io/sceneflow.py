"""Scene-flow providers: SRSF XML and PD-Flow text, with mock replay.

The port's own copy of ``tsdf_tpu/io/sceneflow.py`` (numpy and the
standard library only): a provider is an object whose
``compute_scene_flow`` returns (translation, rotation, flow); the two mock
implementations replay canned files from a directory in sorted order
(ref: MockSceneFlowAlgorithm.cpp:41-109), parsed with the stdlib XML
parser and ``numpy.loadtxt``.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np


def read_srsf_xml(path: str):
    """Read an SRSF scene-flow XML file.

    Schema (ref: SRSFMockSceneFlowAlgorithm.cpp:64-169): root contains
    Translation/data (3 floats), Rotation/data (3 floats), and SFx, SFy,
    SFz nodes each with rows, cols and data children.

    Returns (translation (3,), rotation (3,), flow (H, W, 3) f32).
    """
    root = ET.parse(path).getroot()

    def floats(node):
        return np.array(
            [float(v) for v in node.findtext("data").split()], np.float32
        )

    translation = floats(root.find("Translation"))
    rotation = floats(root.find("Rotation"))

    planes = []
    for name in ("SFx", "SFy", "SFz"):
        node = root.find(name)
        rows = int(node.findtext("rows"))
        cols = int(node.findtext("cols"))
        planes.append(floats(node).reshape(rows, cols))
    flow = np.stack(planes, axis=-1)
    return translation, rotation, flow


def read_pdflow(path: str) -> np.ndarray:
    """Read a PD-Flow text file -> (H, W, 3) f32 flow in mm.

    Each line is ``y x sfz sfx sfy`` in metres; flow components are
    reordered to (sfx, sfy, sfz) and scaled x1000
    (ref: PDSFMockSceneFlowAlgorithm.cpp:41-91 — "order of coords is
    Z, X, Y"). Image dims come from the last line's (y, x) + 1.
    """
    rows = np.loadtxt(path, dtype=np.float32)
    height = int(rows[-1, 0]) + 1
    width = int(rows[-1, 1]) + 1
    flow = np.empty((height * width, 3), np.float32)
    flow[:, 0] = rows[:, 3] * 1000.0
    flow[:, 1] = rows[:, 4] * 1000.0
    flow[:, 2] = rows[:, 2] * 1000.0
    return flow.reshape(height, width, 3)


class MockSceneFlow:
    """Directory-replay scene-flow provider (the reference's mock ABC).

    ref: MockSceneFlowAlgorithm.cpp — scans a directory for files
    matching a pattern, sorts them, plays one back per call.
    """

    pattern: re.Pattern

    def __init__(self, directory: str):
        self.directory = directory
        self.files: list[str] = []
        self.index = 0

    def init(self) -> bool:
        names = sorted(
            f
            for f in os.listdir(self.directory)
            if self.pattern.fullmatch(f)
        )
        self.files = [os.path.join(self.directory, f) for f in names]
        return len(self.files) > 0

    def compute_scene_flow(self, depth=None, rgb=None):
        """Return (translation (3,), rotation (3,), flow (H, W, 3) mm).

        Raises when the directory is exhausted — silently replaying the
        last flow would advance the warp field with stale data.
        """
        if self.index >= len(self.files):
            raise RuntimeError(
                f"scene-flow directory exhausted after "
                f"{len(self.files)} files ({self.directory})"
            )
        path = self.files[self.index]
        self.index += 1
        return self._read(path)

    def _read(self, path):
        raise NotImplementedError


class SRSFMockSceneFlow(MockSceneFlow):
    """ref: SRSFMockSceneFlowAlgorithm.cpp:171-176 (sflow_NNNNN.xml)."""

    pattern = re.compile(r"sflow_\d{5}\.xml")

    def _read(self, path):
        return read_srsf_xml(path)


class PDSFMockSceneFlow(MockSceneFlow):
    """ref: PDSFMockSceneFlowAlgorithm.cpp:120-125
    (sflow_NNNNN_results01.txt)."""

    pattern = re.compile(r"sflow_\d{5}_results01\.txt")

    def _read(self, path):
        flow = read_pdflow(path)
        zero = np.zeros(3, np.float32)
        return zero, zero, flow
