"""Depth image container: u16 (H, W) millimetres on the host.

Port of ``tsdf_tpu/io/depth_image.py`` (numpy only); converted to a
tensor at the device boundary.
"""

from __future__ import annotations

import numpy as np

from .png import load_png


class DepthImage:
    """u16 (H, W) depth in mm."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim != 2:
            raise ValueError("depth image must be 2-D")
        self.data = data.astype(np.uint16)

    @classmethod
    def from_png(cls, path) -> "DepthImage":
        return cls(load_png(path))

    def scale_depth(self, factor: float) -> "DepthImage":
        """Multiply all depths, rounding back to u16."""
        return DepthImage(
            np.round(self.data.astype(np.float32) * factor).astype(np.uint16)
        )
