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

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    def scale_depth(self, factor: float) -> "DepthImage":
        """Multiply all depths, rounding back to u16."""
        return DepthImage(
            np.round(self.data.astype(np.float32) * factor).astype(np.uint16)
        )

    def truncate_depth_to(self, max_mm: int) -> "DepthImage":
        """Zero the depths beyond a cutoff."""
        out = self.data.copy()
        out[out > max_mm] = 0
        return DepthImage(out)

    def min_max(self) -> tuple[int, int]:
        """Min and max of the non-zero depths; (0, 0) when there is none."""
        nz = self.data[self.data > 0]
        if nz.size == 0:
            return (0, 0)
        return (int(nz.min()), int(nz.max()))
