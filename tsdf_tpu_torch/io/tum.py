"""TUM RGB-D dataset loader.

Port of ``tsdf_tpu/io/tum.py``: parses ``<dir>/ground_truth.txt`` lines
``timestamp tx ty tz qx qy qz qw``, loads ``<dir>/depth/<timestamp>.png``
through the zlib PNG codec, scales TUM depth (1/5000 m units) to mm
(x 0.2) and converts the 7-float pose to a 4x4 camera->world matrix with
translation in mm. Iteration decodes the depth frames ahead of the
consumer on a thread pool (``native.PNGPrefetcher``) where the native
library is available, as the JAX loader does with its own; a frame the
prefetcher refuses (not 16-bit grey) is loaded by ``load``, so both paths
give the same frames. ``iter_with_rgb`` decodes on the calling thread and
adds the colour frame ``<dir>/rgb/<timestamp>.png`` where there is one.
"""

from __future__ import annotations

import os

import numpy as np

from .depth_image import DepthImage


def tum_pose_matrix(vars7) -> np.ndarray:
    """7 floats (tx ty tz qx qy qz qw, metres) -> 4x4 pose, mm."""
    tx, ty, tz, x, y, z, w = [float(v) for v in vars7]
    pose = np.zeros((4, 4), dtype=np.float32)
    pose[0, 0] = 1 - 2 * (y * y + z * z)
    pose[0, 1] = 2 * (x * y - w * z)
    pose[0, 2] = 2 * (x * z + w * y)
    pose[1, 0] = 2 * (x * y + w * z)
    pose[1, 1] = 1 - 2 * (x * x + z * z)
    pose[1, 2] = 2 * (y * z - w * x)
    pose[2, 0] = 2 * (x * z - w * y)
    pose[2, 1] = 2 * (y * z + w * x)
    pose[2, 2] = 1 - 2 * (x * x + y * y)
    pose[0, 3] = tx * 1000.0
    pose[1, 3] = ty * 1000.0
    pose[2, 3] = tz * 1000.0
    pose[3, 3] = 1.0
    return pose


class TUMDataLoader:
    """Iterates (DepthImage, pose 4x4) pairs from a TUM directory."""

    def __init__(self, directory: str):
        self.directory = directory
        self.entries: list[tuple[str, np.ndarray]] = []
        gt = os.path.join(directory, "ground_truth.txt")
        with open(gt) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) != 8:
                    continue
                depth_path = os.path.join(
                    directory, "depth", f"{parts[0]}.png"
                )
                self.entries.append(
                    (depth_path, tum_pose_matrix(parts[1:8]))
                )
        self._cursor = 0

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        from .. import native

        if len(self.entries) > 1 and native.available():
            # JAX io/tum.py:72-95: decode ahead, at most the prefetch window
            # of frames resident; a frame that is not 16-bit grey raises
            # IOError there and is loaded here instead
            pf = native.PNGPrefetcher([p for p, _ in self.entries])
            try:
                for i, (path, pose) in enumerate(self.entries):
                    try:
                        frame = DepthImage(pf.get(i)).scale_depth(0.2)
                    except IOError:
                        frame = self.load(path)
                    yield frame, pose
            finally:
                pf.close()
            return
        for depth_path, pose in self.entries:
            yield self.load(depth_path), pose

    def next(self):
        """The next (DepthImage, pose), or (None, None) past the last
        frame. The cursor is the loader's own; iteration does not move it."""
        if self._cursor >= len(self.entries):
            return None, None
        depth_path, pose = self.entries[self._cursor]
        self._cursor += 1
        return self.load(depth_path), pose

    @staticmethod
    def load(depth_path: str) -> DepthImage:
        # TUM depth PNGs are in 1/5000 m; x 0.2 converts to mm.
        return DepthImage.from_png(depth_path).scale_depth(0.2)

    def iter_with_rgb(self):
        """Yield (DepthImage, pose, rgb | None) triples: ``rgb`` is the
        (H, W, 3) u8 image ``rgb/<stamp>.png`` sharing the depth frame's
        timestamp (a greyscale PNG is broadcast to three channels), or None
        where the file is missing."""
        from .png import load_png

        for depth_path, pose in self.entries:
            stamp = os.path.splitext(os.path.basename(depth_path))[0]
            rgb_path = os.path.join(self.directory, "rgb", f"{stamp}.png")
            rgb = None
            if os.path.exists(rgb_path):
                img = load_png(rgb_path)
                if img.ndim == 2:
                    img = np.repeat(img[..., None], 3, axis=-1)
                rgb = np.ascontiguousarray(img[..., :3].astype(np.uint8))
            yield self.load(depth_path), pose, rgb
