"""ASCII PLY mesh writer (port of ``tsdf_tpu/io/ply.py``; same bytes)."""

from __future__ import annotations

import numpy as np


def write_ply(path, vertices, triangles) -> None:
    """vertices: (N, 3) float mm; triangles: (M, 3) int vertex indices."""
    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int64)
    with open(path, "w") as f:
        f.write("ply\n")
        f.write("format ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
