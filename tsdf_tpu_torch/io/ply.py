"""ASCII PLY mesh writer (port of ``tsdf_tpu/io/ply.py``; same bytes)."""

from __future__ import annotations

import numpy as np


def write_ply(path, vertices, triangles, colors=None) -> None:
    """vertices: (N, 3) float mm; triangles: (M, 3) int vertex indices;
    colors: optional (N, 3) u8 RGB per vertex.

    A coordinate is written as the repr of its float32 value widened to a
    Python float. The arrays are turned into Python lists once
    (``tolist``) and formatted from there: indexing numpy scalars row by
    row takes several times as long on a mesh of millions of vertices.
    """
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    if colors is not None:
        colors = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
        if len(colors) != len(vertices):
            raise ValueError(
                f"{len(colors)} colours for {len(vertices)} vertices"
            )
    with open(path, "w") as f:
        f.write("ply\n")
        f.write("format ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
            )
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        rows = vertices.astype(np.float64).tolist()
        if colors is None:
            f.write("".join([f"{x} {y} {z}\n" for x, y, z in rows]))
        else:
            f.write("".join([
                f"{x} {y} {z} {r} {g} {b}\n"
                for (x, y, z), (r, g, b) in zip(rows, colors.tolist())
            ]))
        f.write("".join([f"3 {a} {b} {c}\n" for a, b, c in triangles.tolist()]))
