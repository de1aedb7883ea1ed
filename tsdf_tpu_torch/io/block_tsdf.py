"""The line-oriented text TSDF format ("BlockTSDF").

Port of ``tsdf_tpu/io/block_tsdf.py``; the two writers give the same
bytes. Header lines ``voxel_size= sx sy sz`` and
``physical_size= px py pz``, then for each (x, y), x fastest, a pair of
lines: the distances for all z, then the weights for all z. '#' comments
and blank lines are skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..volume import TSDFVolume, make_volume


def load_block_tsdf(path: str, *, device) -> TSDFVolume:
    """Load a BlockTSDF file onto ``device``: a volume with its offset at
    the origin and the default truncation and maximum weight."""
    lines = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            lines.append(line)
    if len(lines) < 2:
        raise ValueError(f"{path}: truncated BlockTSDF file")
    size = [int(v) for v in lines[0].split("=", 1)[1].split()]
    psize = [float(v) for v in lines[1].split("=", 1)[1].split()]
    sx, sy, sz = size
    if len(lines) != 2 + 2 * sx * sy:
        raise ValueError(
            f"{path}: expected {2 * sx * sy} data lines, got "
            f"{len(lines) - 2}"
        )
    data = np.loadtxt(lines[2:], dtype=np.float32, ndmin=2)
    if data.shape != (2 * sx * sy, sz):
        raise ValueError(f"{path}: bad data shape {data.shape}")
    # even rows are distances, odd rows weights; row i covers
    # (x, y) = (i // 2 % sx, i // 2 // sx) and its columns are z
    dist = np.transpose(data[0::2].reshape(sy, sx, sz), (2, 0, 1))
    weight = np.transpose(data[1::2].reshape(sy, sx, sz), (2, 0, 1))
    vol = make_volume((sx, sy, sz), psize, offset=(0.0, 0.0, 0.0),
                      device=device)
    return vol.replace(
        tsdf=torch.tensor(np.ascontiguousarray(dist), device=device),
        weight=torch.tensor(np.ascontiguousarray(weight), device=device),
    )


def save_block_tsdf(vol: TSDFVolume, path: str) -> None:
    """Write ``vol``'s distances and weights, each value as the repr of
    its float."""
    sx, sy, sz = vol.size
    # [z, y, x]; bf16 storage widened to f32 (numpy has no bfloat16)
    dist = vol.tsdf.detach().cpu().float().numpy()
    weight = vol.weight.detach().cpu().float().numpy()
    ps = vol.physical_size.detach().cpu().numpy()
    with open(path, "w") as f:
        f.write(f"voxel_size= {sx} {sy} {sz}\n")
        f.write(f"physical_size= {ps[0]} {ps[1]} {ps[2]}\n")
        for y in range(sy):
            for x in range(sx):
                f.write(" ".join(repr(float(v)) for v in dist[:, y, x]))
                f.write("\n")
                f.write(" ".join(repr(float(v)) for v in weight[:, y, x]))
                f.write("\n")
