"""Marching-cubes surface extraction over the dense volume.

Port of the full-volume path of ``tsdf_tpu/ops/marching_cubes.py``
(``_extract_arrays`` with ``tpu_safe=False``, dense and masked layouts):

  1. classify every cube from 8 shifted sign slices;
  2. compact the occupied cubes in ascending cube-id order, with each
     cube's vertex write offset from an exclusive cumsum of its vertex
     count;
  3. gather corner values, interpolate the 12 edge zero-crossings, look
     up the triangulation, resolve each triangle slot's edge, and
     scatter the vertices densely to [0, n_vertices) (dense layout) or
     leave them at their (cube, slot) position under a mask (masked
     layout, which is queued on the device without a host read).

The two table lookups (vertex counts and the triangle table) and the
edge -> slot resolution go through ``kernels.gather.lane_gather_op``:
the CUDA lane-gather kernel on a CUDA tensor, its plain twin on the CPU.
The TPU-only compactions of the JAX module (chunked, sort and matmul
scatter) are not ported.

Triangle soup semantics: every 3 consecutive valid vertices form one
triangle, normals pointing toward positive TSDF; each vertex carries the
flat indices of the two voxels bracketing its edge.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.gather import lane_gather_op
from ..volume import TSDFVolume
from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, MAX_TRIS, TRI_TABLE, VERT_COUNTS

_MAX_V = MAX_TRIS * 3


class TriangleSoup(NamedTuple):
    """Fixed-size triangle soup; vertices are valid in [0, n_vertices)."""

    vertices: torch.Tensor  # (max_vertices, 3) f32 world mm
    vertex_voxels: torch.Tensor  # (max_vertices, 2) i32 flat voxel indices
    n_vertices: torch.Tensor  # () i32, number of valid vertices
    overflowed: torch.Tensor  # () bool, the buffers were too small
    valid: torch.Tensor  # (max_vertices,) bool


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The marching-cubes tables as tensors on ``device``, copied once: a
    copy from the host per extraction would be a blocking transfer in a
    loop that otherwise never waits for the host. Returns (vertex counts
    (256,), triangle table (256 * 24,), the two corners of each edge
    (12,) each)."""
    return (
        torch.as_tensor(VERT_COUNTS, dtype=torch.int32, device=device),
        torch.as_tensor(TRI_TABLE.reshape(-1), dtype=torch.int32, device=device),
        torch.as_tensor(EDGE_CORNERS[:, 0], dtype=torch.int64, device=device),
        torch.as_tensor(EDGE_CORNERS[:, 1], dtype=torch.int64, device=device),
    )


def _table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = table[idx[r, c]] for a small shared 1-D table: the
    table is broadcast over the rows (stride 0), not copied."""
    w = table.shape[0]
    rows = idx.shape[0]
    idx = idx.clamp(0, w - 1).to(torch.int32).contiguous()
    return lane_gather_op(table[None, :].expand(rows, w), idx)


def _slot_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = table[r, idx[r, c]] for a narrow per-row table."""
    return lane_gather_op(table.contiguous(), idx.to(torch.int32).contiguous())


def extract_surface(
    vol: TSDFVolume,
    max_cubes: int = 1 << 18,
    max_vertices: int = 1 << 20,
    layout: str = "dense",
) -> TriangleSoup:
    """Extract the zero isosurface (tsdf < 0 is inside) as a soup.

    ``max_cubes``/``max_vertices`` are the buffer capacities; when either
    is exceeded ``overflowed`` is set and the soup holds what fitted.

    layout:
      "dense": vertices compacted to [0, n_vertices): the layout for mesh
        export. Sizing the export reads counts on the host.
      "masked": vertices stay at their (cube, slot) position in a buffer of
        ``max_cubes * 24`` slots and ``valid`` marks the live ones
        (``max_vertices`` is unused; ``overflowed`` is
        ``occupied cubes > max_cubes``). Masked consumers (the SceneFusion
        deformation update) need no compaction, and this layout reads
        nothing on the host: the whole extraction is queued on the device.
    """
    # bf16 storage: interpolate in f32
    return _extract(
        vol.tsdf.to(torch.float32), vol.voxel_size, vol.offset, max_cubes,
        max_vertices, layout,
    )


def _classify(d):
    """Phase 1: the 8-bit corner-sign type of every cube, flat in cube-id
    order, and which cubes the surface crosses."""
    Z, Y, X = d.shape
    cz, cy, cx = Z - 1, Y - 1, X - 1
    inside = (d < 0.0).to(torch.uint8)
    cube_type = torch.zeros((cz, cy, cx), dtype=torch.uint8, device=d.device)
    for k in range(8):
        dx, dy, dz = (int(v) for v in CORNER_OFFSETS[k])
        cube_type |= inside[dz : dz + cz, dy : dy + cy, dx : dx + cx] << k
    cube_type = cube_type.reshape(-1)
    return cube_type, (cube_type != 0) & (cube_type != 255)


def _compact_on_host_counts(cube_type, occupied, max_cubes):
    """Phase 2 of the dense layout: the occupied cubes in ascending id
    order (``nonzero``, which reads their count on the host), each with its
    vertex write offset. Returns (cid, types, cube_valid, cube_offsets,
    n_occ, n_verts), the two counts as Python ints."""
    dev = cube_type.device
    i64 = torch.int64
    occ_ids = torch.nonzero(occupied).squeeze(1)
    n_occ = occ_ids.numel()
    types_occ = cube_type[occ_ids].to(torch.int32)
    vert_counts = _device_tables(dev)[0]
    counts = _table_lookup(vert_counts, types_occ[:, None])[:, 0].to(i64)
    offsets_all = torch.cumsum(counts, 0) - counts
    n_verts = int(counts.sum())

    m = min(n_occ, max_cubes)
    cid = torch.zeros(max_cubes, dtype=i64, device=dev)
    cid[:m] = occ_ids[:m]
    cube_offsets = torch.zeros(max_cubes, dtype=i64, device=dev)
    cube_offsets[:m] = offsets_all[:m]
    types = torch.zeros(max_cubes, dtype=torch.int32, device=dev)
    types[:m] = types_occ[:m]
    cube_valid = torch.arange(max_cubes, device=dev) < n_occ
    return cid, types, cube_valid, cube_offsets, n_occ, n_verts


def _compact_on_device(cube_type, occupied, max_cubes):
    """Phase 2 of the masked layout, with no host read: the j-th occupied
    cube is the first cube whose running count of occupied cubes reaches
    j + 1, found by a binary search of the cumulative count. Returns
    (cid, types, cube_valid, n_occ, n_verts), the two counts as 0-d
    tensors; ``n_verts`` counts every occupied cube, captured or not."""
    dev = cube_type.device
    vert_counts = _device_tables(dev)[0]
    counts = _table_lookup(vert_counts, cube_type.to(torch.int32)[:, None])
    n_verts = torch.where(occupied, counts[:, 0], 0).sum().to(torch.int32)
    running = torch.cumsum(occupied, 0, dtype=torch.int32)
    n_occ = running[-1]
    rank = torch.arange(1, max_cubes + 1, dtype=torch.int32, device=dev)
    cube_valid = rank <= n_occ
    cid = torch.where(cube_valid, torch.searchsorted(running, rank), 0)
    types = torch.where(cube_valid, cube_type[cid].to(torch.int32), 0)
    return cid, types, cube_valid, n_occ, n_verts


def _sweep(d, voxel_size, offset, cid, types, cube_valid):
    """Phase 3: per compacted cube, the vertex and the bracketing voxel
    pair of each of its 24 triangle slots, and which slots are live.
    Returns (vert (C, 24, 3) f32, vvox (C, 24, 2) i32, slot_valid (C, 24))."""
    dev = d.device
    Z, Y, X = d.shape
    cy, cx = Y - 1, X - 1
    max_cubes = cid.shape[0]
    cub_z = cid // (cy * cx)
    rem = cid - cub_z * (cy * cx)
    cub_y = rem // cx
    cub_x = rem - cub_y * cx
    flat_d = d.reshape(-1)
    vs = voxel_size

    ws, centres, lins = [], [], []
    for k in range(8):
        dx, dy, dz = (int(v) for v in CORNER_OFFSETS[k])
        vx, vy, vz = cub_x + dx, cub_y + dy, cub_z + dz
        lin = (vz * Y + vy) * X + vx
        ws.append(flat_d[lin])
        centres.append(
            torch.stack(
                [
                    vx.to(torch.float32) + 0.5,
                    vy.to(torch.float32) + 0.5,
                    vz.to(torch.float32) + 0.5,
                ],
                dim=-1,
            )
            * vs[None, :]
            + offset[None, :]
        )
        lins.append(lin)
    ws = torch.stack(ws, dim=-1)  # (max_cubes, 8)
    centres = torch.stack(centres, dim=-2)  # (max_cubes, 8, 3)
    lins = torch.stack(lins, dim=-1).to(torch.int32)  # (max_cubes, 8)

    # per-edge interpolated vertices (max_cubes, 12, 3)
    _, tri_table, e0, e1 = _device_tables(dev)
    w0, w1 = ws[:, e0], ws[:, e1]
    v0, v1 = centres[:, e0], centres[:, e1]
    denom = w1 - w0
    denom = torch.where(
        denom.abs() < 1e-20, torch.full_like(denom, 1e-20), denom
    )
    ratio = torch.clamp(-w0 / denom, 0.0, 1.0)[..., None]
    edge_verts = v0 + ratio * (v1 - v0)
    edge_vox = torch.stack([lins[:, e0], lins[:, e1]], dim=-1)  # (.., 12, 2)

    # triangulation: 24 slot edges per cube from the flattened table
    slot = torch.arange(_MAX_V, dtype=torch.int32, device=dev)
    tri_edges = _table_lookup(tri_table, types[:, None] * _MAX_V + slot)
    slot_valid = (tri_edges >= 0) & cube_valid[:, None]
    edge_idx = torch.clamp(tri_edges, min=0)

    # edge -> slot: the (x, y, z) and (voxel a, voxel b) words of each
    # slot's edge, read from the cube's interleaved per-edge rows
    ch3 = torch.arange(3, dtype=torch.int32, device=dev)
    ch2 = torch.arange(2, dtype=torch.int32, device=dev)
    vert = _slot_gather(
        edge_verts.reshape(max_cubes, 36),
        (edge_idx[:, :, None] * 3 + ch3).reshape(max_cubes, _MAX_V * 3),
    ).reshape(max_cubes, _MAX_V, 3)
    vvox = _slot_gather(
        edge_vox.reshape(max_cubes, 24),
        (edge_idx[:, :, None] * 2 + ch2).reshape(max_cubes, _MAX_V * 2),
    ).reshape(max_cubes, _MAX_V, 2)
    return vert, vvox, slot_valid


def _extract(
    d, voxel_size, offset, max_cubes, max_vertices, layout="dense"
) -> TriangleSoup:
    if layout not in ("dense", "masked"):
        raise ValueError(f"layout must be 'dense' or 'masked', got {layout!r}")
    dev = d.device
    cube_type, occupied = _classify(d)

    if layout == "masked":
        cid, types, cube_valid, n_occ, n_verts = _compact_on_device(
            cube_type, occupied, max_cubes
        )
        vert, vvox, slot_valid = _sweep(
            d, voxel_size, offset, cid, types, cube_valid
        )
        n_slots = max_cubes * _MAX_V
        return TriangleSoup(
            vertices=vert.reshape(n_slots, 3),
            vertex_voxels=vvox.reshape(n_slots, 2),
            n_vertices=torch.clamp(n_verts, max=n_slots),
            overflowed=n_occ > max_cubes,
            valid=slot_valid.reshape(n_slots),
        )

    cid, types, cube_valid, cube_offsets, n_occ, n_verts = (
        _compact_on_host_counts(cube_type, occupied, max_cubes)
    )
    vert, vvox, slot_valid = _sweep(d, voxel_size, offset, cid, types, cube_valid)

    # dense compaction: slot j of cube i goes to cube_offsets[i] + j
    slot = torch.arange(_MAX_V, dtype=torch.int64, device=dev)
    dest = cube_offsets[:, None] + slot[None, :]
    dest = torch.where(
        slot_valid & (dest < max_vertices), dest, max_vertices
    ).reshape(-1)
    vertices = torch.zeros((max_vertices + 1, 3), dtype=torch.float32,
                           device=dev)
    vertices[dest] = vert.reshape(-1, 3)
    vertex_voxels = torch.zeros((max_vertices + 1, 2), dtype=torch.int32,
                                device=dev)
    vertex_voxels[dest] = vvox.reshape(-1, 2)

    n_out = min(n_verts, max_vertices)
    return TriangleSoup(
        vertices=vertices[:max_vertices],
        vertex_voxels=vertex_voxels[:max_vertices],
        n_vertices=torch.tensor(n_out, dtype=torch.int32, device=dev),
        overflowed=torch.tensor(
            n_occ > max_cubes or n_verts > max_vertices, device=dev
        ),
        valid=torch.arange(max_vertices, device=dev) < n_out,
    )


def soup_to_numpy(soup: TriangleSoup):
    """Host side: (n, 3) f32 vertices and the (n/3, 3) triangle indices.

    Takes both layouts. A dense soup copies its live prefix off the
    device. A masked soup is compacted here with numpy, up to its last
    live slot: slot order is emission order, so triangles stay
    contiguous. An overflowed masked soup counts ``n_vertices`` over every
    occupied cube but holds ``max_cubes`` of them: the count is clamped to
    whole triangles of what was captured.
    """
    n = int(soup.n_vertices)
    cap = soup.vertices.shape[0]
    if n <= cap and bool(soup.valid[:n].all()):  # dense layout
        verts = soup.vertices[:n].detach().cpu().numpy()
    else:
        live = torch.nonzero(soup.valid).squeeze(1)
        verts = soup.vertices[live[:n]].detach().cpu().numpy()
    n = min(n, len(verts)) // 3 * 3
    verts = verts[:n]
    tris = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return verts, tris


def sample_color_at(vol: TSDFVolume, vertices) -> np.ndarray:
    """Trilinear sample of the fused colour volume at world points: the
    per-vertex colours of a mesh export.

    Voxel centres lie at offset + (i + 0.5) * voxel_size and coordinates
    clamp to the lattice, as in the TSDF interpolation. The eight taps are
    gathered as bytes on the volume's device (no float copy of the colour
    field) and summed in float32 in the order z, y, x.

    Args:
      vol: volume with ``color`` (Z, Y, X, 3) u8 (see ``with_color()``).
      vertices: (N, 3) world-mm points (x, y, z), numpy or tensor.

    Returns:
      (N, 3) u8 RGB, numpy.
    """
    if vol.color is None:
        raise ValueError(
            "volume has no colour field; fuse with rgb / with_color()"
        )
    dev = vol.device
    verts = torch.as_tensor(
        np.asarray(vertices, dtype=np.float32), device=dev
    ).reshape(-1, 3)
    sz, sy, sx = vol.tsdf.shape
    cf = (verts - vol.offset[None, :]) / vol.voxel_size[None, :] - 0.5
    i0 = torch.floor(cf)
    # the weights are formed in float64 and rounded once, as the JAX
    # package's numpy version does (float32 minus int64 promotes)
    frac = (cf - i0).to(torch.float64)
    i0 = i0.to(torch.int64)
    top = torch.tensor([sx - 1, sy - 1, sz - 1], dtype=torch.int64, device=dev)
    zero = torch.zeros_like(top)
    lo = torch.minimum(torch.maximum(i0, zero), top)
    hi = torch.minimum(torch.maximum(i0 + 1, zero), top)

    out = torch.zeros((len(verts), 3), dtype=torch.float32, device=dev)
    for dz in (0, 1):
        zi = (hi if dz else lo)[:, 2]
        wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
        for dy in (0, 1):
            yi = (hi if dy else lo)[:, 1]
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            for dx in (0, 1):
                xi = (hi if dx else lo)[:, 0]
                wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
                w = (wz * wy * wx).to(torch.float32)
                out += w[:, None] * vol.color[zi, yi, xi].to(torch.float32)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).cpu().numpy()
