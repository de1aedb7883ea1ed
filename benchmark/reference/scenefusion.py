"""Plain reference of one SceneFusion frame (Scoobadood/TSDF
SceneFusion.cpp:84-185, SceneFusion_krnl.cu:74-401): the surface's
marching-cubes vertices with their two bracketing voxels; each vertex
projected into the depth frame and accepted where the frame's depth agrees
with its camera depth within the threshold; every voxel's deformed centre
moved by the flow of its corresponding vertices over the count of all its
vertices; the frame fused at the deformed centres.

The update's sums are made with ``index_put_(accumulate=True)``, whose
sums run in an order that does not change between runs, over the
vertices in cube order and triangle-slot order; the program's reference
adds racily, so the order is a choice, and the deterministic one is the
one a faithful implementation can be held to.

Imports nothing but torch and numpy: it takes no part of the program.
"""

from __future__ import annotations

import torch

from . import fusion
from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, MAX_TRIS, TRI_TABLE

_F32 = torch.float32
_SLOTS = MAX_TRIS * 3


def surface(tsdf: torch.Tensor, grid: fusion.Grid, max_cubes: int):
    """The first ``max_cubes`` occupied cubes in cube-id order, and for
    each of their 24 triangle slots: the vertex (C*24, 3), its two voxels
    (C*24, 2) int64, whether the slot is live (C*24,); and whether the
    occupied cubes overflowed ``max_cubes``."""
    dev = tsdf.device
    d = tsdf.to(_F32)
    Z, Y, X = d.shape
    cz, cy, cx = Z - 1, Y - 1, X - 1
    inside = (d < 0.0).to(torch.int32)
    ctype = torch.zeros((cz, cy, cx), dtype=torch.int32, device=dev)
    for k in range(8):
        ox, oy, oz = (int(v) for v in CORNER_OFFSETS[k])
        ctype += inside[oz:oz + cz, oy:oy + cy, ox:ox + cx] << k
    ctype = ctype.reshape(-1)
    occupied = (ctype != 0) & (ctype != 255)
    ids = torch.nonzero(occupied).squeeze(1)
    overflow = ids.numel() > max_cubes
    ids = ids[:max_cubes]
    n = ids.numel()
    cid = torch.zeros(max_cubes, dtype=torch.int64, device=dev)
    cid[:n] = ids
    live_cube = torch.arange(max_cubes, device=dev) < n
    types = torch.where(live_cube, ctype[cid], 0)

    bz = cid // (cy * cx)
    rem = cid - bz * (cy * cx)
    by = rem // cx
    bx = rem - by * cx
    flat = d.reshape(-1)
    vs, off = grid.voxel_size, grid.offset
    values, centres, lins = [], [], []
    for k in range(8):
        ox, oy, oz = (int(v) for v in CORNER_OFFSETS[k])
        vx, vy, vz = bx + ox, by + oy, bz + oz
        lin = (vz * Y + vy) * X + vx
        values.append(flat[lin])
        centres.append(torch.stack([vx.to(_F32) + 0.5, vy.to(_F32) + 0.5,
                                    vz.to(_F32) + 0.5], dim=-1) * vs[None, :]
                       + off[None, :])
        lins.append(lin)
    values = torch.stack(values, dim=-1)
    centres = torch.stack(centres, dim=-2)
    lins = torch.stack(lins, dim=-1)
    e0 = torch.as_tensor(EDGE_CORNERS[:, 0], dtype=torch.int64, device=dev)
    e1 = torch.as_tensor(EDGE_CORNERS[:, 1], dtype=torch.int64, device=dev)
    w0, w1 = values[:, e0], values[:, e1]
    denom = w1 - w0
    denom = torch.where(denom.abs() < 1e-20, torch.full_like(denom, 1e-20), denom)
    ratio = torch.clamp(-w0 / denom, 0.0, 1.0)[..., None]
    v0, v1 = centres[:, e0], centres[:, e1]
    edge_vert = v0 + ratio * (v1 - v0)  # (C, 12, 3)
    edge_vox = torch.stack([lins[:, e0], lins[:, e1]], dim=-1)  # (C, 12, 2)

    table = torch.as_tensor(TRI_TABLE.reshape(-1), dtype=torch.int64, device=dev)
    slot = torch.arange(_SLOTS, device=dev)
    edges = table[types[:, None].to(torch.int64) * _SLOTS + slot[None, :]]
    live = (edges >= 0) & live_cube[:, None]
    edges = torch.clamp(edges, min=0)
    vert = torch.gather(edge_vert, 1, edges[..., None].expand(-1, -1, 3))
    vox = torch.gather(edge_vox, 1, edges[..., None].expand(-1, -1, 2))
    return (vert.reshape(-1, 3), vox.reshape(-1, 2), live.reshape(-1),
            overflow)


def world_to_pixel(points, pose_inv, k):
    """Camera points and rounded pixels of world points (N, 3)."""
    r = points @ pose_inv[0:3, 0:3].T + pose_inv[0:3, 3]
    w = points @ pose_inv[3, 0:3] + pose_inv[3, 3]
    cam = r / w[..., None]
    img = cam @ k.T
    return cam, torch.round(img[:, 0:2] / img[:, 2:3])


def frame(grid: fusion.Grid, depth, flow, pose_inv, k, max_cubes: int,
          threshold_mm: float):
    """One frame after the first, in place on ``grid`` (tsdf, weight,
    deform). Returns (corresponding vertices, overflowed)."""
    depth = depth.to(_F32)
    h, w = depth.shape
    vert, vox, live, overflow = surface(grid.tsdf, grid, max_cubes)
    cam, pix = world_to_pixel(vert, pose_inv, k)
    px, py = pix[:, 0], pix[:, 1]
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h) & live
    lin = (torch.where(inside, py, 0.0).to(torch.int64) * w
           + torch.where(inside, px, 0.0).to(torch.int64))
    d = depth.reshape(-1)[lin]
    f = flow.to(_F32).reshape(-1, 3)[lin]
    z = cam[:, 2]
    corr = inside & (d > 0) & (z > 0) & ((d - z).abs() < threshold_mm)
    payload = torch.cat([live.to(_F32)[:, None],
                         torch.where(corr[:, None], f, 0.0)], dim=-1)
    n_vox = grid.tsdf.numel()
    spread = torch.arange(live.shape[0], device=live.device) % n_vox
    acc = torch.zeros((n_vox, 4), dtype=_F32, device=depth.device)
    for side in (0, 1):
        idx = torch.where(live, vox[:, side], spread)
        acc.index_put_((idx,), payload, accumulate=True)
    delta = acc[:, 1:4] / torch.clamp(acc[:, 0:1], min=1.0)
    grid.deform = grid.deform + delta.reshape(grid.deform.shape)
    fusion.integrate(grid, depth, pose_inv, k)
    return int(corr.sum()), overflow
