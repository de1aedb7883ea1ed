"""Plain reference of TSDF fusion: the volume grid and the exact
integrate, rigid or at deformed centres.

Written from the contract of the reference implementation's integrate
(KinectFusion's projective running mean): per voxel, the camera point
X = R c + t, the pixel round((K X) / Z) (half to even), the gate (inside
the image, Z > 0, depth > 0, sdf >= -trunc), the running mean
d' = (d w + min(sdf, trunc)) / (w + 1), w' = w + 1. Each product and sum
is its own elementwise float32 operation, in the order written, so that
on the card its rounding is that of any faithful implementation.

Imports nothing but torch: it takes no part of the program under test.
"""

from __future__ import annotations

import dataclasses

import torch

_F32 = torch.float32
# planes of the volume a block of the integrate works on
BLOCK_PLANES = 32


@dataclasses.dataclass
class Grid:
    """A dense volume: tsdf and weight (Z, Y, X) float32, its geometry."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    voxel_size: torch.Tensor  # (3,) x, y, z
    offset: torch.Tensor  # (3,) x, y, z
    trunc: torch.Tensor  # ()
    physical: torch.Tensor  # (3,) mm extent
    deform: torch.Tensor | None = None  # (Z, Y, X, 3) deformed centres

    @property
    def shape(self):
        return tuple(self.tsdf.shape)

    def axis_centres(self, z0: int = 0, z1: int | None = None):
        """(z, y, x) centre vectors: (index + 0.5) * voxel size + offset."""
        sz, sy, sx = self.shape
        z1 = sz if z1 is None else z1
        dev = self.tsdf.device
        vs = self.voxel_size
        cz = (torch.arange(z0, z1, dtype=_F32, device=dev) + 0.5) * vs[2]
        cy = (torch.arange(sy, dtype=_F32, device=dev) + 0.5) * vs[1]
        cx = (torch.arange(sx, dtype=_F32, device=dev) + 0.5) * vs[0]
        return cz + self.offset[2], cy + self.offset[1], cx + self.offset[0]

    def voxel_centres(self) -> torch.Tensor:
        cz, cy, cx = self.axis_centres()
        sz, sy, sx = self.shape
        return torch.stack([cx[None, None, :].expand(sz, sy, sx),
                            cy[None, :, None].expand(sz, sy, sx),
                            cz[:, None, None].expand(sz, sy, sx)], dim=-1)


def make_grid(size: int, physical_mm: float, offset_mm=None, *, device,
              deformation: bool = False) -> Grid:
    """A cleared cube grid: tsdf = trunc, weight 0; truncation
    1.1 * |physical / size|; the offset centres x and y and starts z at 0
    by default.

    The voxel size that places the centres is the extent divided by the
    voxel count as a number, as torch divides a tensor by a number on the
    grid's device: on a card that is a product with the rounded
    reciprocal, so 2550 mm over 255 voxels is 10 mm plus an ulp there and
    10 mm exactly on the CPU. The truncation divides tensor by tensor."""
    ps = torch.full((3,), float(physical_mm), dtype=_F32, device=device)
    if offset_mm is None:
        off = torch.stack([-ps[0] / 2.0, -ps[1] / 2.0, torch.zeros_like(ps[0])])
    else:
        off = torch.tensor(offset_mm, dtype=_F32, device=device)
    exact = ps / torch.tensor([size] * 3, dtype=_F32, device=device)
    vv = exact * exact
    trunc = 1.1 * torch.sqrt(vv[0] + vv[1] + vv[2])
    vs = torch.stack([ps[a] / size for a in range(3)])
    grid = Grid(tsdf=trunc.expand(size, size, size).clone(),
                weight=torch.zeros((size,) * 3, dtype=_F32, device=device),
                voxel_size=vs, offset=off, trunc=trunc, physical=ps)
    if deformation:
        grid.deform = grid.voxel_centres().contiguous()
    return grid


def intrinsics(cam: dict, device) -> torch.Tensor:
    return torch.tensor([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                         [0.0, 0.0, 1.0]], dtype=_F32, device=device)


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """The 4x4 LU inverse of a float32 pose."""
    return torch.linalg.inv_ex(pose).inverse


def project(cx, cy, cz, pose_inv, k, h: int, w: int):
    """Camera point (three tensors), linear pixel index (0 outside the
    image) and the in-image mask of world points (cx, cy, cz)."""
    pi = pose_inv
    cam = [pi[i, 0] * cx + pi[i, 1] * cy + pi[i, 2] * cz + pi[i, 3]
           for i in range(3)]
    z = cam[2]
    px = torch.round((k[0, 0] * cam[0] + k[0, 2] * z) / z)
    py = torch.round((k[1, 1] * cam[1] + k[1, 2] * z) / z)
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    lin = torch.where(inside, py * w + px, 0.0).to(torch.int64)
    return cam, lin, inside


def observe(grid: Grid, depth: torch.Tensor, pose_inv, k, z0: int, z1: int):
    """The frame's observation of planes z0..z1: (update gate, clamped
    sdf, camera z), each (z1 - z0, Y, X)."""
    h, w = depth.shape
    if grid.deform is None:
        cz, cy, cx = grid.axis_centres(z0, z1)
        cx, cy, cz = cx[None, None, :], cy[None, :, None], cz[:, None, None]
    else:
        cx, cy, cz = grid.deform[z0:z1].unbind(-1)
    cam, lin, inside = project(cx, cy, cz, pose_inv, k, h, w)
    z = cam[2]
    surface = depth.to(_F32).reshape(-1)[lin]
    sdf = surface - z
    update = inside & (z > 0) & (surface > 0) & (sdf >= -grid.trunc)
    return update, torch.minimum(sdf, grid.trunc), z


def integrate(grid: Grid, depth: torch.Tensor, pose_inv, k) -> None:
    """Fuse one frame into ``grid`` in place, a block of planes at a
    time."""
    sz = grid.shape[0]
    for z0 in range(0, sz, BLOCK_PLANES):
        z1 = min(sz, z0 + BLOCK_PLANES)
        update, obs, _z = observe(grid, depth, pose_inv, k, z0, z1)
        d = grid.tsdf[z0:z1]
        wt = grid.weight[z0:z1]
        new_w = wt + 1.0
        new_d = (d * wt + obs) / new_w
        grid.tsdf[z0:z1] = torch.where(update, new_d, d)
        grid.weight[z0:z1] = torch.where(update, new_w, wt)


def volume_gaps(tsdf, weight, ref_tsdf, ref_weight, block: int = BLOCK_PLANES):
    """(voxels whose weight differs, the largest |tsdf gap| in mm over the
    voxels the reference updated), compared in float32 a block at a
    time; tsdf and weight may be stored in a lower precision."""
    mismatch, gap = 0, 0.0
    for z0 in range(0, ref_tsdf.shape[0], block):
        z1 = min(ref_tsdf.shape[0], z0 + block)
        w = weight[z0:z1].to(_F32)
        rw = ref_weight[z0:z1].to(_F32)
        mismatch += int((w != rw).sum())
        seen = rw > 0
        diff = (tsdf[z0:z1].to(_F32) - ref_tsdf[z0:z1].to(_F32)).abs()
        diff = torch.where(seen, diff, 0.0)
        # a NaN in the program's volume is the largest gap there is
        diff = torch.where(torch.isnan(diff), float("inf"), diff)
        gap = max(gap, float(diff.max()))
    return mismatch, gap
