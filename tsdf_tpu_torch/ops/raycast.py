"""Sphere-traced raycasting of the TSDF volume, in plain PyTorch.

Port of ``tsdf_tpu/ops/raycast.py``. All rays march together, one
iteration per loop pass, each sampling the volume for every ray with the
8-tap trilinear stencil; inactive rays keep their state. This is the
plain twin of the CUDA kernel in ``kernels/raycast.py``, which marches
one ray per thread with the same expressions in the same order.

Stepping modes:
  * ``"sphere"`` (default): step = clip(0.75 * tsdf, 0.05 * trunc,
    0.9 * trunc);
  * ``"fixed"``: the reference's constant step 0.05 * trunc.

Termination: stop on a + -> - crossing (hit, secant-refined), on a
non-positive first sample (hit at entry), on - -> + (backface miss), on
leaving the volume, or after ``max_steps`` samples.
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..volume import TSDFVolume
from .trilinear import trilinear_sample

REFERENCE_MAX_STEPS = 4400

_MARCHING, _HIT, _MISS = 0, 1, 2

# loop passes between host checks for "all rays finished"; passes after
# the last ray stops change nothing
_CHECK_EVERY = 16


def _mat3_rows(m, v0, v1, v2):
    """[m[i,0]*v0 + m[i,1]*v1 + m[i,2]*v2 for each row i], elementwise
    in that order (the kernels evaluate the same sums)."""
    return [m[i, 0] * v0 + m[i, 1] * v1 + m[i, 2] * v2 for i in range(3)]


def ray_directions(
    camera: Camera, width: int, height: int, row0: int = 0
) -> torch.Tensor:
    """(H, W, 3) unit world-space ray directions: normalize(R K^-1 p),
    for the image rows row0 .. row0 + H - 1."""
    dev = camera.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(row0, row0 + height, dtype=torch.float32,
                      device=dev)[:, None]
    xs, ys = xs.expand(height, width), ys.expand(height, width)
    ki = camera.k_inv
    d_cam = [ki[i, 0] * xs + ki[i, 1] * ys + ki[i, 2] for i in range(3)]
    d = _mat3_rows(camera.rotation, *d_cam)
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return torch.stack([c / norm for c in d], dim=-1)


def slab_near_far(origin, dirs, space_min, space_max):
    """Per-ray entry/exit t of the volume's bounding box.

    Returns (near, far, intersects) with near clamped to >= 0 (an origin
    inside the box enters at t = 0).
    """
    safe = torch.where(dirs == 0.0, torch.full_like(dirs, 1e-20), dirs)
    t1 = (space_min - origin) / safe
    t2 = (space_max - origin) / safe
    # rays parallel to an axis and outside its slab never hit
    inside = (origin >= space_min) & (origin <= space_max)
    par_miss = ((dirs == 0.0) & ~inside).any(dim=-1)
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1)
    intersects = (near <= far) & (far >= 0.0) & ~par_miss
    return torch.clamp(near, min=0.0), far, intersects


def march_rays(
    vol: TSDFVolume,
    origin: torch.Tensor,
    dirs: torch.Tensor,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> torch.Tensor:
    """March a flat batch of rays: origin (3,), dirs (N, 3) unit.

    Returns (N, 3) world-space hit vertices, NaN on a miss.
    """
    space_min = vol.space_min
    trunc = vol.truncation_distance
    voxel_size = vol.voxel_size

    near, far, intersects = slab_near_far(
        origin[None, :], dirs, space_min[None, :], vol.space_max[None, :]
    )
    start = origin[None, :] + near[:, None] * dirs - space_min[None, :]
    max_t = far - near

    fixed_step = trunc * 0.05
    if mode == "fixed":
        min_step = max_step = fixed_step
    elif mode == "sphere":
        min_step = fixed_step
        max_step = trunc * 0.9
    else:
        raise ValueError(f"unknown raycast mode: {mode}")

    zeros = torch.zeros_like(dirs[:, 0])
    t = zeros
    hit_t = zeros
    prev_tsdf = zeros + trunc
    prev_step = zeros + fixed_step
    status = torch.where(
        intersects,
        torch.full_like(zeros, _MARCHING, dtype=torch.int32),
        torch.full_like(zeros, _MISS, dtype=torch.int32),
    )

    count = 0
    while count < max_steps and bool((status == _MARCHING).any()):
        for _ in range(min(_CHECK_EVERY, max_steps - count)):
            active = status == _MARCHING
            pts = start + t[:, None] * dirs
            tsdf = trilinear_sample(vol.tsdf, pts, voxel_size)

            # hit: sample <= 0; secant-refined when strictly negative
            frac = prev_tsdf / (prev_tsdf - tsdf)
            t_refined = t - prev_step + frac * prev_step
            hit = active & (tsdf <= 0.0)
            new_hit_t = torch.where(tsdf < 0.0, t_refined, t)

            # backface: previous sample negative, this one positive
            backface = active & (tsdf > 0.0) & (prev_tsdf < 0.0)

            if mode == "fixed":
                step = torch.zeros_like(tsdf) + fixed_step
            else:
                step = torch.clamp(step_scale * tsdf, min_step, max_step)

            new_t = t + step
            escaped = active & ~hit & ~backface & (new_t >= max_t)

            status = torch.where(hit, _HIT, status)
            status = torch.where(backface | escaped, _MISS, status)
            t = torch.where(active & ~hit, new_t, t)
            hit_t = torch.where(hit, new_hit_t, hit_t)
            prev_tsdf = torch.where(active, tsdf, prev_tsdf)
            prev_step = torch.where(active, step, prev_step)
            count += 1

    verts = start + hit_t[:, None] * dirs + space_min[None, :]
    return torch.where(
        (status == _HIT)[:, None], verts, torch.full_like(verts, float("nan"))
    )


def compute_normals_from_vertices(verts: torch.Tensor) -> torch.Tensor:
    """Screen-space normals: normalize((below - self) x (right - self));
    zero on the last row/column and where the stencil touches a miss."""
    v = verts
    r = torch.roll(v, -1, dims=1) - v
    b = torch.roll(v, -1, dims=0) - v
    n = torch.stack(
        [
            b[..., 1] * r[..., 2] - b[..., 2] * r[..., 1],
            b[..., 2] * r[..., 0] - b[..., 0] * r[..., 2],
            b[..., 0] * r[..., 1] - b[..., 1] * r[..., 0],
        ],
        dim=-1,
    )
    norm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    n = n / torch.where(norm == 0.0, torch.ones_like(norm), norm)
    valid = torch.isfinite(n).all(dim=-1, keepdim=True)
    n = torch.where(valid, n, torch.zeros_like(n))
    n[-1, :, :] = 0.0
    n[:, -1, :] = 0.0
    return n


def raycast_vertices(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
    row0: int = 0,
) -> torch.Tensor:
    """(H, W, 3) world-space surface points in mm seen from ``camera``;
    NaN on a miss. With ``row0`` the H rows are the image's rows from
    row0 (each ray marches alone, so a tile's rows equal the whole
    render's)."""
    dirs = ray_directions(camera, width, height, row0).reshape(-1, 3)
    return march_rays(
        vol, camera.position, dirs,
        mode=mode, max_steps=max_steps, step_scale=step_scale,
    ).reshape(height, width, 3)


def raycast(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raycast the volume from ``camera``.

    Returns:
      vertices: (H, W, 3) world-space surface points in mm; NaN on miss.
      normals: (H, W, 3) unit screen-space normals (zero on the last
        row/column and on misses).
    """
    verts = raycast_vertices(
        vol, camera, width, height,
        mode=mode, max_steps=max_steps, step_scale=step_scale,
    )
    return verts, compute_normals_from_vertices(verts)


def render_to_depth_image(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    **kwargs,
) -> torch.Tensor:
    """Raycast and return a (H, W) u16 depth image in mm (camera z)."""
    verts, _ = raycast(vol, camera, width, height, **kwargs)
    return vertices_to_depth_image(verts, camera)


def vertices_to_depth_image(verts: torch.Tensor, camera: Camera) -> torch.Tensor:
    """(H, W) u16 camera-space z in mm of (H, W, 3) raycast vertices, 0 on
    a miss: the homogeneous transform, rounded and clamped to u16."""
    h, w, _ = verts.shape
    z = camera.world_to_camera(verts.reshape(-1, 3))[:, 2].reshape(h, w)
    z = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    return torch.clamp(torch.round(z), 0, 65535).to(torch.uint16)


def vertices_to_camera_depth(
    verts: torch.Tensor, pose_inv: torch.Tensor
) -> torch.Tensor:
    """(H, W) float32 camera-space z of raycast vertices, 0 on a miss: the
    model depth the tracker aligns against. Row 2 of ``pose_inv`` applied
    elementwise, with no homogeneous divide and no rounding to u16
    (``render_to_depth_image`` does both)."""
    finite = torch.isfinite(verts)
    w = torch.where(finite, verts, torch.zeros_like(verts))
    pi = pose_inv
    camz = (
        pi[2, 0] * w[..., 0] + pi[2, 1] * w[..., 1] + pi[2, 2] * w[..., 2]
        + pi[2, 3]
    )
    return torch.where(finite.all(dim=-1), camz, torch.zeros_like(camz))
