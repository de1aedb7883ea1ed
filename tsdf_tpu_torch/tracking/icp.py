"""Projective point-to-plane ICP in plain PyTorch.

Port of ``tsdf_tpu/tracking/icp.py`` (itself a re-design of Whelan's
ICP_CUDA odometry). The per-pixel residual rows are dense (H, W) planes
and the normal equations are masked float32 sums. On CUDA tensors the
banded association's model lookup goes through the lane-gather kernel
(``kernels/gather.py``), one launch per Gauss-Newton iteration; the rest
is elementwise PyTorch.

Conventions (the JAX package's, so trajectories compare):
  * depth pyramid: 3 levels, 5-tap binomial weights {0.375, 0.25,
    0.0625} with a 3*sigma_color depth-similarity gate, sigma_color = 30;
  * vertex map: z * K^-1 (u, v, 1) in mm, invalid (z == 0 or >= cutoff)
    = NaN on purpose: every mask below is a ``where``, never a multiply;
  * normal map: normalize(cross(v(x+1,y) - v, v(x,y+1) - v));
  * residual row: [n_prev | (v_curr_in_prev x n_prev)] . xi =
    n_prev . (v_prev - v_curr_in_prev); gates: projected pixel in image,
    |cross(n_curr_in_prev, n_prev)| < sin(20 deg),
    |v_prev - v_curr_in_prev| < 100 mm;
  * update: T_prev_curr <- exp((v, w)) * T_prev_curr, tangent ordered
    translation-first like Sophus;
  * schedule: coarse-to-fine {10, 5, 4} iterations;
  * lastError = sqrt(sum r^2 / inliers) in mm, lastInliers.

Host syncs: with ``conv_eps == 0`` nothing here reads a value back from
the device (``solve_ex`` skips the host-side status check of ``solve``).
With ``conv_eps > 0`` each executed iteration reads its update magnitude
to decide whether the level stops: one sync per iteration, which buys
the skipped iterations.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..kernels.gather import lookup_flat
from ..utils.se3 import matmul_small, se3_exp

DIST_THRESH_MM = 100.0
ANGLE_THRESH = math.sin(20.0 * math.pi / 180.0)
SIGMA_COLOR = 30.0
DEPTH_CUTOFF_MM = 20000.0

_F32 = torch.float32
_BINOMIAL = (0.0625, 0.25, 0.375, 0.25, 0.0625)


class ICPResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) T_prev_curr
    error: torch.Tensor  # () rms point-to-plane residual, mm
    inliers: torch.Tensor  # () inlier count at the final iteration


def pyr_down(depth: torch.Tensor) -> torch.Tensor:
    """One pyramid level: the gated 5x5 binomial window around each even
    pixel, ``floor(num / den)``. Taps outside the image or further than
    3*sigma_color from the centre depth are skipped."""
    d = depth.to(_F32)
    h, w = d.shape
    ch, cw = h // 2, w // 2
    centre = d[0 : 2 * ch : 2, 0 : 2 * cw : 2]
    # NaN outside the image: such a tap fails the similarity gate like
    # any other non-finite depth, so the window clips at the border
    dpad = torch.nn.functional.pad(d, (2, 2, 2, 2), value=float("nan"))
    zero = torch.zeros_like(centre)
    num = zero
    den = zero
    for dy in range(5):
        for dx in range(5):
            wgt = _BINOMIAL[dy] * _BINOMIAL[dx]
            val = dpad[dy : dy + 2 * ch : 2, dx : dx + 2 * cw : 2]
            ok = (val - centre).abs() < 3.0 * SIGMA_COLOR
            num = num + torch.where(ok, val * wgt, zero)
            den = den + ok * wgt
    return torch.floor(num / torch.clamp(den, min=1e-12))


def depth_pyramid(depth: torch.Tensor, levels: int = 3) -> list[torch.Tensor]:
    """[level0 (full res), level1, ...] f32 mm."""
    pyr = [depth.to(_F32)]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def level_intrinsics(fx, fy, cx, cy, level: int):
    """Intrinsics of a pyramid level: scaled by 1 / 2^level."""
    s = 1.0 / (1 << level)
    return fx * s, fy * s, cx * s, cy * s


def vertex_map_planes(depth, fx, fy, cx, cy, cutoff: float = DEPTH_CUTOFF_MM):
    """Camera-space vertices as three (H, W) planes; NaN where invalid."""
    d = depth.to(_F32)
    h, w = d.shape
    us = torch.arange(w, dtype=_F32, device=d.device)[None, :]
    vs = torch.arange(h, dtype=_F32, device=d.device)[:, None]
    bad = ~((d > 0) & (d < cutoff))
    nan = torch.full_like(d, float("nan"))
    vx = torch.where(bad, nan, d * (us - cx) / fx)
    vy = torch.where(bad, nan, d * (vs - cy) / fy)
    vz = torch.where(bad, nan, d)
    return vx, vy, vz


def normal_map_planes(vx, vy, vz):
    """Screen-space normals normalize(cross(v(x+1) - v, v(y+1) - v)) as
    three (H, W) planes; NaN where undefined (the last row and column, and
    wherever the stencil touches an invalid vertex)."""
    pad = torch.nn.functional.pad

    def shift_x(p):
        return pad(p[:, 1:], (0, 1))

    def shift_y(p):
        return pad(p[1:, :], (0, 0, 0, 1))

    rx = shift_x(vx) - vx
    ry = shift_x(vy) - vy
    rz = shift_x(vz) - vz
    dx = shift_y(vx) - vx
    dy = shift_y(vy) - vy
    dz = shift_y(vz) - vz
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    edge = torch.zeros_like(vx, dtype=torch.bool)
    edge[-1, :] = True
    edge[:, -1] = True
    nan = torch.full_like(vx, float("nan"))
    return tuple(torch.where(edge, nan, c / norm) for c in (nx, ny, nz))


# -- normal equations ---------------------------------------------------


def _pairs():
    """The 29 products of the reduction over the eight planes
    [r0..r5, r, m]: the upper triangle of A (21), b (6), sum r^2, and the
    inlier count."""
    tri = [(i, j) for i in range(6) for j in range(i, 6)]
    return tri + [(i, 6) for i in range(6)] + [(6, 6), (7, 7)]


@functools.lru_cache(maxsize=None)
def _pair_index(device: torch.device):
    """Index tensors of the reduction, uploaded once per device so that
    the Gauss-Newton loop copies nothing from the host."""
    pairs = _pairs()
    slot = {p: k for k, p in enumerate(pairs)}
    a_idx = [[slot[(min(i, j), max(i, j))] for j in range(6)] for i in range(6)]
    b_idx = [slot[(i, 6)] for i in range(6)]

    def t(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return t([p[0] for p in pairs]), t([p[1] for p in pairs]), t(a_idx), t(b_idx)


def _normal_equations(planes: torch.Tensor):
    """(8, N) planes [r0..r5, r, m] -> (A (6, 6), b (6,), sum r^2,
    inliers), as elementwise products and float32 sums: true float32 on a
    card whatever the process-wide TF32 switch says."""
    iu, ju, a_idx, b_idx = _pair_index(planes.device)
    sums = (planes.index_select(0, iu) * planes.index_select(0, ju)).sum(dim=1)
    return sums[a_idx], sums[b_idx], sums[27], sums[28]


def _masked(mask, p):
    """p where the mask holds and p is finite, else 0."""
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.nan_to_num(p, nan=0.0, posinf=0.0, neginf=0.0)


def _project(vix, viy, viz, fx, fy, cx, cy):
    """Rounded pixel of a camera-space point; a non-finite projection
    lands at -1 (outside every image)."""
    pxf = vix * fx / viz + cx
    pyf = viy * fy / viz + cy
    minus = torch.full_like(pxf, -1.0)
    pxf = torch.where(torch.isfinite(pxf), pxf, minus)
    pyf = torch.where(torch.isfinite(pyf), pyf, minus)
    px = torch.round(torch.clamp(pxf, -1e6, 1e6)).to(torch.int32)
    py = torch.round(torch.clamp(pyf, -1e6, 1e6)).to(torch.int32)
    return px, py


def _rotate(rot, x, y, z):
    return [rot[i, 0] * x + rot[i, 1] * y + rot[i, 2] * z for i in range(3)]


def icp_step(
    rot: torch.Tensor,  # (3, 3) R_prev_curr
    trans: torch.Tensor,  # (3,) t_prev_curr, mm
    vc_planes,  # 3x (H, W): current vertex map planes
    nc_planes,  # 3x (H, W): current normal map planes
    vp_planes,  # 3x (H, W): model vertex map planes
    np_planes,  # 3x (H, W): model normal map planes
    fx, fy, cx, cy,
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
):
    """One Gauss-Newton step's normal equations with the exact
    association, on (H, W) component planes: each current vertex looks
    up the model maps at its projected pixel.

    Returns (A (6, 6), b (6,), residual_sq_sum, inlier_count). Image
    bounds and the lookup use the model planes' dims. The rotation is
    applied elementwise in float32.
    """
    h, w = vp_planes[0].shape
    vcx, vcy, vcz = (p.reshape(-1) for p in vc_planes)
    ncx, ncy, ncz = (p.reshape(-1) for p in nc_planes)

    vix, viy, viz = _rotate(rot, vcx, vcy, vcz)
    vix, viy, viz = vix + trans[0], viy + trans[1], viz + trans[2]
    nix, niy, niz = _rotate(rot, ncx, ncy, ncz)

    px, py = _project(vix, viy, viz, fx, fy, cx, cy)
    in_img = (
        (px >= 0) & (px < w) & (py >= 0) & (py < h) & (vcz > 0) & (viz > 0)
    )
    lin = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).to(torch.int64)
    vpx, vpy, vpz = (p.reshape(-1).index_select(0, lin) for p in vp_planes)
    npx, npy, npz = (p.reshape(-1).index_select(0, lin) for p in np_planes)

    dx, dy, dz = vpx - vix, vpy - viy, vpz - viz
    dist_ok = torch.sqrt(dx * dx + dy * dy + dz * dz) < dist_thresh
    gx = niy * npz - niz * npy
    gy = niz * npx - nix * npz
    gz = nix * npy - niy * npx
    angle_ok = torch.sqrt(gx * gx + gy * gy + gz * gz) < angle_thresh
    finite = (
        torch.isfinite(vcz) & torch.isfinite(ncx)
        & torch.isfinite(vpz) & torch.isfinite(npx)
    )
    mask = in_img & dist_ok & angle_ok & finite

    zero = torch.zeros_like(vix)
    nsx, nsy, nsz = (torch.where(mask, c, zero) for c in (npx, npy, npz))
    vsx, vsy, vsz = (torch.where(mask, c, zero) for c in (vix, viy, viz))
    planes = torch.stack(
        [
            _masked(mask, nsx),
            _masked(mask, nsy),
            _masked(mask, nsz),
            _masked(mask, vsy * nsz - vsz * nsy),
            _masked(mask, vsz * nsx - vsx * nsz),
            _masked(mask, vsx * nsy - vsy * nsx),
            _masked(mask, npx * dx + npy * dy + npz * dz),
            mask.to(_F32),
        ]
    )
    return _normal_equations(planes)


def icp_step_banded_planes(
    rot, trans,
    vc_planes,  # 3x (H, W): current vertex map planes
    nc_planes,  # 3x (H, W): current normal map planes
    depth_prev: torch.Tensor,
    fx, fy, cx, cy,
    band: int = 32,
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
    cutoff: float = DEPTH_CUTOFF_MM,
):
    """One Gauss-Newton step's normal equations with the banded
    association, on (H, W) component planes.

    Only the model *depth* image is looked up: d00, d10, d01 =
    depth_prev[py, px], [py, px + 1], [py + 1, px] where the projected
    pixel lies in the image (with a margin of one for the normal stencil)
    and within ``band`` rows of the current pixel, else 0; the model
    vertex and normal are rebuilt from those depths with the
    vertex and normal map formulas. Correspondences displaced vertically
    by more than ``band`` rows are dropped (large-motion outliers that the
    pyramid's coarse levels absorb first). The three lookups are one call
    of the lane-gather wrapper over the flattened image.
    """
    dp = depth_prev.to(_F32).contiguous()
    h, w = dp.shape
    vcx, vcy, vcz = vc_planes
    ncx, ncy, ncz = nc_planes
    hc, _wc = vcx.shape

    vix, viy, viz = _rotate(rot, vcx, vcy, vcz)
    vix, viy, viz = vix + trans[0], viy + trans[1], viz + trans[2]
    nix, niy, niz = _rotate(rot, ncx, ncy, ncz)

    px, py = _project(vix, viy, viz, fx, fy, cx, cy)
    # (px + 1, py + 1) must exist for the normal stencil
    in_img = (px >= 0) & (px < w - 1) & (py >= 0) & (py < h - 1)
    yy = torch.arange(hc, dtype=torch.int32, device=dp.device)[:, None]
    found = in_img & ((py - yy).abs() <= band)

    lin = torch.where(found, py * w + px, torch.full_like(px, -1))
    taps = lookup_flat(dp, torch.cat([lin, lin + 1, lin + w], dim=1))
    zero = torch.zeros_like(vix)
    d00, d10, d01 = (torch.where(found, t, zero) for t in taps.chunk(3, dim=1))

    pxf = px.to(_F32)
    pyf = py.to(_F32)
    v00x = d00 * (pxf - cx) / fx
    v00y = d00 * (pyf - cy) / fy
    ax = d10 * (pxf + 1.0 - cx) / fx - v00x
    ay = d10 * (pyf - cy) / fy - v00y
    az = d10 - d00
    bx = d01 * (pxf - cx) / fx - v00x
    by = d01 * (pyf + 1.0 - cy) / fy - v00y
    bz = d01 - d00
    crx = ay * bz - az * by
    cry = az * bx - ax * bz
    crz = ax * by - ay * bx
    nn = torch.sqrt(crx * crx + cry * cry + crz * crz)
    nn = torch.where(nn == 0, torch.ones_like(nn), nn)
    npx = crx / nn
    npy = cry / nn
    npz = crz / nn

    dvalid = (
        (d00 > 0) & (d00 < cutoff)
        & (d10 > 0) & (d10 < cutoff)
        & (d01 > 0) & (d01 < cutoff)
    )
    dx = v00x - vix
    dy = v00y - viy
    dz = d00 - viz
    dist_ok = torch.sqrt(dx * dx + dy * dy + dz * dz) < dist_thresh
    gx = niy * npz - niz * npy
    gy = niz * npx - nix * npz
    gz = nix * npy - niy * npx
    angle_ok = torch.sqrt(gx * gx + gy * gy + gz * gz) < angle_thresh
    finite = torch.isfinite(vcz) & torch.isfinite(ncx)
    # a point behind the previous camera mirror-projects into the image
    front = (vcz > 0) & (viz > 0)
    mask = found & dvalid & dist_ok & angle_ok & finite & front

    planes = torch.stack(
        [
            _masked(mask, npx),
            _masked(mask, npy),
            _masked(mask, npz),
            _masked(mask, viy * npz - viz * npy),
            _masked(mask, viz * npx - vix * npz),
            _masked(mask, vix * npy - viy * npx),
            _masked(mask, npx * dx + npy * dy + npz * dz),
            mask.to(_F32),
        ]
    ).reshape(8, -1)
    return _normal_equations(planes)


# -- the Gauss-Newton loop ------------------------------------------------


def gn_pose_update(A, b, pose):
    """One damped Gauss-Newton pose step: solve (A + 1e-6 I) x = b
    (non-finite -> 0), Sophus-ordered se3 exp, left-compose. Returns
    (new pose, update magnitude |v|_mm + 1000 |w|_rad, the conv_eps
    early-exit score). ``solve_ex`` does not check its status on the
    host, so the step makes no sync."""
    A = A + 1e-6 * torch.eye(6, dtype=_F32, device=A.device)
    update = torch.linalg.solve_ex(A, b).result  # (v, w), Sophus ordering
    update = torch.where(
        torch.isfinite(update), update, torch.zeros_like(update)
    )
    delta = se3_exp(torch.cat([update[3:6], update[0:3]]))
    v, w = update[0:3], update[3:6]
    score = torch.sqrt((v * v).sum()) + 1000.0 * torch.sqrt((w * w).sum())
    return matmul_small(delta, pose), score


def run_level(step_fn, n_iters: int, eps: float, pose, err, inl):
    """One pyramid level's Gauss-Newton loop. ``step_fn(pose) -> (A, b,
    res_sq, inliers)``. With ``eps == 0`` every iteration runs and
    nothing is read back; with ``eps > 0`` the level stops after the first
    iteration whose update magnitude falls below ``eps`` (one host read
    per executed iteration). The first iteration always runs."""
    for _ in range(n_iters):
        A, b, res_sq, inliers = step_fn(pose)
        pose, score = gn_pose_update(A, b, pose)
        err = torch.sqrt(res_sq / torch.clamp(inliers, min=1.0))
        inl = inliers
        if eps != 0.0 and not float(score) >= eps:
            break
    return pose, err, inl


@torch.no_grad()
def get_incremental_transformation(
    depth_curr: torch.Tensor,
    depth_prev: torch.Tensor,
    fx, fy, cx, cy,
    init_pose: Optional[torch.Tensor] = None,
    levels: int = 3,
    iterations: tuple[int, ...] = (10, 5, 4),
    dist_thresh: float = DIST_THRESH_MM,
    angle_thresh: float = ANGLE_THRESH,
    band: Optional[int] = None,
    conv_eps: float = 0.0,
) -> ICPResult:
    """Full coarse-to-fine ICP between two (H, W) depth frames in mm.

    ``band``: use the banded association (:func:`icp_step_banded_planes`)
    with this level-0 row band (halved per level, at least 8); None = the
    exact association (:func:`icp_step`).

    ``conv_eps``: early-exit threshold on the per-iteration SE3 update
    magnitude ``|v|_mm + 1000 * |w|_rad``. 0.0 (the default) runs the fixed
    10/5/4 schedule.

    Returns T_prev_curr: it maps current-camera points into the previous
    camera's frame. Not a gradient path: it runs under ``no_grad``.
    """
    pyr_c = depth_pyramid(depth_curr, levels)
    pyr_p = depth_pyramid(depth_prev, levels)
    dev = pyr_c[0].device

    maps = []
    for lvl in range(levels):
        intr = level_intrinsics(fx, fy, cx, cy, lvl)
        vc = vertex_map_planes(pyr_c[lvl], *intr)
        nc = normal_map_planes(*vc)
        if band is None:
            # only the exact association reads the model's maps
            vp = vertex_map_planes(pyr_p[lvl], *intr)
            np_ = normal_map_planes(*vp)
        else:
            vp = np_ = None
        maps.append((vc, nc, vp, np_, intr))

    pose = (
        torch.eye(4, dtype=_F32, device=dev) if init_pose is None
        else torch.as_tensor(init_pose, dtype=_F32, device=dev)
    )
    err = torch.zeros((), dtype=_F32, device=dev)
    inl = torch.zeros((), dtype=_F32, device=dev)

    for lvl in range(levels - 1, -1, -1):
        vc, nc, vp, np_, intr = maps[lvl]

        def step(pose, lvl=lvl, vc=vc, nc=nc, vp=vp, np_=np_, intr=intr):
            rot, trans = pose[0:3, 0:3], pose[0:3, 3]
            if band is not None:
                return icp_step_banded_planes(
                    rot, trans, vc, nc, pyr_p[lvl], *intr,
                    band=max(band >> lvl, 8),
                    dist_thresh=dist_thresh, angle_thresh=angle_thresh,
                )
            return icp_step(
                rot, trans, vc, nc, vp, np_, *intr, dist_thresh, angle_thresh
            )

        pose, err, inl = run_level(
            step, iterations[lvl], float(conv_eps), pose, err, inl
        )
    return ICPResult(pose=pose, error=err, inliers=inl)
