"""Plain reference of the tracked KinectFusion step: the bilateral
filter of the tracker's input, the sphere-traced model render, and
coarse-to-fine projective point-to-plane ICP (Newcombe et al., ISMAR 2011;
the conventions of Whelan's ICP_CUDA odometry).

Written from the algorithm's published description with the settings
the configuration states: bilateral window r = ceil(1.5 sigma_space);
render by sphere tracing (step clip(0.75 tsdf, 0.05 trunc, 0.9 trunc),
secant-refined hit, at most 4400 samples); a 3-level pyramid (5-tap
binomial under a 3 sigma_color gate, sigma_color 30); residual
n_p . (v_p - T v_c), gates 100 mm and sin(20 deg); 10/5/4 Gauss-Newton
iterations coarse to fine; at level 0 the model is looked up only within
``band`` rows (halved a level, at least 8), and a frame whose inliers
fall under the configured share is tracked again with the exact
association. Every product and sum is its own elementwise float32
operation, in the order written.

Imports nothing but torch: it takes no part of the program under test.
"""

from __future__ import annotations

import math

import torch

from .fusion import Grid

_F32 = torch.float32
DIST_THRESH_MM = 100.0
ANGLE_THRESH = math.sin(20.0 * math.pi / 180.0)
SIGMA_COLOR = 30.0
DEPTH_CUTOFF_MM = 20000.0
MAX_STEPS = 4400
_BINOMIAL = (0.0625, 0.25, 0.375, 0.25, 0.0625)


# -- bilateral filter ---------------------------------------------------


def bilateral(depth: torch.Tensor, sigma_colour: float, sigma_space: float):
    """Edge-preserving smoothing of a float32 (H, W) depth frame; zero is
    no data, contributes nothing and stays zero."""
    d = depth.to(_F32)
    h, w = d.shape
    r = math.ceil(sigma_space * 1.5)
    inv_ss2 = 1.0 / (sigma_space * sigma_space)
    c = 0.5 * (1.0 / (sigma_colour * sigma_colour))
    padded = torch.nn.functional.pad(d, (r,) * 4)
    zero = torch.zeros_like(d)
    num, den = zero, zero
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            w_s = math.exp(-(dx * dx + dy * dy) * inv_ss2)
            tap = padded[dy + r:dy + r + h, dx + r:dx + r + w]
            dv = tap - d
            wgt = torch.where(tap > 0, w_s * torch.exp(-(dv * dv) * c), zero)
            num = num + tap * wgt
            den = den + wgt
    return torch.where(d > 0, num / torch.clamp(den, min=1e-12), zero)


# -- model render ---------------------------------------------------------


def trilinear(values: torch.Tensor, p: torch.Tensor, vs: torch.Tensor):
    """Sample (Z, Y, X) ``values`` at grid-local points p (N, 3): border
    samples extrapolate from the clamped lower cell, taps clamp to the
    grid, points past the far face are pulled back by a tenth of a
    voxel."""
    sz, sy, sx = values.shape
    top = torch.stack([vs[0] * sx, vs[1] * sy, vs[2] * sz])
    p = torch.where(p >= top, top - vs / 10.0, p)
    p = torch.where(p < 0.0, torch.zeros_like(p), p)
    g = p / vs - 0.5
    lower = torch.clamp(torch.floor(g), min=0.0)
    uvw = g - lower
    u, v, w = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    lx, ly, lz = lower.to(torch.int64).unbind(-1)
    ix = [torch.clamp(lx + o, 0, sx - 1) for o in (0, 1)]
    iy = [torch.clamp(ly + o, 0, sy - 1) for o in (0, 1)]
    iz = [torch.clamp(lz + o, 0, sz - 1) for o in (0, 1)]
    flat = values.reshape(-1)

    def tap(a, b, c):
        return flat[(iz[c] * sy + iy[b]) * sx + ix[a]].to(_F32)

    return (tap(0, 0, 0) * (1 - u) * (1 - v) * (1 - w)
            + tap(0, 0, 1) * (1 - u) * (1 - v) * w
            + tap(0, 1, 0) * (1 - u) * v * (1 - w)
            + tap(0, 1, 1) * (1 - u) * v * w
            + tap(1, 0, 0) * u * (1 - v) * (1 - w)
            + tap(1, 0, 1) * u * (1 - v) * w
            + tap(1, 1, 0) * u * v * (1 - w)
            + tap(1, 1, 1) * u * v * w)


def render_depth(grid: Grid, pose: torch.Tensor, pose_inv: torch.Tensor,
                 k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W) camera-z depth of the model's surface seen from ``pose``, 0
    where a ray misses."""
    dev = grid.tsdf.device
    k_inv = torch.linalg.inv_ex(k).inverse
    xs = torch.arange(w, dtype=_F32, device=dev)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=_F32, device=dev)[:, None].expand(h, w)
    d_cam = [k_inv[i, 0] * xs + k_inv[i, 1] * ys + k_inv[i, 2] for i in range(3)]
    rot = pose[0:3, 0:3]
    d = [rot[i, 0] * d_cam[0] + rot[i, 1] * d_cam[1] + rot[i, 2] * d_cam[2]
         for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dirs = torch.stack([c / norm for c in d], dim=-1).reshape(-1, 3)
    origin = pose[0:3, 3][None, :]

    lo = grid.offset[None, :]
    hi = (grid.offset + grid.physical)[None, :]
    safe = torch.where(dirs == 0.0, torch.full_like(dirs, 1e-20), dirs)
    t1 = (lo - origin) / safe
    t2 = (hi - origin) / safe
    inside = (origin >= lo) & (origin <= hi)
    par_miss = ((dirs == 0.0) & ~inside).any(dim=-1)
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1)
    meets = (near <= far) & (far >= 0.0) & ~par_miss
    near = torch.clamp(near, min=0.0)
    start = origin + near[:, None] * dirs - lo
    max_t = far - near

    trunc = grid.trunc
    min_step = trunc * 0.05
    max_step = trunc * 0.9
    zeros = torch.zeros_like(dirs[:, 0])
    t = zeros
    hit_t = zeros
    prev = zeros + trunc
    prev_step = zeros + min_step
    marching = meets.clone()
    hit_any = torch.zeros_like(meets)
    count = 0
    while count < MAX_STEPS and bool(marching.any()):
        for _ in range(min(16, MAX_STEPS - count)):
            pts = start + t[:, None] * dirs
            val = trilinear(grid.tsdf, pts, grid.voxel_size)
            frac = prev / (prev - val)
            refined = t - prev_step + frac * prev_step
            hit = marching & (val <= 0.0)
            new_hit_t = torch.where(val < 0.0, refined, t)
            back = marching & (val > 0.0) & (prev < 0.0)
            step = torch.clamp(0.75 * val, min_step, max_step)
            new_t = t + step
            escaped = marching & ~hit & ~back & (new_t >= max_t)
            t = torch.where(marching & ~hit, new_t, t)
            hit_t = torch.where(hit, new_hit_t, hit_t)
            prev = torch.where(marching, val, prev)
            prev_step = torch.where(marching, step, prev_step)
            hit_any = hit_any | hit
            marching = marching & ~hit & ~back & ~escaped
            count += 1
    verts = start + hit_t[:, None] * dirs + lo
    pi = pose_inv
    camz = pi[2, 0] * verts[:, 0] + pi[2, 1] * verts[:, 1] + pi[2, 2] * verts[:, 2] + pi[2, 3]
    ok = hit_any & torch.isfinite(verts).all(dim=-1)
    return torch.where(ok, camz, 0.0).reshape(h, w)


# -- ICP ------------------------------------------------------------------


def _pyr_down(d: torch.Tensor) -> torch.Tensor:
    h, w = d.shape
    ch, cw = h // 2, w // 2
    centre = d[0:2 * ch:2, 0:2 * cw:2]
    dpad = torch.nn.functional.pad(d, (2, 2, 2, 2), value=float("nan"))
    zero = torch.zeros_like(centre)
    num, den = zero, zero
    for dy in range(5):
        for dx in range(5):
            wgt = _BINOMIAL[dy] * _BINOMIAL[dx]
            val = dpad[dy:dy + 2 * ch:2, dx:dx + 2 * cw:2]
            ok = (val - centre).abs() < 3.0 * SIGMA_COLOR
            num = num + torch.where(ok, val * wgt, zero)
            den = den + ok * wgt
    return torch.floor(num / torch.clamp(den, min=1e-12))


def _vertices(d, fx, fy, cx, cy):
    h, w = d.shape
    us = torch.arange(w, dtype=_F32, device=d.device)[None, :]
    vs = torch.arange(h, dtype=_F32, device=d.device)[:, None]
    bad = ~((d > 0) & (d < DEPTH_CUTOFF_MM))
    nan = torch.full_like(d, float("nan"))
    return (torch.where(bad, nan, d * (us - cx) / fx),
            torch.where(bad, nan, d * (vs - cy) / fy),
            torch.where(bad, nan, d))


def _normals(vx, vy, vz):
    pad = torch.nn.functional.pad

    def sx(p):
        return pad(p[:, 1:], (0, 1))

    def sy(p):
        return pad(p[1:, :], (0, 0, 0, 1))

    rx, ry, rz = sx(vx) - vx, sx(vy) - vy, sx(vz) - vz
    dx, dy, dz = sy(vx) - vx, sy(vy) - vy, sy(vz) - vz
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    edge = torch.zeros_like(vx, dtype=torch.bool)
    edge[-1, :] = True
    edge[:, -1] = True
    return tuple(torch.where(edge, float("nan"), c / norm) for c in (nx, ny, nz))


def _rotate(rot, x, y, z):
    return [rot[i, 0] * x + rot[i, 1] * y + rot[i, 2] * z for i in range(3)]


def _project(x, y, z, fx, fy, cx, cy):
    pxf = x * fx / z + cx
    pyf = y * fy / z + cy
    pxf = torch.where(torch.isfinite(pxf), pxf, -1.0)
    pyf = torch.where(torch.isfinite(pyf), pyf, -1.0)
    return (torch.round(torch.clamp(pxf, -1e6, 1e6)).to(torch.int32),
            torch.round(torch.clamp(pyf, -1e6, 1e6)).to(torch.int32))


def _clean(mask, p):
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.nan_to_num(p, nan=0.0, posinf=0.0, neginf=0.0)


def _pairs():
    """The 29 products of the reduction over the eight rows: the upper
    triangle of A (21), b (6), sum r^2 and the inlier count."""
    tri = [(i, j) for i in range(6) for j in range(i, 6)]
    return tri + [(i, 6) for i in range(6)] + [(6, 6), (7, 7)]


def _normal_equations(rows):
    """(A, b, sum r^2, inliers) of the eight rows [J (6), r, mask]: the 29
    products summed in float32 over the pixels."""
    planes = torch.stack([r.reshape(-1) for r in rows])
    pairs = _pairs()
    dev = planes.device
    iu = torch.tensor([p[0] for p in pairs], dtype=torch.int64, device=dev)
    ju = torch.tensor([p[1] for p in pairs], dtype=torch.int64, device=dev)
    sums = (planes.index_select(0, iu) * planes.index_select(0, ju)).sum(dim=1)
    slot = {p: n for n, p in enumerate(pairs)}
    a_idx = torch.tensor([[slot[(min(i, j), max(i, j))] for j in range(6)]
                          for i in range(6)], dtype=torch.int64, device=dev)
    b_idx = torch.tensor([slot[(i, 6)] for i in range(6)], dtype=torch.int64,
                         device=dev)
    return sums[a_idx], sums[b_idx], sums[27], sums[28]


def _rows(mask, nx, ny, nz, vx, vy, vz, r):
    return [_clean(mask, nx), _clean(mask, ny), _clean(mask, nz),
            _clean(mask, vy * nz - vz * ny), _clean(mask, vz * nx - vx * nz),
            _clean(mask, vx * ny - vy * nx), _clean(mask, r),
            mask.to(_F32)]


def _step_banded(rot, trans, vc, nc, dp, fx, fy, cx, cy, band):
    h, w = dp.shape
    vix, viy, viz = _rotate(rot, *vc)
    vix, viy, viz = vix + trans[0], viy + trans[1], viz + trans[2]
    nix, niy, niz = _rotate(rot, *nc)
    px, py = _project(vix, viy, viz, fx, fy, cx, cy)
    in_img = (px >= 0) & (px < w - 1) & (py >= 0) & (py < h - 1)
    yy = torch.arange(vc[0].shape[0], dtype=torch.int32, device=dp.device)[:, None]
    found = in_img & ((py - yy).abs() <= band)
    lin = torch.where(found, py * w + px, 0).to(torch.int64)
    flat = dp.reshape(-1)
    zero = torch.zeros_like(vix)
    d00 = torch.where(found, flat[lin], zero)
    d10 = torch.where(found, flat[torch.where(found, lin + 1, 0)], zero)
    d01 = torch.where(found, flat[torch.where(found, lin + w, 0)], zero)
    pxf, pyf = px.to(_F32), py.to(_F32)
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
    npx, npy, npz = crx / nn, cry / nn, crz / nn
    dvalid = ((d00 > 0) & (d00 < DEPTH_CUTOFF_MM) & (d10 > 0)
              & (d10 < DEPTH_CUTOFF_MM) & (d01 > 0) & (d01 < DEPTH_CUTOFF_MM))
    dx, dy, dz = v00x - vix, v00y - viy, d00 - viz
    dist_ok = torch.sqrt(dx * dx + dy * dy + dz * dz) < DIST_THRESH_MM
    gx = niy * npz - niz * npy
    gy = niz * npx - nix * npz
    gz = nix * npy - niy * npx
    angle_ok = torch.sqrt(gx * gx + gy * gy + gz * gz) < ANGLE_THRESH
    finite = torch.isfinite(vc[2]) & torch.isfinite(nc[0])
    front = (vc[2] > 0) & (viz > 0)
    mask = found & dvalid & dist_ok & angle_ok & finite & front
    return _normal_equations(_rows(mask, npx, npy, npz, vix, viy, viz,
                                   npx * dx + npy * dy + npz * dz))


def _step_exact(rot, trans, vc, nc, vp, np_, fx, fy, cx, cy):
    h, w = vp[0].shape
    vix, viy, viz = _rotate(rot, *vc)
    vix, viy, viz = vix + trans[0], viy + trans[1], viz + trans[2]
    nix, niy, niz = _rotate(rot, *nc)
    px, py = _project(vix, viy, viz, fx, fy, cx, cy)
    in_img = ((px >= 0) & (px < w) & (py >= 0) & (py < h) & (vc[2] > 0)
              & (viz > 0))
    lin = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).to(torch.int64)
    vpx, vpy, vpz = (p.reshape(-1)[lin.reshape(-1)].reshape(lin.shape) for p in vp)
    npx, npy, npz = (p.reshape(-1)[lin.reshape(-1)].reshape(lin.shape) for p in np_)
    dx, dy, dz = vpx - vix, vpy - viy, vpz - viz
    dist_ok = torch.sqrt(dx * dx + dy * dy + dz * dz) < DIST_THRESH_MM
    gx = niy * npz - niz * npy
    gy = niz * npx - nix * npz
    gz = nix * npy - niy * npx
    angle_ok = torch.sqrt(gx * gx + gy * gy + gz * gz) < ANGLE_THRESH
    finite = (torch.isfinite(vc[2]) & torch.isfinite(nc[0]) & torch.isfinite(vpz)
              & torch.isfinite(npx))
    mask = in_img & dist_ok & angle_ok & finite
    zero = torch.zeros_like(vix)
    ns = [torch.where(mask, c, zero) for c in (npx, npy, npz)]
    vs = [torch.where(mask, c, zero) for c in (vix, viy, viz)]
    return _normal_equations(_rows(mask, *ns, *vs, npx * dx + npy * dy + npz * dz))


def _hat(o):
    z = torch.zeros_like(o[0])
    return torch.stack([torch.stack([z, -o[2], o[1]]),
                        torch.stack([o[2], z, -o[0]]),
                        torch.stack([-o[1], o[0], z])])


def matmul(a, b):
    """a @ b for small matrices as products and sums, in true float32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(omega, v) -> 4x4: [exp(omega^), V v] with Rodrigues' coefficients
    and their Taylor series below theta^2 = 1e-8."""
    omega, v = xi[0:3], xi[3:6]
    theta2 = (omega * omega).sum()
    k = _hat(omega)
    kk = matmul(k, k)
    small = theta2 < 1e-8
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / safe)
    eye = torch.eye(3, dtype=_F32, device=xi.device)
    r = eye + a * k + b * kk
    vmat = eye + b * k + c * kk
    t = torch.eye(4, dtype=_F32, device=xi.device)
    t[0:3, 0:3] = r
    t[0:3, 3] = (vmat * v[None, :]).sum(dim=-1)
    return t


def icp(depth_curr, depth_prev, fx, fy, cx, cy, iterations, band):
    """Coarse-to-fine ICP of a frame against the model depth. Returns
    (T_prev_curr, inliers of the last iteration)."""
    dev = depth_curr.device
    pyr_c, pyr_p = [depth_curr.to(_F32)], [depth_prev.to(_F32)]
    for _ in range(len(iterations) - 1):
        pyr_c.append(_pyr_down(pyr_c[-1]))
        pyr_p.append(_pyr_down(pyr_p[-1]))
    pose = torch.eye(4, dtype=_F32, device=dev)
    inliers = torch.zeros((), dtype=_F32, device=dev)
    eye6 = 1e-6 * torch.eye(6, dtype=_F32, device=dev)
    for lvl in range(len(iterations) - 1, -1, -1):
        s = 1.0 / (1 << lvl)
        intr = (fx * s, fy * s, cx * s, cy * s)
        vc = _vertices(pyr_c[lvl], *intr)
        nc = _normals(*vc)
        if band is None:
            vp = _vertices(pyr_p[lvl], *intr)
            np_ = _normals(*vp)
        for _ in range(iterations[lvl]):
            rot, trans = pose[0:3, 0:3], pose[0:3, 3]
            if band is None:
                a, b, _r2, inl = _step_exact(rot, trans, vc, nc, vp, np_, *intr)
            else:
                a, b, _r2, inl = _step_banded(rot, trans, vc, nc, pyr_p[lvl],
                                              *intr, max(band >> lvl, 8))
            x = torch.linalg.solve_ex(a + eye6, b).result
            x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
            pose = matmul(se3_exp(torch.cat([x[3:6], x[0:3]])), pose)
            inliers = inl
    return pose, inliers


def track(depth, model_depth, k, fusion: dict, min_inliers: float):
    """One tracked frame's ICP as the configuration states it: the
    bilateral-filtered frame against the model depth with the banded
    association, again with the exact one if the inliers fall short.
    Returns (T_prev_curr, inliers, lost)."""
    if fusion["use_bilateral_filter"]:
        depth = bilateral(depth, fusion["sigma_colour"], fusion["sigma_space"])
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    iters = fusion["icp_iterations"]
    band = fusion["icp_band"] if fusion["icp_band"] > 0 else None
    pose, inl = icp(depth, model_depth, fx, fy, cx, cy, iters, band)
    lost = bool(inl < min_inliers)
    if lost and band is not None:
        pose, inl = icp(depth, model_depth, fx, fy, cx, cy, iters, None)
        lost = bool(inl < min_inliers)
    return pose, inl, lost


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(translation gap in mm, rotation gap in mrad) between two poses."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    dt = float((a[0:3, 3] - b[0:3, 3]).norm())
    r = a[0:3, 0:3].T @ b[0:3, 0:3]
    cos = float(((r.trace() - 1.0) / 2.0).clamp(-1.0, 1.0))
    # acos loses precision near 1: take the angle from the skew part
    skew = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    ang = math.atan2(float(skew.norm()) / 2.0, cos)
    return dt, ang * 1e3
