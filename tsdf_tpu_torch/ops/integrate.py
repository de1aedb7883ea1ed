"""Depth (and colour) frame integration into the TSDF volume, in plain
PyTorch.

Port of ``tsdf_tpu/ops/integrate.py`` (depth, and depth + rgb; rigid, or
at the deformed centres of a volume with a deformation field) and of the
decimated line convention of
``tsdf_tpu/kernels/integrate.py:_kernel_fast`` / ``_kernel_color``. These
are the plain twins of the CUDA kernels in ``kernels/integrate.py``: the
CPU path and the oracle each kernel is held against on the card.

``integrate`` -- the exact contract. Per voxel:
  * centre c (world, mm): the voxel's centre, or ``vol.deform[z, y, x]``
    (the deformed centre) when the volume has a deformation field
    -> camera point X = R c + t with (R | t) = pose_inv[0:3];
  * pixel p = round((K X) / Z): ``(fx*X + cx*Z) / Z``, rounded half to
    even;
  * gate: p inside the image, Z > 0, depth(p) > 0, sdf >= -trunc where
    sdf = depth(p) - Z;
  * running mean: d' = (d*w + min(sdf, trunc)) / (w+1), w' = w+1
    (optionally capped at max_weight);
  * a centre that is NaN or infinite, or that lands on Z == 0, projects
    to a NaN or infinite pixel, which is outside the image: no update;
  * with ``rgb``: where also |sdf| < trunc, each colour byte moves towards
    rgb(p) at rate max(1/w', 1/max_weight): c' = c + rate*(rgb - c),
    rounded half to even and clipped to [0, 255]. w' is the capped weight
    when ``cap_weight`` is set.

``integrate_fast`` -- the same update at a pixel of the image decimated by
(2 x 4), chosen on the voxel column's image line (see its docstring). It
is a resampling convention, not the exact contract.

Every product and sum is a separate elementwise op written in the order
the kernels evaluate it (no 3x3 matmul), so on the card each twin and its
kernel round identically.
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..volume import TSDFVolume

# the decimation of the fast convention: image rows by 2, columns by 4
FAST_DR, FAST_DC = 2, 4
# projections are clipped to +-FAST_BIG pixels before rounding
FAST_BIG = 1.0e6
# the line of a voxel column is fitted between its first row and the last
# row of the column padded to a multiple of this many voxels
FAST_Y_PAD = 128


def check_rigid(vol: TSDFVolume, what: str) -> None:
    """Raise on a deformed volume: ``what`` integrates at the voxel
    centres only (the JAX ``integrate_pallas`` refuses it the same way)."""
    if vol.deform is not None:
        raise ValueError(
            f"{what} is the rigid path; use ops.integrate.integrate / "
            "kernels.integrate.integrate_warped_cuda for deformed volumes"
        )


def check_frame(vol: TSDFVolume, depth, rgb) -> None:
    """Raise on a frame that cannot be fused into ``vol``."""
    if vol.deform is not None and tuple(vol.deform.shape) != (
        *vol.tsdf.shape, 3
    ):
        raise ValueError(
            f"deform: shape {tuple(vol.deform.shape)}, expected "
            f"{(*vol.tsdf.shape, 3)}"
        )
    if rgb is None:
        return
    if vol.color is None:
        raise ValueError(
            "colour frame given but the volume has no colour field; "
            "use make_volume(with_color=True) / vol.with_color()"
        )
    if tuple(rgb.shape[:2]) != tuple(depth.shape[:2]):
        raise ValueError(
            f"colour frame {tuple(rgb.shape[:2])} does not match depth "
            f"{tuple(depth.shape[:2])}; the flat pixel index would fuse "
            "wrong colours"
        )


def _fuse(vol, depth, rgb, lin, z, gate, cap_weight) -> TSDFVolume:
    """The update shared by both conventions: sample depth (and rgb) at
    the linear pixel index ``lin``, gate, blend."""
    surface = depth.to(torch.float32).reshape(-1)[lin]
    sdf = surface - z
    trunc = vol.truncation_distance
    update = gate & (z > 0) & (surface > 0) & (sdf >= -trunc)
    tsdf_obs = torch.minimum(sdf, trunc)

    prior_d = vol.tsdf
    prior_w = vol.weight
    new_w = prior_w + 1.0
    new_d = (prior_d * prior_w + tsdf_obs) / new_w
    if cap_weight:
        new_w = torch.minimum(new_w, vol.max_weight)

    new_color = vol.color
    if rgb is not None:
        surf_rgb = rgb.to(torch.float32).reshape(-1, 3)[lin]
        col_update = (update & (sdf.abs() < trunc))[..., None]
        old = vol.color.to(torch.float32)
        rate = torch.maximum(1.0 / new_w, 1.0 / vol.max_weight)[..., None]
        blended = old + rate * (surf_rgb - old)
        new_color = torch.clamp(
            torch.round(torch.where(col_update, blended, old)), 0, 255
        ).to(torch.uint8)
    return vol.replace(
        tsdf=torch.where(update, new_d, prior_d),
        weight=torch.where(update, new_w, prior_w),
        color=new_color,
    )


def integrate(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
    rgb: torch.Tensor | None = None,
) -> TSDFVolume:
    """Fuse one depth frame; returns a new volume (inputs untouched).

    Args:
      vol: the volume.
      depth: (H, W) depth in mm, any numeric dtype. Zero means no data.
      camera: Camera with pose = camera->world.
      cap_weight: clamp the accumulated weight at vol.max_weight.
      rgb: optional (H, W, 3) uint8 colour frame; needs ``vol.color``.
    """
    check_frame(vol, depth, rgb)
    h, w = depth.shape

    if vol.deform is None:
        cz, cy, cx = vol.axis_centres()
        cx = cx[None, None, :]
        cy = cy[None, :, None]
        cz = cz[:, None, None]
    else:
        cx, cy, cz = vol.deform.unbind(-1)
    pi = camera.pose_inv
    cam = [
        pi[i, 0] * cx + pi[i, 1] * cy + pi[i, 2] * cz + pi[i, 3]
        for i in range(3)
    ]
    k = camera.k
    z = cam[2]
    px = torch.round((k[0, 0] * cam[0] + k[0, 2] * z) / z)
    py = torch.round((k[1, 1] * cam[1] + k[1, 2] * z) / z)

    in_frustum = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    # outside the image (or NaN at Z == 0) the sample is never used:
    # read pixel 0 there
    lin = torch.where(in_frustum, py * w + px, 0.0).to(torch.int64)
    return _fuse(vol, depth, rgb, lin, z, in_frustum, cap_weight)


def fit_column_lines(vol: TSDFVolume, camera: Camera):
    """The image line px = alpha + beta * py of every voxel column (fixed
    z and x, y varying), as two (Z, 1, X) tensors.

    A projective map sends a column to a straight image line; it is fitted
    through the projections of the column's first voxel centre and of the
    point at y = Y - 0.5 voxels, where Y is the column's length rounded up
    to a multiple of 128. A degenerate fit gives beta = 0 and
    alpha = -1e6 (no pixel).
    """
    zc, _yc, xc = vol.axis_centres()
    vs, off = vol.voxel_size, vol.offset
    sy = vol.tsdf.shape[1]
    y_pad = -(-sy // FAST_Y_PAD) * FAST_Y_PAD
    pi, k = camera.pose_inv, camera.k
    wx = xc[None, None, :]
    kx, ky, kz = (pi[i, 2] * zc[:, None, None] + pi[i, 3] for i in range(3))

    def project_row(wy):
        x = pi[0, 0] * wx + pi[0, 1] * wy + kx
        y = pi[1, 0] * wx + pi[1, 1] * wy + ky
        z = pi[2, 0] * wx + pi[2, 1] * wy + kz
        return k[0, 0] * x / z + k[0, 2], k[1, 1] * y / z + k[1, 2]

    px_a, py_a = project_row(off[1] + 0.5 * vs[1])
    px_b, py_b = project_row(off[1] + (y_pad - 0.5) * vs[1])
    denom = py_b - py_a
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    beta = (px_b - px_a) / denom
    alpha = px_a - beta * py_a
    beta = torch.where(
        torch.isfinite(beta), torch.clamp(beta, -FAST_BIG, FAST_BIG), 0.0
    )
    alpha = torch.where(
        torch.isfinite(alpha), torch.clamp(alpha, -FAST_BIG, FAST_BIG),
        -FAST_BIG,
    )
    return alpha, beta


def integrate_fast(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    cap_weight: bool = False,
    rgb: torch.Tensor | None = None,
) -> tuple[TSDFVolume, torch.Tensor]:
    """Fuse one frame under the decimated line convention; returns
    (new volume, miss count as a 0-d int32 tensor).

    Per voxel: the image row is pyr = round(fy*Y/Z + cy) (non-finite
    -> -1), its decimated row pyd = clip(pyr, 0, H-1) // 2 and real row
    r = 2*pyd; the decimated column is c = round((alpha + beta*r) / 4) on
    the voxel column's line (``fit_column_lines``); the sampled pixel is
    (r, 4c), which is within about 3 px of the exact projection when
    |beta| <= 1. A voxel is in the image when 0 <= pyr < H and
    0 <= 4c < W. Columns steeper than |beta| = 1 (extreme camera roll)
    are skipped, and their in-image voxels are the miss count. The update
    and its other gates are ``integrate``'s; ``rgb`` is sampled at the
    same pixel. A deformed volume is refused: the line of a column of
    deformed centres is not straight.
    """
    check_rigid(vol, "integrate_fast")
    check_frame(vol, depth, rgb)
    h, w = depth.shape
    zc, yc, xc = vol.axis_centres()
    pi, k = camera.pose_inv, camera.k
    wx = xc[None, None, :]
    wy = yc[None, :, None]
    ky, kz = (pi[i, 2] * zc[:, None, None] + pi[i, 3] for i in (1, 2))
    cam_y = pi[1, 0] * wx + pi[1, 1] * wy + ky
    z = pi[2, 0] * wx + pi[2, 1] * wy + kz
    py = k[1, 1] * cam_y / z + k[1, 2]
    py = torch.where(
        torch.isfinite(py), torch.clamp(py, -FAST_BIG, FAST_BIG), -1.0
    )
    pyr = torch.round(py).to(torch.int32)
    del cam_y, py

    alpha, beta = fit_column_lines(vol, camera)
    pyd = torch.clamp(pyr, 0, h - 1) >> 1  # // FAST_DR
    row = pyd.to(torch.float32) * float(FAST_DR)
    col = torch.round(
        torch.clamp(alpha + beta * row, -FAST_BIG, FAST_BIG) / float(FAST_DC)
    ).to(torch.int32)
    del row
    px = col * FAST_DC
    in_img = (pyr >= 0) & (pyr < h) & (px >= 0) & (px < w)
    matched = beta.abs() <= 1.0
    lin = torch.where(in_img, (pyd * FAST_DR) * w + px, 0).to(torch.int64)
    miss = (in_img & ~matched).sum().to(torch.int32)
    del pyr, pyd, col, px
    out = _fuse(vol, depth, rgb, lin, z, in_img & matched, cap_weight)
    return out, miss
