"""Differentiable fusion: the pose gradient of the integrate operator, in
plain PyTorch.

Port of ``tsdf_tpu/ops/integrate_diff.py`` plus the plain twin of the
pose-adjoint kernel (``csrc/integrate_pose_grad.cu``, which replaces
``tsdf_tpu/kernels/integrate.py:_kernel_pose_grad``).

The integrate's depth lookup is a rounded nearest-pixel read, and
``round()`` has zero gradient: autograd through ``ops/integrate.py`` sees
only the projective-SDF term (-cam_z) and is blind to the image-space term
(the depth gradient under the moving projection), which carries most of
the alignment signal for a pose optimised THROUGH fusion. This module
writes the adjoint with both terms.

Per voxel (x_w its world centre, x_c = R_wc x_w + t_wc its camera point):
  d px = fx (dXc Zc - Xc dZc) / Zc^2,   d py analog
  d sdf = [Gx(p) d px + Gy(p) d py]  -  dZc
            (image term; Gx/Gy central differences of the depth frame)
  d new_d / d sdf = update & (sdf < trunc) / (w + 1)

``pose_gradient_lax`` returns the LEFT-twist gradient at the current pose
(T' = se3_exp(delta) @ T at delta = 0; (omega, v) packing of
``utils/se3.py``). ``integrate_pose_grad`` returns the raw cotangent of
the pose_inv MATRIX instead (and the volume cotangents); the caller,
``kernels.integrate.integrate_pose``, lets autograd chain it through the
4x4 inverse and ``se3_exp``, so its gradient is exact at any twist.

The gates and the projection are those of the exact integrate
(``ops.integrate.project_voxels``); every product and sum of
``integrate_pose_grad`` is written in the order the kernel evaluates it,
so on the card its ``dd`` and ``dw`` equal the kernel's bit for bit.
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..volume import TSDFVolume
from .integrate import check_rigid, project_voxels

_F32 = torch.float32


def _shifted(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``a`` moved by (dy, dx) with zero fill: out[y, x] = a[y-dy, x-dx]."""
    out = torch.zeros_like(a)
    h, w = a.shape
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = (
        a[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    )
    return out


def depth_image_gradients(depth: torch.Tensor):
    """(Gx, Gy) central differences of the depth frame in mm/px.

    Pixels adjacent to a no-data (zero) sample get zero gradient: depth
    discontinuities and silhouettes carry no usable image term.
    """
    d = depth.to(_F32)
    valid = d > 0
    left, right = _shifted(d, 0, 1), _shifted(d, 0, -1)
    up, down = _shifted(d, 1, 0), _shifted(d, -1, 0)
    vl, vr = _shifted(valid, 0, 1), _shifted(valid, 0, -1)
    vu, vd = _shifted(valid, 1, 0), _shifted(valid, -1, 0)
    gx = torch.where(valid & vl & vr, (right - left) * 0.5, 0.0)
    gy = torch.where(valid & vu & vd, (down - up) * 0.5, 0.0)
    return gx, gy


def sample_frame(depth: torch.Tensor, vol: TSDFVolume, camera: Camera):
    """The exact projection of every voxel of ``vol``, the depth and its two
    gradient images at its pixel, and the update gate of the exact
    integrate: (centre, cam, gx, gy, sdf, update)."""
    depth = depth.to(_F32)
    gx_img, gy_img = depth_image_gradients(depth)
    centre, cam, lin, in_frustum = project_voxels(vol, camera, *depth.shape)
    d_obs = depth.reshape(-1)[lin]
    gxv = gx_img.reshape(-1)[lin]
    gyv = gy_img.reshape(-1)[lin]
    zc = cam[2]
    sdf = d_obs - zc
    trunc = vol.truncation_distance
    update = in_frustum & (zc > 0) & (d_obs > 0) & (sdf >= -trunc)
    return centre, cam, gxv, gyv, sdf, update


def pose_gradient_lax(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    gbar_tsdf: torch.Tensor,
    image_term: bool = True,
) -> torch.Tensor:
    """Analytic d<gbar_tsdf, new_tsdf>/d delta at delta = 0: the (6,) twist
    gradient (omega, v). The semantics reference of the pose adjoint."""
    (xw, yw, zw), cam, gxv, gyv, sdf, update = sample_frame(depth, vol, camera)
    shape = vol.tsdf.shape
    xw, yw, zw = (c.expand(shape) for c in (xw, yw, zw))
    band = sdf < vol.truncation_distance  # the min(sdf, trunc) clamp's slope
    coef = (gbar_tsdf.to(_F32) * (update & band).to(_F32)
            / (vol.weight.to(_F32) + 1.0))

    rwc = camera.pose_inv[0:3, 0:3]
    k = camera.k
    fx, fy = k[0, 0], k[1, 1]
    xc, yc, zc = cam
    # Zc == 0 exactly would give 0 * inf = NaN through the masked product
    # (coef is already zero there through the update gate)
    zc2 = torch.where(zc > 0, zc * zc, 1.0)
    zero = torch.zeros_like(xw)
    grads = []
    for j in range(6):
        if j < 3:  # omega_j: d x_w = e_j x x_w
            ex, ey, ez = (
                (zero, -zw, yw), (zw, zero, -xw), (-yw, xw, zero)
            )[j]
        else:  # v_j: d x_w = e_j
            ex, ey, ez = (zero + float(j == i) for i in (3, 4, 5))
        dxc = -(rwc[0, 0] * ex + rwc[0, 1] * ey + rwc[0, 2] * ez)
        dyc = -(rwc[1, 0] * ex + rwc[1, 1] * ey + rwc[1, 2] * ez)
        dzc = -(rwc[2, 0] * ex + rwc[2, 1] * ey + rwc[2, 2] * ez)
        dsdf = -dzc
        if image_term:
            dpx = fx * (dxc * zc - xc * dzc) / zc2
            dpy = fy * (dyc * zc - yc * dzc) / zc2
            dsdf = dsdf + gxv * dpx + gyv * dpy
        grads.append((coef * dsdf).sum())
    return torch.stack(grads)


def _camera_point_cotangent(vol, camera, frame, gbar_d, image_term):
    """dL/dx_c per voxel, (dxc, dyc, dzc): zero where the voxel is not
    updated or the clamp min(sdf, trunc) is flat."""
    _centre, (xc, yc, zc), gxv, gyv, sdf, update = frame
    new_w = vol.weight.to(_F32) + 1.0
    gate = update & (sdf < vol.truncation_distance)
    coef = torch.where(gate, gbar_d.to(_F32) / new_w, 0.0)
    if not image_term:
        return torch.zeros_like(coef), torch.zeros_like(coef), -coef
    k = camera.k
    fx, fy = k[0, 0], k[1, 1]
    zs = torch.where(zc > 0, zc, 1.0)
    zc2 = torch.where(zc > 0, zc * zc, 1.0)
    dxc = torch.where(gate, coef * gxv * fx / zs, 0.0)
    dyc = torch.where(gate, coef * gyv * fy / zs, 0.0)
    dzc = torch.where(
        gate,
        coef * (-gxv * fx * xc / zc2 - gyv * fy * yc / zc2 - 1.0),
        0.0,
    )
    return dxc, dyc, dzc


def _terms(dxc, dyc, dzc, centre):
    """dL/dR_wc[i, j] = sum dL/dx_c[i] * x_w[j], dL/dt_wc[i] = sum
    dL/dx_c[i]: the 12 float32 terms per voxel, in the row order of the
    pose_inv cotangent's R_wc | t_wc, one at a time."""
    for dci in (dxc, dyc, dzc):
        for c in (*centre, None):
            yield dci if c is None else dci * c


def pose_grad_terms(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    gbar_d: torch.Tensor,
    image_term: bool = True,
):
    """The 12 float32 terms per voxel whose float64 sums are the rows R_wc |
    t_wc of ``integrate_pose_grad``'s pose_inv cotangent, one (Z, Y, X) or
    broadcastable tensor at a time, in row order (the pose-adjoint kernel
    adds the same float32 products)."""
    frame = sample_frame(depth, vol, camera)
    yield from _terms(
        *_camera_point_cotangent(vol, camera, frame, gbar_d, image_term),
        frame[0],
    )


def integrate_pose_grad(
    vol: TSDFVolume,
    depth: torch.Tensor,
    camera: Camera,
    gbar_d: torch.Tensor,
    gbar_w: torch.Tensor,
    cap_weight: bool = False,
    image_term: bool = True,
):
    """The adjoint of the exact rigid integrate (the plain twin of the
    pose-adjoint kernel).

    Args:
      vol: the volume the frame was fused INTO (tsdf_in, weight_in).
      depth: (H, W) depth in mm of the frame.
      camera: the frame's camera; only k and pose_inv are read.
      gbar_d, gbar_w: (Z, Y, X) cotangents of the fused tsdf and weight,
        in the volume's dtype or float32; read into float32.
      cap_weight: the forward clamped the weight at vol.max_weight.
      image_term: include the depth image's gradient under the moving
        projection (otherwise only the -cam_z term).

    Returns (dd, dw, dpinv): the cotangents of tsdf_in and weight_in, in
    the volume's dtype (computed in float32 and rounded once, as the JAX
    backward casts them), and the (4, 4) f32 cotangent of pose_inv (rows
    R_wc | t_wc; the bottom row is zero). Its 12 sums are taken in float64
    over float32 terms.
    """
    check_rigid(vol, "integrate_pose_grad")
    frame = sample_frame(depth, vol, camera)
    centre, _cam, _gxv, _gyv, sdf, update = frame
    trunc = vol.truncation_distance
    d, w = vol.tsdf.to(_F32), vol.weight.to(_F32)
    gbar_d, gbar_w = gbar_d.to(_F32), gbar_w.to(_F32)
    new_w = w + 1.0

    cotangent = _camera_point_cotangent(vol, camera, frame, gbar_d,
                                        image_term)
    sums = [t.to(torch.float64).sum() for t in _terms(*cotangent, centre)]
    dpinv = torch.cat([
        torch.stack(sums).to(_F32).reshape(3, 4),
        torch.zeros((1, 4), dtype=_F32, device=d.device),
    ])

    dd = gbar_d * torch.where(update, w / new_w, 1.0)
    o = torch.minimum(sdf, trunc)
    dnewd_dw = torch.where(update, gbar_d * ((d - o) / (new_w * new_w)), 0.0)
    if cap_weight:
        # torch.minimum's subgradient: 1 below the cap, 0.5 at the tie
        # (weights step by 1, so every voxel reaches the tie on the frame
        # it reaches the cap), 0 above
        below = (new_w < vol.max_weight).to(_F32)
        tie = (new_w == vol.max_weight).to(_F32)
        capfac = torch.where(update, below + 0.5 * tie, 1.0)
        dw = dnewd_dw + gbar_w * capfac
    else:
        dw = dnewd_dw + gbar_w
    return dd.to(vol.tsdf.dtype), dw.to(vol.weight.dtype), dpinv
