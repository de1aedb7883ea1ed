"""Differentiable raycasting: gradients to the TSDF grid and the pose.

Port of ``tsdf_tpu/ops/raycast_diff.py``. The backward never goes through
the march loop: the implicit-function trick. The march finds t0 with
f(t0) ~= 0 where f(t) = trilinear_tsdf(o + t*d), with no gradient. One
differentiable Newton correction

    t* = t0 - f(t0) / stopgrad(f'(t0))

has the value ~= t0 but carries the exact implicit derivatives
dt*/dtheta = -(df/dtheta)/f' for theta in {tsdf grid, camera pose,
intrinsics}: autograd through the correction gives them, and the adjoint
of the 8 trilinear taps is the scatter-add into the grid.

The two halves are public: ``march`` (no gradient; the raycast kernel on
CUDA tensors, ``ops.raycast.march_rays`` on CPU tensors) and ``correct``
(plain PyTorch, differentiable by reverse and by forward-mode AD).
``raycast_diff`` composes them. A caller that takes a Jacobian by
forward-mode AD over the pose marches once at the current pose outside the
dual level and differentiates only ``correct``: the tangents flow only
through the correction in any case.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera import Camera
from ..kernels.raycast import raycast_vertices_cuda
from ..volume import TSDFVolume
from .raycast import REFERENCE_MAX_STEPS, march_rays, ray_directions
from .trilinear import trilinear_sample


def _detached(obj):
    """A copy of a Camera or TSDFVolume whose tensors carry no gradient and
    no forward-mode tangent (``torch.no_grad`` keeps the tangents)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).detach()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def march(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The non-differentiable march: (t0, hit), both flat (H*W,), t0 the
    distance from the camera centre to each ray's hit (0 on a miss).

    On CUDA tensors the march is the raycast kernel
    (``kernels.raycast.raycast_vertices_cuda``), which is the sphere trace
    at step scale 0.75 only: another ``mode`` or ``step_scale`` raises.
    On CPU tensors it is ``ops.raycast.march_rays``.
    """
    vol, camera = _detached(vol), _detached(camera)
    with torch.no_grad():
        if vol.tsdf.device.type == "cuda":
            if mode != "sphere" or step_scale != 0.75:
                raise ValueError(
                    "the raycast kernel is the sphere trace at step scale "
                    f"0.75; got mode={mode!r}, step_scale={step_scale}"
                )
            verts0 = raycast_vertices_cuda(
                vol, camera, width, height, max_steps=max_steps
            ).reshape(-1, 3)
        else:
            dirs = ray_directions(camera, width, height).reshape(-1, 3)
            verts0 = march_rays(
                vol, camera.position, dirs, mode=mode, max_steps=max_steps,
                step_scale=step_scale,
            )
        hit = torch.isfinite(verts0).all(dim=-1)
        # mask before any arithmetic: a miss is NaN
        rel = torch.where(hit[:, None], verts0, 0.0) - camera.position
        dist = torch.sqrt(
            rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
            + rel[:, 2] * rel[:, 2]
        )
        t0 = torch.where(hit, dist, 0.0)
    return t0, hit


def _sample_along(vol: TSDFVolume, origin, dirs, t):
    """f(t) = trilinear_tsdf(origin + t * dirs) for each ray."""
    pts = origin[None, :] + t[:, None] * dirs - vol.space_min[None, :]
    return trilinear_sample(vol.tsdf, pts, vol.voxel_size)


def slope(
    vol: TSDFVolume,
    camera: Camera,
    t0: torch.Tensor,
    width: int = 640,
    height: int = 480,
) -> torch.Tensor:
    """f'(t0) along each ray, clamped away from 0 (|f'| >= 1e-6, its sign
    kept): the frozen scale of the Newton correction, with no gradient or
    tangent. f is elementwise in t, so the gradient of its sum is each
    ray's derivative (JAX takes it as a jvp along t)."""
    vol, camera = _detached(vol), _detached(camera)
    dirs = ray_directions(camera, width, height).reshape(-1, 3)
    with torch.enable_grad():
        t = t0.detach().clone().requires_grad_(True)
        fsum = _sample_along(vol, camera.position, dirs, t).sum()
        (fp,) = torch.autograd.grad(fsum, t)
    return torch.where(fp.abs() < 1e-6, torch.where(fp < 0, -1e-6, 1e-6), fp)


def correct(
    vol: TSDFVolume,
    camera: Camera,
    t0: torch.Tensor,
    hit: torch.Tensor,
    width: int = 640,
    height: int = 480,
    fp: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The differentiable Newton correction around the march's ``t0``:
    (vertices (H, W, 3), NaN on a miss; hit mask (H, W)). ``fp`` is
    ``slope(vol, camera, t0, ...)``, computed here unless given (several
    dual passes at one pose share it)."""
    origin = camera.position
    dirs = ray_directions(camera, width, height).reshape(-1, 3)
    t0 = t0.detach()
    if fp is None:
        fp = slope(vol, camera, t0, width, height)
    t_star = t0 - _sample_along(vol, origin, dirs, t0) / fp
    verts = origin[None, :] + t_star[:, None] * dirs
    verts = torch.where(hit[:, None], verts, float("nan"))
    return verts.reshape(height, width, 3), hit.reshape(height, width)


def raycast_diff(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable raycast: ``march``, then ``correct``.

    Returns:
      vertices: (H, W, 3) world-mm hit points (NaN on a miss),
        differentiable with respect to vol.tsdf and the camera's pose and
        intrinsics.
      hit_mask: (H, W) bool, not differentiable.
    """
    t0, hit = march(vol, camera, width, height, mode=mode,
                    max_steps=max_steps, step_scale=step_scale)
    return correct(vol, camera, t0, hit, width, height)


def vertices_to_depth(verts, hit, camera: Camera) -> torch.Tensor:
    """(H, W) camera-z in mm of differentiable vertices, 0 on a miss."""
    h, w, _ = verts.shape
    cam_pts = camera.world_to_camera(
        torch.where(hit[..., None], verts, 0.0).reshape(-1, 3)
    ).reshape(h, w, 3)
    return torch.where(hit, cam_pts[..., 2], 0.0)


def depth_image_diff(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    **kwargs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable depth render: ((H, W) camera-z in mm, 0 on a miss;
    the hit mask). ``kwargs`` go to ``raycast_diff``."""
    verts, hit = raycast_diff(vol, camera, width, height, **kwargs)
    return vertices_to_depth(verts, hit, camera), hit
