"""The package-level integrate and raycast of ``tsdf_tpu``, routed by
the device of their tensors.

On CUDA tensors each call is a kernel: a rigid volume fuses through
``integrate_cuda`` (``integrate_color_cuda`` with ``rgb``), a deformed one
through ``integrate_warped_cuda``, and the raycast marches through
``raycast_vertices_cuda``; these are the routes of
``pipelines/kinfu.py``'s exact mode. On CPU tensors the same wrappers run
their plain twins. A keyword that no kernel implements raises on CUDA
tensors; it never runs a twin on the card.

Unlike the JAX functions, ``integrate`` updates the volume's tensors IN
PLACE and returns the volume: at 512^3 a functional update would copy
1 GiB per frame.
"""

from __future__ import annotations

import torch

from .camera import Camera
from .kernels.integrate import (
    integrate_color_cuda,
    integrate_cuda,
    integrate_warped_cuda,
)
from .kernels.raycast import raycast_vertices_cuda
from .ops.raycast import (
    REFERENCE_MAX_STEPS,
    compute_normals_from_vertices,
    raycast_vertices,
    vertices_to_depth_image,
)
from .volume import TSDFVolume

_KERNEL_MODE = "sphere"
_KERNEL_STEP_SCALE = 0.75


def _image(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A frame as a contiguous tensor of ``dtype``: an array that is not
    a tensor goes to ``device``; a tensor stays where it is (the wrapper
    raises if that is not the volume's device)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=device)
    return a.to(dtype).contiguous()


def integrate(
    vol: TSDFVolume,
    depth,
    camera: Camera,
    cap_weight: bool = False,
    rgb=None,
) -> TSDFVolume:
    """Fuse one depth frame (and with ``rgb`` its colour) into ``vol``, in
    place; returns ``vol``.

    Args:
      vol: the volume; a volume with a deformation field fuses at its
        deformed centres.
      depth: (H, W) depth in mm, any numeric dtype; zero means no data.
      camera: the frame's camera, on the volume's device.
      cap_weight: clamp the accumulated weight at vol.max_weight.
      rgb: optional (H, W, 3) uint8 colour frame; needs ``vol.color``.
    """
    dev = vol.device
    depth = _image(depth, dev, torch.float32)
    if rgb is not None:
        rgb = _image(rgb, dev, torch.uint8)
    if vol.deform is not None:
        return integrate_warped_cuda(
            vol, depth, camera, cap_weight=cap_weight, rgb=rgb
        )
    if rgb is not None:
        vol, _miss = integrate_color_cuda(
            vol, depth, rgb, camera, cap_weight=cap_weight, mode="exact"
        )
        return vol
    return integrate_cuda(vol, depth, camera, cap_weight=cap_weight)


def _vertices(vol, camera, width, height, mode, max_steps, step_scale,
              row0=0):
    """The march: the kernel's wrapper for the kernel's keywords, the
    plain march for any other on CPU tensors; on CUDA tensors any other
    raises. ``row0``: the image row of the first of ``height`` rows."""
    kernel_keywords = mode == _KERNEL_MODE and step_scale == _KERNEL_STEP_SCALE
    if kernel_keywords:
        return raycast_vertices_cuda(
            vol, camera, width, height, max_steps=max_steps, row0=row0
        )
    if vol.device.type == "cuda":
        raise ValueError(
            f"raycast(mode={mode!r}, step_scale={step_scale!r}) on CUDA "
            f"tensors: the raycast kernel marches mode={_KERNEL_MODE!r} at "
            f"step_scale={_KERNEL_STEP_SCALE} only (ROADMAP.md, \"Not "
            "queued: a fixed-step raycast kernel\"); run these keywords on "
            "CPU tensors, through the plain march"
        )
    return raycast_vertices(
        vol, camera, width, height,
        mode=mode, max_steps=max_steps, step_scale=step_scale, row0=row0,
    )


def raycast(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raycast ``vol`` from ``camera``: (vertices, normals), both (H, W, 3)
    float32; vertices NaN on a miss, normals zero on the last row and
    column and where the stencil touches a miss."""
    verts = _vertices(vol, camera, width, height, mode, max_steps, step_scale)
    return verts, compute_normals_from_vertices(verts)


def render_to_depth_image(
    vol: TSDFVolume,
    camera: Camera,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
) -> torch.Tensor:
    """(H, W) u16 depth image in mm (camera z) of ``vol`` seen from
    ``camera``, 0 on a miss."""
    verts = _vertices(vol, camera, width, height, mode, max_steps, step_scale)
    return vertices_to_depth_image(verts, camera)
