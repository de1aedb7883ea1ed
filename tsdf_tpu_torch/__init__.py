"""tsdf_tpu_torch: the PyTorch/CUDA port of tsdf_tpu.

KinectFusion on one NVIDIA Hopper card: the GT-pose path (fuse -> render
-> mesh), the tracked loop (bilateral filter -> model raycast -> ICP ->
gated integrate) and non-rigid SceneFusion (masked surface -> scene-flow
correspondences -> deformation update -> integrate at the deformed
centres), with hand-written CUDA kernels for integration (rigid, colour,
fast, warped), raycasting, the gathers (lane, row, windowed) and the
bilateral filter (``kernels/``, sources in ``csrc/``) and their plain
PyTorch twins (``ops/``), which run on the CPU. The layout mirrors
``tsdf_tpu``; that JAX package is the reference the port is tested
against. This package imports neither JAX nor ``tsdf_tpu``.

The names below are ``tsdf_tpu``'s: ``integrate``, ``raycast`` and
``render_to_depth_image`` launch their kernels on CUDA tensors and run
the plain twins on CPU tensors (``api.py``); ``integrate`` fuses in
place. ``trilinear_sample``, ``scene_image``, ``normals_image`` and
``compute_normals`` are plain PyTorch on either device, as they are
plain XLA in the JAX package.
"""

from .camera import Camera
from .volume import TSDFVolume, make_volume
from .api import integrate, raycast, render_to_depth_image
from .ops import (
    trilinear_sample,
    scene_image,
    normals_image,
    compute_normals,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "TSDFVolume",
    "make_volume",
    "integrate",
    "raycast",
    "render_to_depth_image",
    "trilinear_sample",
    "scene_image",
    "normals_image",
    "compute_normals",
]
