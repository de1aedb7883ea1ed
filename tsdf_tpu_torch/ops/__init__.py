"""Plain PyTorch operations: the semantics and the kernels' twins.

The names below are the JAX package's ``tsdf_tpu.ops`` list, bound to
the plain functions here, whatever the device of their tensors; the
package root's ``integrate``, ``raycast`` and ``render_to_depth_image``
route CUDA tensors through the kernels instead. ``integrate`` and
``raycast`` shadow their submodules as attributes: reach a submodule
with ``from tsdf_tpu_torch.ops.raycast import ...``.
"""

from .integrate import integrate
from .raycast import raycast, render_to_depth_image
from .trilinear import trilinear_sample
from .shading import scene_image, normals_image, compute_normals
from .marching_cubes import extract_surface, soup_to_numpy, TriangleSoup
from .deform import deform_points

__all__ = [
    "integrate",
    "raycast",
    "render_to_depth_image",
    "trilinear_sample",
    "scene_image",
    "normals_image",
    "compute_normals",
    "extract_surface",
    "soup_to_numpy",
    "TriangleSoup",
    "deform_points",
]
