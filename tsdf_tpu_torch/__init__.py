"""tsdf_tpu_torch: the PyTorch/CUDA port of tsdf_tpu.

KinectFusion on one NVIDIA Hopper card: the GT-pose path (fuse -> render
-> mesh), the tracked loop (bilateral filter -> model raycast -> ICP ->
gated integrate) and non-rigid SceneFusion (masked surface -> scene-flow
correspondences -> deformation update -> integrate at the deformed
centres), with hand-written CUDA kernels for integration (rigid, colour,
fast, warped), raycasting, the gathers (lane, row, windowed) and the
bilateral filter (``kernels/``, sources in ``csrc/``) and their plain PyTorch twins (``ops/``), which run
on the CPU. The layout
mirrors ``tsdf_tpu``; that JAX package is the reference the port is
tested against. This package imports neither JAX nor ``tsdf_tpu``.
"""

from .camera import Camera
from .volume import TSDFVolume, make_volume

__version__ = "0.1.0"

__all__ = ["Camera", "TSDFVolume", "make_volume"]
