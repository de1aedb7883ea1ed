"""tsdf_tpu_torch: the PyTorch/CUDA port of tsdf_tpu.

The GT-pose KinectFusion path (fuse -> render -> mesh) on one NVIDIA
Hopper card, with hand-written CUDA kernels for rigid integration,
raycasting and the lane gather (``kernels/``, sources in ``csrc/``) and
their plain PyTorch twins (``ops/``), which run on the CPU. The layout
mirrors ``tsdf_tpu``; that JAX package is the reference the port is
tested against. This package imports neither JAX nor ``tsdf_tpu``.
"""

from .camera import Camera
from .volume import TSDFVolume, make_volume

__version__ = "0.1.0"

__all__ = ["Camera", "TSDFVolume", "make_volume"]
