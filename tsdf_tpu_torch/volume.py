"""The TSDF volume as a dataclass of PyTorch tensors.

Port of ``tsdf_tpu/volume.py``. Layout and units are the reference's:

* dense arrays are indexed ``[z, y, x]`` with x fastest, so
  ``tsdf.flatten()`` order is the reference's linear voxel index
  ``x + y*size_x + z*size_x*size_y`` and serialized bytes compare 1:1;
* distances, physical size, offset and truncation are millimetres.

Unlike the JAX pytree, the tensors here may be updated in place: the
CUDA integrate kernels write ``tsdf``/``weight`` (and ``color``) directly
(see ``kernels/integrate.py``). ``tsdf`` and ``weight`` are stored in
float32 or bfloat16 (``make_volume(dtype=)``, :meth:`TSDFVolume.astype`):
every path reads the storage, computes in float32 and rounds once when it
stores. The other fields are always float32 (``color`` uint8).

``color`` is the fused per-voxel RGB, (Z, Y, X, 3) uint8 interleaved as in
the ``.tsdf`` file; colour fusion needs it (``with_color()``). ``deform``
is the non-rigid SceneFusion state: the *deformed world-space centre* of
every voxel (``with_identity_deformation()`` starts it at the voxel
centres). A volume that has one is integrated at those centres
(``ops.integrate.integrate``, ``kernels.integrate.integrate_warped_cuda``)
and warps points through it (``ops.deform.deform_points``). ``deform_rot``
is carried for the ``.tsdf`` file format only; nothing reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DEFAULT_MAX_WEIGHT = 15.0

_F32 = torch.float32
# the storage types of tsdf and weight
STORAGE_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class TSDFVolume:
    """Truncated signed distance volume + integration weights.

    Attributes:
      tsdf: (Z, Y, X) f32 or bf16, truncated signed distance in mm.
      weight: (Z, Y, X), tsdf's dtype, accumulated integration weight.
      physical_size: (3,) f32, (px, py, pz) mm extent of the grid.
      offset: (3,) f32, world coordinate of the grid's minimal corner.
      truncation_distance: () f32, 1.1 * ||voxel_size|| by default.
      max_weight: () f32.
      global_rotation / global_translation: (3,) f32 whole-field pose.
      color: (Z, Y, X, 3) u8 fused colour, or None.
      deform: (Z, Y, X, 3) f32 or None: the deformed world-space centre
        of each voxel, components (x, y, z).
      deform_rot: (Z, Y, X, 3) f32 or None: per-node Euler rotations,
        file-format state only.
    """

    tsdf: torch.Tensor
    weight: torch.Tensor
    physical_size: torch.Tensor
    offset: torch.Tensor
    truncation_distance: torch.Tensor
    max_weight: torch.Tensor
    global_rotation: torch.Tensor
    global_translation: torch.Tensor
    color: Optional[torch.Tensor] = None
    deform: Optional[torch.Tensor] = None
    deform_rot: Optional[torch.Tensor] = None

    def replace(self, **updates) -> "TSDFVolume":
        return dataclasses.replace(self, **updates)

    @property
    def device(self) -> torch.device:
        return self.tsdf.device

    @property
    def size(self) -> tuple[int, int, int]:
        """(size_x, size_y, size_z) in voxels."""
        z, y, x = self.tsdf.shape
        return (x, y, z)

    @property
    def voxel_size(self) -> torch.Tensor:
        """(3,) mm per voxel: physical_size / size. Divided by Python
        ints: a tensor of the sizes made on a card would be a blocking
        host-to-device copy, one per frame in the fuse loop."""
        ps = self.physical_size
        return torch.stack([ps[a] / n for a, n in enumerate(self.size)])

    @property
    def space_min(self) -> torch.Tensor:
        return self.offset

    @property
    def space_max(self) -> torch.Tensor:
        return self.offset + self.physical_size

    def axis_centres(self):
        """Per-axis voxel-centre vectors (z, y, x):
        centre = (idx + 0.5) * voxel_size + offset."""
        sz, sy, sx = self.tsdf.shape
        vs = self.voxel_size
        dev = self.device
        cz = (torch.arange(sz, dtype=_F32, device=dev) + 0.5) * vs[2]
        cy = (torch.arange(sy, dtype=_F32, device=dev) + 0.5) * vs[1]
        cx = (torch.arange(sx, dtype=_F32, device=dev) + 0.5) * vs[0]
        return cz + self.offset[2], cy + self.offset[1], cx + self.offset[0]

    def voxel_centres(self) -> torch.Tensor:
        """(Z, Y, X, 3) world-space voxel centres, components (x, y, z)."""
        cz, cy, cx = self.axis_centres()
        sz, sy, sx = self.tsdf.shape
        return torch.stack(
            [
                cx[None, None, :].expand(sz, sy, sx),
                cy[None, :, None].expand(sz, sy, sx),
                cz[:, None, None].expand(sz, sy, sx),
            ],
            dim=-1,
        )

    def deformed_centres(self) -> torch.Tensor:
        """(Z, Y, X, 3) deformed voxel centres: ``deform`` itself, the
        voxel centres for a rigid volume."""
        if self.deform is None:
            return self.voxel_centres()
        return self.deform

    # -- mutation as replacement --------------------------------------------

    def clear(self) -> "TSDFVolume":
        """A cleared copy: weights 0, distances +truncation_distance,
        colours 0, deformation at the identity."""
        return self.replace(
            tsdf=self.truncation_distance.to(self.tsdf.dtype)
            .expand(self.tsdf.shape).clone(),
            weight=torch.zeros_like(self.weight),
            color=None if self.color is None else torch.zeros_like(self.color),
            deform=(
                None if self.deform is None
                else self.voxel_centres().contiguous()
            ),
            deform_rot=(
                None
                if self.deform_rot is None
                else torch.zeros_like(self.deform_rot)
            ),
        )

    def with_identity_deformation(self) -> "TSDFVolume":
        """The same volume with its deformation field at the identity
        warp: every node at its voxel centre, rotations zero."""
        return self.replace(
            deform=self.voxel_centres().contiguous(),
            deform_rot=torch.zeros(
                tuple(self.tsdf.shape) + (3,), dtype=_F32, device=self.device
            ),
        )

    def with_color(self) -> "TSDFVolume":
        """The same volume with a zeroed colour field."""
        return self.replace(
            color=torch.zeros(
                tuple(self.tsdf.shape) + (3,),
                dtype=torch.uint8,
                device=self.device,
            )
        )

    def astype(self, dtype) -> "TSDFVolume":
        """Recast the dense tsdf/weight storage (e.g. torch.bfloat16 to
        halve the memory stream of every integrate/raycast; all compute
        paths read-cast to f32). bf16 weights count integer frames
        exactly up to 256 -- pair with ``cap_weight`` (the reference's
        max_weight is 15) for long sequences."""
        return self.replace(
            tsdf=self.tsdf.to(dtype), weight=self.weight.to(dtype)
        )

    # -- state carried across frameworks ---------------------------------

    @classmethod
    def from_numpy(
        cls,
        tsdf,
        weight,
        physical_size,
        offset,
        truncation_distance,
        max_weight=DEFAULT_MAX_WEIGHT,
        global_rotation=None,
        global_translation=None,
        color=None,
        deform=None,
        deform_rot=None,
        *,
        device,
    ) -> "TSDFVolume":
        """Build a volume from numpy arrays (e.g. the JAX volume's
        fields), copying each onto ``device``."""

        # torch.tensor copies: the volume never shares (or writes into)
        # the caller's arrays
        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        def opt(a, dtype):
            if a is None:
                return None
            return torch.tensor(np.asarray(a, dtype), device=device)

        zeros3 = np.zeros(3, np.float32)
        return cls(
            tsdf=f32(tsdf),
            weight=f32(weight),
            physical_size=f32(physical_size),
            offset=f32(offset),
            truncation_distance=f32(truncation_distance).reshape(()),
            max_weight=f32(max_weight).reshape(()),
            global_rotation=f32(
                zeros3 if global_rotation is None else global_rotation
            ),
            global_translation=f32(
                zeros3 if global_translation is None else global_translation
            ),
            color=opt(color, np.uint8),
            deform=opt(deform, np.float32),
            deform_rot=opt(deform_rot, np.float32),
        )

    def to_numpy(self) -> dict:
        """Every field as a numpy array (None stays None); the keyword
        arguments of :meth:`from_numpy`. numpy has no bfloat16: bf16
        storage comes back widened to float32, which is exact."""

        def arr(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        return {
            f.name: (
                None if getattr(self, f.name) is None
                else arr(getattr(self, f.name))
            )
            for f in dataclasses.fields(self)
        }


def make_volume(
    size: tuple[int, int, int],
    physical_size,
    offset=None,
    truncation_distance: float | None = None,
    max_weight: float = DEFAULT_MAX_WEIGHT,
    with_deformation: bool = False,
    with_color: bool = False,
    dtype=torch.float32,
    *,
    device,
) -> TSDFVolume:
    """Create a cleared volume on ``device``.

    Args:
      size: (size_x, size_y, size_z) voxels.
      physical_size: (3,) or scalar, mm.
      offset: world coords of the grid origin; defaults to centring the
        volume on x/y and starting z at 0 (the reference tools' usage).
      truncation_distance: defaults to 1.1 * ||voxel_size||.
      with_deformation: allocate the deformation field at the identity.
      with_color: allocate the (Z, Y, X, 3) uint8 colour field.
      dtype: the storage of tsdf and weight, torch.float32 or
        torch.bfloat16; every other field is float32 (colour uint8).
    """
    if dtype not in STORAGE_DTYPES:
        raise TypeError(
            f"volume storage must be float32 or bfloat16, got {dtype}")
    sx, sy, sz = size
    ps = torch.as_tensor(physical_size, dtype=_F32, device=device)
    ps = ps.expand(3).clone()
    if offset is None:
        off = torch.stack([-ps[0] / 2.0, -ps[1] / 2.0, torch.zeros_like(ps[0])])
    else:
        off = torch.as_tensor(offset, dtype=_F32, device=device).clone()
    voxel_size = ps / torch.tensor([sx, sy, sz], dtype=_F32, device=device)
    if truncation_distance is None:
        # an explicit sum of squares, summed in axis order like the
        # JAX norm of a 3-vector
        vv = voxel_size * voxel_size
        trunc = 1.1 * torch.sqrt(vv[0] + vv[1] + vv[2])
    else:
        trunc = torch.tensor(truncation_distance, dtype=_F32, device=device)
    vol = TSDFVolume(
        tsdf=trunc.to(dtype).expand(sz, sy, sx).clone(),
        weight=torch.zeros((sz, sy, sx), dtype=dtype, device=device),
        physical_size=ps,
        offset=off,
        truncation_distance=trunc,
        max_weight=torch.tensor(max_weight, dtype=_F32, device=device),
        global_rotation=torch.zeros(3, dtype=_F32, device=device),
        global_translation=torch.zeros(3, dtype=_F32, device=device),
    )
    if with_deformation:
        vol = vol.with_identity_deformation()
    return vol.with_color() if with_color else vol


def voxel_for_point(points, voxel_size) -> torch.Tensor:
    """(..., 3) grid-local points in mm -> (..., 3) int32 voxel indices:
    floor(points / voxel_size). Points that are not a tensor go to the
    device of a tensor ``voxel_size``."""
    dev = voxel_size.device if isinstance(voxel_size, torch.Tensor) else None
    points = torch.as_tensor(points, dtype=_F32, device=dev)
    return torch.floor(points / voxel_size).to(torch.int32)
