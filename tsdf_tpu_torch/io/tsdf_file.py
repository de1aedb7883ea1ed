"""Binary .tsdf checkpoint format, byte-compatible with the reference.

Port of ``tsdf_tpu/io/tsdf_file.py``; the two writers give the same bytes.

  header (68 bytes):
    dim3   size                 3 x u32   (x, y, z)
    float3 physical_size        3 x f32   mm
    float3 offset               3 x f32   mm
    float  truncation_distance  f32
    float  max_weight           f32
    float3 global_translation   3 x f32
    float3 global_rotation      3 x f32
  body:
    distances    f32 [x + y*sx + z*sx*sy]   (x fastest: the flatten order)
    weights      f32 [same]

A bfloat16 volume is saved widened to float32, as the JAX writer does (the
file is always float32), and every load gives a float32 volume.
    colours      u8  [n*3]
    deformation  f32 [n*6]  ({translation xyz, rotation xyz} per voxel)
"""

from __future__ import annotations

import numpy as np
import torch

from ..volume import TSDFVolume

HEADER_BYTES = 68

# z-slices written per block of the deformation field, so a 512^3 save
# holds one slab of it on the host, not the whole 3 GiB block.
_SLAB = 32


def _np(t):
    """A tensor as numpy; bf16 (which numpy lacks) widened to f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_tsdf(vol: TSDFVolume, path: str) -> None:
    sx, sy, sz = vol.size
    n = sx * sy * sz
    with open(path, "wb") as f:
        np.asarray([sx, sy, sz], dtype=np.uint32).tofile(f)
        _np(vol.physical_size).astype(np.float32).tofile(f)
        _np(vol.offset).astype(np.float32).tofile(f)
        np.asarray(
            [float(vol.truncation_distance), float(vol.max_weight)],
            dtype=np.float32,
        ).tofile(f)
        _np(vol.global_translation).astype(np.float32).tofile(f)
        _np(vol.global_rotation).astype(np.float32).tofile(f)

        _np(vol.tsdf).astype(np.float32).ravel().tofile(f)
        _np(vol.weight).astype(np.float32).ravel().tofile(f)

        if vol.color is not None:
            _np(vol.color).astype(np.uint8).ravel().tofile(f)
        else:
            np.zeros(n * 3, dtype=np.uint8).tofile(f)

        # translations: the deformed centres, or the undeformed ones
        cz, cy, cx = (_np(c) for c in vol.axis_centres())
        for z0 in range(0, sz, _SLAB):
            z1 = min(z0 + _SLAB, sz)
            block = np.zeros((z1 - z0, sy, sx, 6), np.float32)
            if vol.deform is not None:
                block[..., 0:3] = _np(vol.deform[z0:z1])
            else:
                block[..., 0] = cx[None, None, :]
                block[..., 1] = cy[None, :, None]
                block[..., 2] = cz[z0:z1, None, None]
            if vol.deform_rot is not None:
                block[..., 3:6] = _np(vol.deform_rot[z0:z1])
            block.tofile(f)


def load_tsdf(path: str, *, device) -> TSDFVolume:
    """Load a .tsdf onto ``device``. A deformation block equal to the
    undeformed voxel centres with zero rotations (what every rigid save
    writes) is dropped; any other is kept in ``deform``/``deform_rot``."""
    with open(path, "rb") as f:
        size = np.fromfile(f, dtype=np.uint32, count=3)
        sx, sy, sz = (int(v) for v in size)
        physical_size = np.fromfile(f, dtype=np.float32, count=3)
        offset = np.fromfile(f, dtype=np.float32, count=3)
        trunc, max_weight = np.fromfile(f, dtype=np.float32, count=2)
        global_translation = np.fromfile(f, dtype=np.float32, count=3)
        global_rotation = np.fromfile(f, dtype=np.float32, count=3)

        n = sx * sy * sz
        distances = np.fromfile(f, dtype=np.float32, count=n)
        weights = np.fromfile(f, dtype=np.float32, count=n)
        colours = np.fromfile(f, dtype=np.uint8, count=n * 3)
        deform = np.fromfile(f, dtype=np.float32, count=n * 6)

    if distances.size != n or weights.size != n:
        raise ValueError(f"truncated .tsdf file: {path}")

    shape = (sz, sy, sx)
    vol = TSDFVolume.from_numpy(
        tsdf=distances.reshape(shape),
        weight=weights.reshape(shape),
        physical_size=physical_size,
        offset=offset,
        truncation_distance=trunc,
        max_weight=max_weight,
        global_rotation=global_rotation,
        global_translation=global_translation,
        color=colours.reshape(shape + (3,)) if colours.size == n * 3 else None,
        device=device,
    )
    if deform.size == n * 6:
        d = deform.reshape(shape + (6,))
        cz, cy, cx = (_np(c) for c in vol.axis_centres())
        identity = (
            np.allclose(d[..., 0], cx[None, None, :], atol=1e-3)
            and np.allclose(d[..., 1], cy[None, :, None], atol=1e-3)
            and np.allclose(d[..., 2], cz[:, None, None], atol=1e-3)
            and not d[..., 3:6].any()
        )
        if not identity:
            vol = vol.replace(
                deform=vol.tsdf.new_tensor(d[..., 0:3]),
                deform_rot=vol.tsdf.new_tensor(d[..., 3:6]),
            )
    return vol
