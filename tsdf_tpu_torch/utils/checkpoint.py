"""Checkpoint and resume of a volume, whole or in z-slabs over a mesh.

Port of ``tsdf_tpu/utils/checkpoint.py``, whose orbax checkpoint has each
host write its own shards and restores them onto ``like``'s sharding,
another mesh factorization included. Here a checkpoint is a directory:

  * ``slab_ZZZZZZ.pt``, one file a slab of planes, named by its first
    plane: a plain dict of the slab's dense fields (tsdf, weight, and
    colour and deformation where the volume has them), each in its own
    dtype (bfloat16 storage stays bfloat16), written by ``torch.save``.
    No pickled class: ``torch.load(weights_only=True)`` reads it, and
    ``mmap=True`` maps it, so a rank reads only the planes it takes;
  * ``manifest.json``, written last: the format number, the whole
    volume's shape (Z first), each field's dtype and per-plane shape, the
    metadata (physical size, offset, truncation, max weight, global pose)
    and each slab file with its first plane ``z0`` and its plane count.
    A directory without it is an incomplete checkpoint, which
    ``load_sharded`` refuses.

A whole volume is the case of one slab (``z0 = 0``, every plane), so one
layout serves both: a single card's checkpoint restores onto a mesh and a
mesh's onto a single card, as orbax allows.

On a mesh, ``save_sharded`` is collective: each rank of row tile
``r == 0`` writes its own slab (never the gathered volume) to a temp name
and renames it, and the mesh's first rank writes the manifest after a
barrier, then removes the files of an earlier checkpoint there.
``load_sharded`` reads no collective: each rank takes its planes
``[like.z0, like.z0 + n)`` from the slab files that overlap them.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..volume import SlabVolume, TSDFVolume

FORMAT = 2
MANIFEST = "manifest.json"
_META = ("physical_size", "offset", "truncation_distance", "max_weight",
         "global_rotation", "global_translation")
_DENSE = tuple(f.name for f in dataclasses.fields(TSDFVolume)
               if f.name not in _META)


def _slab_file(z0: int) -> str:
    return f"slab_{z0:06d}.pt"


def _placement(vol: TSDFVolume, mesh) -> tuple[int, int, int]:
    """(first plane, planes, whole volume's planes) of ``vol``; a slab
    must be this rank's share of ``mesh``."""
    if isinstance(vol, SlabVolume):
        if mesh is None:
            raise ValueError("a SlabVolume is checkpointed with its mesh=")
        from ..parallel.ops import _check_slab

        _check_slab(vol, mesh)
        return vol.z0, vol.tsdf.shape[0], vol.full_z
    if mesh is not None:
        raise ValueError("mesh= is given with a whole volume; pass its slab")
    z = vol.tsdf.shape[0]
    return 0, z, z


def _barrier(mesh) -> None:
    """Every rank of the mesh has reached this point (an all-reduce of one
    number on the mesh's device, on either backend)."""
    import torch.distributed as dist

    from ..parallel.mesh import AXES, all_reduce

    all_reduce(torch.zeros(1, device=mesh.device), dist.ReduceOp.SUM,
               mesh.get_group(AXES))


def _replace_atomically(path: str, write) -> None:
    """``write(tmp)`` then rename ``tmp`` to ``path``: a reader sees the
    old file or the whole new one."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host in a storage of its own: ``torch.save`` writes a
    view's whole storage."""
    t = t.detach().to("cpu").contiguous()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def _manifest(vol: TSDFVolume, full_z: int, slabs) -> dict:
    fields = {}
    for name in _DENSE:
        t = getattr(vol, name)
        if t is not None:
            fields[name] = {"dtype": str(t.dtype).removeprefix("torch."),
                            "plane_shape": list(t.shape[1:])}
    meta = {}
    for name in _META:
        t = getattr(vol, name).detach().cpu()
        # a float32 value is a double exactly, and JSON keeps a double
        meta[name] = {"dtype": str(t.dtype).removeprefix("torch."),
                      "shape": list(t.shape), "values": t.reshape(-1).tolist()}
    return {"format": FORMAT, "full_z": full_z,
            "shape": [full_z, *vol.tsdf.shape[1:]], "fields": fields,
            "metadata": meta,
            "slabs": [{"file": _slab_file(z0), "z0": z0, "planes": n}
                      for z0, n in slabs]}


def save_sharded(vol: TSDFVolume, path: str, *, mesh=None) -> None:
    """Write ``vol`` into the directory ``path`` (made if need be; a
    checkpoint already there is replaced).

    ``vol`` is a whole volume, or this rank's slab of ``mesh`` (given
    then, and every rank of the mesh calls this: it holds barriers).
    """
    z0, n, full_z = _placement(vol, mesh)
    if mesh is None:
        first, writes = True, True
        slabs = [(0, full_z)]
    else:
        import torch.distributed as dist

        first = dist.get_rank() == mesh.ranks[0]
        writes = mesh.get_coordinate()[1] == 0
        slabs = [(b * n, n) for b in range(mesh.shape["b"])]
    manifest = os.path.join(path, MANIFEST)
    if first:
        os.makedirs(path, exist_ok=True)
        # from here until the new manifest the directory is incomplete
        if os.path.exists(manifest):
            os.remove(manifest)
    if mesh is not None:
        _barrier(mesh)
    if writes:
        state = {f: _own(getattr(vol, f)) for f in _DENSE
                 if getattr(vol, f) is not None}
        _replace_atomically(os.path.join(path, _slab_file(z0)),
                            lambda tmp: torch.save(state, tmp))
        del state
    if mesh is not None:
        _barrier(mesh)
    if first:
        body = json.dumps(_manifest(vol, full_z, slabs), indent=1)

        def write(tmp):
            with open(tmp, "w") as f:
                f.write(body)

        _replace_atomically(manifest, write)
        keep = {MANIFEST} | {_slab_file(z) for z, _ in slabs}
        for name in os.listdir(path):
            if name not in keep and name.startswith("slab_"):
                os.remove(os.path.join(path, name))
    if mesh is not None:
        _barrier(mesh)


def _read_manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise ValueError(
            f"{path}: no {MANIFEST}: not a checkpoint, or an incomplete one"
        ) from None
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of format {FORMAT}")
    return manifest


def _check_fields(path: str, manifest: dict, like: TSDFVolume,
                  full_z: int) -> None:
    """Each dense field present in the checkpoint exactly where it is in
    ``like``, with ``like``'s per-plane shape and dtype, and the same whole
    Z; else ValueError naming the field."""
    saved = manifest["fields"]
    if manifest["full_z"] != full_z:
        raise ValueError(
            f"{path}: a volume of {manifest['full_z']} planes; like has "
            f"{full_z}")
    for name in _DENSE:
        want, got = getattr(like, name), saved.get(name)
        if (want is None) != (got is None):
            where = "like" if got is None else "the checkpoint"
            raise ValueError(f"{path}: field {name} is only in {where}")
        if want is None:
            continue
        shape, dtype = list(want.shape[1:]), str(want.dtype).removeprefix("torch.")
        if got["plane_shape"] != shape or got["dtype"] != dtype:
            raise ValueError(
                f"{path}: field {name} has planes {tuple(got['plane_shape'])} "
                f"{got['dtype']}, like has {tuple(shape)} {dtype}")
    unknown = sorted(set(saved) - set(_DENSE))
    if unknown:
        raise ValueError(f"{path}: unknown fields {unknown}")


def load_sharded(path: str, like: TSDFVolume, *, mesh=None) -> TSDFVolume:
    """Restore the checkpoint in ``path`` onto ``like``'s placement.

    ``like`` gives the structure and where the result lives: a whole
    volume, or this rank's slab of ``mesh`` (given then), on its device.
    The checkpoint may have been saved whole or on any mesh whose "b" axis
    divides the same Z. Each dense field must be present exactly where it
    is in ``like``, with its per-plane shape and dtype and the same whole
    Z; a mismatch, or a directory without a manifest, raises ValueError.
    The metadata is the checkpoint's.
    """
    z0, n, full_z = _placement(like, mesh)
    manifest = _read_manifest(path)
    _check_fields(path, manifest, like, full_z)
    names = [f for f in _DENSE if getattr(like, f) is not None]
    parts = {f: [] for f in names}
    covered = 0
    for slab in manifest["slabs"]:
        lo = max(z0, slab["z0"])
        hi = min(z0 + n, slab["z0"] + slab["planes"])
        if lo >= hi:
            continue
        state = torch.load(os.path.join(path, slab["file"]),
                           map_location="cpu", weights_only=True, mmap=True)
        for f in names:
            parts[f].append(state[f][lo - slab["z0"]:hi - slab["z0"]])
        covered += hi - lo
        del state
    if covered != n:
        raise ValueError(
            f"{path}: the slab files cover {covered} of planes {z0}.."
            f"{z0 + n - 1}")
    dev = like.device
    fields = {f: None for f in _DENSE}
    for f in names:
        # torch.cat copies: nothing of the mapped files is kept
        fields[f] = torch.cat(parts[f]).to(dev)
    for name, m in manifest["metadata"].items():
        fields[name] = torch.tensor(
            m["values"], dtype=getattr(torch, m["dtype"]), device=dev
        ).reshape(m["shape"])
    if isinstance(like, SlabVolume):
        return SlabVolume(**fields, z0=like.z0, full_z=like.full_z)
    return TSDFVolume(**fields)
