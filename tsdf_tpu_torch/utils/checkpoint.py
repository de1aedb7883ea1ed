"""Checkpoint and resume of a volume on one card.

Port of ``tsdf_tpu/utils/checkpoint.py``. The JAX module writes an orbax
checkpoint, each host its own shards; here one card holds the whole
volume, so ``save_sharded`` writes one ``torch.save`` file into the
directory ``path``: a plain dict of the volume's tensors (and a format
number), no pickled class, so that ``load_sharded`` reads it with
``torch.load(weights_only=True)``. The optional colour and deformation
fields go with it when the volume has them.

Each tensor keeps its dtype: a bfloat16 volume (``TSDFVolume.astype``)
is saved and restored in bfloat16, and ``load_sharded`` refuses a
checkpoint whose dtypes differ from ``like``'s. Not yet here: the sharded
layout across cards comes with ROADMAP.md Queue 1 item 6 (multi-GPU).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..volume import TSDFVolume

FORMAT = 1
_FILE = "volume.pt"


def save_sharded(vol: TSDFVolume, path: str) -> None:
    """Write ``vol`` into the directory ``path`` (made if need be; a
    checkpoint already there is replaced)."""
    os.makedirs(path, exist_ok=True)
    state = {"format": FORMAT}
    for f in dataclasses.fields(vol):
        value = getattr(vol, f.name)
        if value is not None:
            state[f.name] = value.detach()
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def load_sharded(path: str, like: TSDFVolume) -> TSDFVolume:
    """Restore the checkpoint in ``path`` onto ``like``'s device.

    ``like`` gives the structure: each field must be present in the
    checkpoint exactly where it is present in ``like``, with ``like``'s
    shape and dtype; a mismatch raises ValueError.
    """
    state = torch.load(
        os.path.join(path, _FILE), map_location=like.device, weights_only=True
    )
    if state.pop("format", None) != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of format {FORMAT}")
    fields = {}
    for f in dataclasses.fields(like):
        want = getattr(like, f.name)
        got = state.pop(f.name, None)
        if (want is None) != (got is None):
            where = "like" if got is None else "the checkpoint"
            raise ValueError(f"{path}: field {f.name} is only in {where}")
        if want is not None and (
            got.shape != want.shape or got.dtype != want.dtype
        ):
            raise ValueError(
                f"{path}: field {f.name} is {tuple(got.shape)} {got.dtype}, "
                f"like has {tuple(want.shape)} {want.dtype}"
            )
        fields[f.name] = got
    if state:
        raise ValueError(f"{path}: unknown fields {sorted(state)}")
    return TSDFVolume(**fields)
