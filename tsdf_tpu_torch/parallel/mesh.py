"""The ("b", "r") mesh over the ranks of a ``torch.distributed`` group.

Port of ``tsdf_tpu/parallel/mesh.py``. One process per rank; rank
``b * n_rays + r`` of the mesh holds brick ``b`` (the z-slab ``b`` of the
volume) and row tile ``r`` of the image, as a device does in the JAX mesh.
The two axis groups are made here with ``dist.new_group`` (a CUDA
``DeviceMesh`` may make its axis groups with NCCL whatever the world's
backend is, and several ranks that share one card need gloo), and
``Mesh.get_group`` is the only way the ops reach an axis.

The collectives below (``all_reduce``, ``all_gather``, ``gather``) are the
ones the ops use. Under gloo a CUDA tensor is staged through the host here,
as gloo does inside for the collectives it supports on CUDA, so that every
one of them works on either backend; the gathers move bytes, so any dtype
goes (bfloat16 included).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

AXES = ("b", "r")
# a rank that waits on a collective nobody joins fails after this long
GROUP_TIMEOUT = timedelta(seconds=60)


class Mesh:
    """A (n_bricks, n_rays) grid of ranks with axes "b" and "r".

    Attributes:
      shape: {"b": n_bricks, "r": n_rays}, as ``jax.sharding.Mesh.shape``.
      ranks: the mesh's global ranks, row-major over (b, r).
      device: where this rank keeps its slab and its images.
    """

    def __init__(self, n_bricks: int, n_rays: int, ranks: Sequence[int],
                 device: torch.device):
        if n_bricks < 1 or n_rays < 1 or len(ranks) != n_bricks * n_rays:
            raise ValueError(
                f"a {n_bricks}x{n_rays} mesh needs {n_bricks * n_rays} ranks, "
                f"got {len(ranks)}")
        self.shape = {"b": n_bricks, "r": n_rays}
        self.ranks = list(ranks)
        self.device = torch.device(device)
        me = dist.get_rank()
        grid = [self.ranks[b * n_rays:(b + 1) * n_rays] for b in range(n_bricks)]
        # every process makes every group, in the same order
        groups = {}
        for r in range(n_rays):
            members = [row[r] for row in grid]
            g = dist.new_group(members, timeout=GROUP_TIMEOUT)
            if me in members:
                groups["b"] = g
        for row in grid:
            g = dist.new_group(row, timeout=GROUP_TIMEOUT)
            if me in row:
                groups["r"] = g
        g = dist.new_group(self.ranks, timeout=GROUP_TIMEOUT)
        groups[AXES] = g
        self._groups = groups if me in self.ranks else {}
        i = self.ranks.index(me) if me in self.ranks else None
        self._coordinate = None if i is None else (i // n_rays, i % n_rays)

    @property
    def size(self) -> int:
        return self.shape["b"] * self.shape["r"]

    def get_coordinate(self) -> tuple[int, int]:
        """This rank's (b, r)."""
        if self._coordinate is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
        return self._coordinate

    def get_group(self, axis="b"):
        """The process group of this rank's axis: "b" (the ranks of its
        row tile, one a slab), "r" (the ranks of its slab, one a row tile)
        or ("b", "r") (the whole mesh)."""
        self.get_coordinate()
        return self._groups[tuple(axis) if not isinstance(axis, str) else axis]

    def __repr__(self) -> str:
        return (f"Mesh(b={self.shape['b']}, r={self.shape['r']}, "
                f"device={self.device})")


def _default_device() -> torch.device:
    """This process's current card; with none visible, an error (the CPU is
    taken only when asked for)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA card is visible; pass device='cpu' to keep "
            "this rank's tensors on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(
    n_bricks: Optional[int] = None,
    n_rays: int = 1,
    devices=None,
    *,
    device=None,
) -> Mesh:
    """Build a ("b", "r") mesh over the ranks of the process group.

    ``devices``: the global ranks to use (default all of them); the first
    ``n_bricks * n_rays`` form the mesh, row-major. ``n_bricks`` defaults
    to all of them over ``n_rays``. Every rank of the process group calls
    this, in the same order as its other collective calls. ``device`` is
    where this rank's tensors live: by default its current card, and with
    no card visible an error unless ``device="cpu"`` is given. With no
    process group a one-rank group is made here (gloo).
    """
    device = _default_device() if device is None else device
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.HashStore(), rank=0, world_size=1,
            timeout=GROUP_TIMEOUT)
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if n_bricks is None:
        n_bricks = len(ranks) // n_rays
    if n_bricks * n_rays > len(ranks):
        raise ValueError(
            f"a {n_bricks}x{n_rays} mesh needs {n_bricks * n_rays} ranks; "
            f"the group has {len(ranks)}")
    return Mesh(n_bricks, n_rays, ranks[:n_bricks * n_rays], device)


def volume_sharding(mesh: Mesh):
    """Placements of a (Z, Y, X[, C]) volume array over the mesh: z-slabs
    over "b", replicated over "r" (JAX ``P("b")``)."""
    del mesh
    return (Shard(0), Replicate())


def replicated(mesh: Mesh):
    """Placements of an array every rank holds whole (JAX ``P()``)."""
    del mesh
    return (Replicate(), Replicate())


def volume_pspecs(vol) -> dict:
    """The placements of each field of a volume: the dense arrays z-sharded
    over "b", the metadata replicated, None for an absent field."""
    dense = ("tsdf", "weight", "color", "deform", "deform_rot")
    meta = ("physical_size", "offset", "truncation_distance", "max_weight",
            "global_rotation", "global_translation")
    out = {}
    for name in dense + meta:
        if getattr(vol, name) is None:
            out[name] = None
        else:
            out[name] = (Shard(0), Replicate()) if name in dense else (
                Replicate(), Replicate())
    return out


# -- the collectives of the ops -------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor under gloo goes through the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op``: a ``dist.ReduceOp``);
    returns ``t``."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` of ``group``, in group order, on ``t``'s device
    (all the same shape and dtype)."""
    n = dist.get_world_size(group)
    data = _as_bytes(t)
    staged = _staged(t, group)
    if staged:
        data = data.cpu()
    parts = [torch.empty_like(data) for _ in range(n)]
    dist.all_gather(parts, data, group=group)
    return [p.to(t.device).view(t.dtype).reshape(t.shape) for p in parts]


def gather(t: torch.Tensor, dst: int, group) -> Optional[list[torch.Tensor]]:
    """Every rank's ``t`` of ``group`` on the global rank ``dst`` (a list
    in group order), None on the others."""
    n = dist.get_world_size(group)
    data = _as_bytes(t)
    if _staged(t, group):
        data = data.cpu()
    parts = None
    if dist.get_rank() == dst:
        parts = [torch.empty_like(data) for _ in range(n)]
    dist.gather(data, gather_list=parts, dst=dst, group=group)
    if parts is None:
        return None
    return [p.to(t.device).view(t.dtype).reshape(t.shape) for p in parts]
