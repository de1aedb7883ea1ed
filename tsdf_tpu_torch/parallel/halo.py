"""Halo exchange for z-slab volumes.

Port of ``tsdf_tpu/parallel/halo.py``. Each slab receives its neighbours'
edge planes, so that the trilinear stencil of a march across its faces
reads the planes on the other side. The JAX package permutes the planes
between neighbours; here one ``all_gather`` over "b" of each slab's two
edge planes (2 x halo planes a rank) does it, a collective that gloo and
NCCL both run.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_gather


def halo_exchange_z(x: torch.Tensor, mesh: Mesh, halo: int = 1) -> torch.Tensor:
    """This rank's slab with its neighbours' edge planes around it.

    Args:
      x: (Zl, Y, X) this rank's z-slab of a volume sharded over "b".
      halo: planes to take from each neighbour.

    Returns (Zl + 2 * halo, Y, X): [halo from the slab below | x | halo
    from the slab above]; the first and last slabs' outer halos repeat
    their own edge planes (the clamp to the border of ``ops/trilinear.py``).
    """
    if not 0 < halo <= x.shape[0]:
        raise ValueError(f"halo {halo} for a slab of {x.shape[0]} planes")
    nb = mesh.shape["b"]
    b, _ = mesh.get_coordinate()
    edges = all_gather(
        torch.cat([x[:halo], x[-halo:]]).contiguous(), mesh.get_group("b"))
    below = edges[b - 1][halo:] if b > 0 else x[:halo]
    above = edges[b + 1][:halo] if b < nb - 1 else x[-halo:]
    return torch.cat([below, x, above])
