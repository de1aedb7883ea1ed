"""Sharded fusion on a ("b", "r") mesh of ranks: z-slab integrate, the two
sharded raycasts, the sharded ICP pyramid and tracked fusion, the sharded
surface, the sharded SceneFusion frame and the sharded pose gradient.

Port of ``tsdf_tpu/parallel/ops.py``. Every rank runs the single-card
kernels on its own share: its z-slab of the volume (a ``SlabVolume``) for
the integrates, the pose adjoint, the surface extraction and the
deformation update, and for the march of the bricked raycast; its row
tile of the image for the replicated raycast and for the ICP residuals.
The collectives are those of ``mesh.py`` (none an all-to-all):

  * integrate: none (each slab projects into the replicated frame); the
    miss count, when asked for, is one all-reduce over "b";
  * raycast_sharded_bricked: one all-gather over "b" of the slabs' edge
    planes (the halo), one over "b" of the tiles' vertices (the nearest hit
    wins), one over "r" of the tiles;
  * raycast_sharded: one all-gather over "b" of the slabs (the whole
    volume on every rank, by the caller's leave), one over the mesh of the
    row tiles;
  * ICP: one all-gather over the mesh of each iteration's 44 partial sums,
    added in rank order on every rank;
  * the surface: the halo, then one all-gather over "b" of the counts and
    one of each buffer's filled rows;
  * the deformation update: the halo, one all-gather over "b" of the
    sums that land on the next slab's first plane, one all-reduce of the
    correspondence count and the overflow flag;
  * the pose gradient: one all-gather over "b" of the forward's miss count
    and one of the backward's 12 float64 pose sums, added in rank order.

The TPU sweeps slabs through its raycast kernel, which is why the JAX
bricked raycast streams every brick through every device in six sweep
orders; the port's kernel sphere-traces from any point, so each rank
marches its own slab and the hits meet in one reduction.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

from ..api import _vertices
from ..camera import Camera
from ..kernels.bilateral import bilateral_filter_cuda
from ..kernels.integrate import MODES
from ..ops.marching_cubes import _extract
from ..ops.raycast import (
    REFERENCE_MAX_STEPS,
    compute_normals_from_vertices,
    vertices_to_camera_depth,
)
from ..pipelines.kinfu import integrate_frame
from ..tracking.icp import (
    ANGLE_THRESH,
    DIST_THRESH_MM,
    ICPResult,
    depth_pyramid,
    icp_step,
    icp_step_banded_planes,
    level_intrinsics,
    normal_map_planes,
    run_level,
    vertex_map_planes,
)
from ..utils.se3 import matmul_small
from ..volume import SlabVolume, TSDFVolume, make_volume
from .halo import halo_exchange_z
from .mesh import AXES, Mesh, all_gather, all_reduce, gather

_F32 = torch.float32
_DENSE = ("tsdf", "weight", "color", "deform", "deform_rot")


def _slab_planes(z: int, mesh: Mesh) -> int:
    nb = mesh.shape["b"]
    if z % nb:
        raise ValueError(f"Z={z} must divide the brick axis ({nb})")
    return z // nb


def shard_volume(vol: TSDFVolume, mesh: Mesh) -> SlabVolume:
    """This rank's z-slab of a whole volume (on any device), copied onto
    the mesh's device: tsdf, weight, and colour and deformation where the
    volume has them, with the whole volume's metadata and its first plane
    ``z0``. The volume's Z must divide the "b" axis."""
    if isinstance(vol, SlabVolume):
        raise ValueError("shard_volume takes a whole volume, not a slab")
    z = vol.tsdf.shape[0]
    n = _slab_planes(z, mesh)
    z0 = mesh.get_coordinate()[0] * n
    dev = mesh.device

    def cut(t):
        return None if t is None else t[z0:z0 + n].to(dev).contiguous().clone()

    fields = {f: cut(getattr(vol, f)) for f in _DENSE}
    return SlabVolume(
        **fields,
        **{f: getattr(vol, f).to(dev).clone() for f in (
            "physical_size", "offset", "truncation_distance", "max_weight",
            "global_rotation", "global_translation")},
        z0=z0, full_z=z,
    )


def make_sharded_volume(mesh: Mesh, size, physical_size, **kwargs) -> SlabVolume:
    """This rank's slab of a cleared volume, made without the whole one:
    ``volume.make_volume``'s arguments (its ``device`` is the mesh's), each
    rank allocating only its planes."""
    z = size[2]
    n = _slab_planes(z, mesh)
    return make_volume(size, physical_size, device=mesh.device,
                       slab=(mesh.get_coordinate()[0] * n, n), **kwargs)


def unshard_volume(vol: SlabVolume, mesh: Mesh) -> Optional[TSDFVolume]:
    """The whole volume on the mesh's first rank, gathered from the slabs of
    its row tile's ranks (one gather over "b" for each dense field); None
    on every other rank. Every rank calls it."""
    b, r = mesh.get_coordinate()
    dst = mesh.ranks[0]
    if r != 0:  # the slabs of the other row tiles are the same slabs
        return None
    group = mesh.get_group("b")
    whole = {}
    for f in _DENSE:
        t = getattr(vol, f)
        if t is None:
            whole[f] = None
            continue
        parts = gather(t, dst, group)
        whole[f] = None if parts is None else torch.cat(parts)
    if dist.get_rank() != dst:
        return None
    meta = {f: getattr(vol, f) for f in (
        "physical_size", "offset", "truncation_distance", "max_weight",
        "global_rotation", "global_translation")}
    return TSDFVolume(**whole, **meta)


def _check_slab(vol, mesh: Mesh) -> None:
    if not isinstance(vol, SlabVolume):
        raise ValueError("a sharded op takes this rank's slab (shard_volume)")
    n = _slab_planes(vol.full_z, mesh)
    if vol.tsdf.shape[0] != n or vol.z0 != mesh.get_coordinate()[0] * n:
        raise ValueError(
            f"slab planes {vol.z0}..{vol.z0 + vol.tsdf.shape[0] - 1} are not "
            f"this rank's share of {vol.full_z} planes")


def integrate_sharded(
    vol: SlabVolume,
    depth: torch.Tensor,
    camera: Camera,
    mesh: Mesh,
    cap_weight: bool = False,
    use_pallas: bool | None = None,
    nk: int = 3,
    interpret: bool | None = None,
    return_miss: bool = False,
    mode: str = "line",
    rgb: torch.Tensor | None = None,
):
    """Fuse one replicated frame into this rank's slab, IN PLACE, through
    the wrapper the frame selects (``pipelines.kinfu.integrate_frame``):
    depth in mode "exact", "line" or "fast", ``rgb`` into a slab with a
    colour field, a slab with a deformation field at its deformed centres.
    The slab's tsdf, weight and colour equal the same planes of the
    single-volume fusion bit for bit.

    ``use_pallas``, ``nk`` and ``interpret`` select TPU kernels in the JAX
    package and have no effect here: the tensors' device picks kernel or
    twin. Returns the slab, or (slab, miss) with ``return_miss``: the miss
    count of the "fast" convention summed over "b" (one all-reduce), a 0-d
    int32 tensor on the slab's device.
    """
    del use_pallas, nk, interpret
    _check_slab(vol, mesh)
    if mode not in MODES:
        raise ValueError(f"mode must be 'exact', 'line' or 'fast', got {mode!r}")
    dev = vol.device
    depth = torch.as_tensor(depth).to(dev).to(_F32).contiguous()
    if rgb is not None:
        if vol.color is None:
            raise ValueError("rgb frame given but the volume has no colour field")
        if vol.deform is not None:
            raise ValueError(
                "colour fusion is the rigid path (no deformed variant)")
        rgb = torch.as_tensor(rgb).to(dev).contiguous()
    vol, miss = integrate_frame(vol, depth, camera, mode=mode,
                                cap_weight=cap_weight, rgb=rgb)
    if not return_miss:
        return vol
    if miss is None:
        miss = torch.zeros((), dtype=torch.int32, device=dev)
    total = all_reduce(miss.reshape(1).clone(), dist.ReduceOp.SUM,
                       mesh.get_group("b"))
    return vol, total[0]


def _row_tile(height: int, n: int, i: int) -> tuple[int, int]:
    """(first row, rows) of tile i of n: ceil(height / n) rows each, the
    last ones padded past the image."""
    rows = -(-height // n)
    return i * rows, rows


def raycast_sharded(
    vol: SlabVolume,
    camera: Camera,
    mesh: Mesh,
    width: int = 640,
    height: int = 480,
    mode: str = "sphere",
    max_steps: int = REFERENCE_MAX_STEPS,
    step_scale: float = 0.75,
    replicate_volume_ok: bool = False,
):
    """Row-tiled raycast over a replicated volume: the slabs are gathered
    over "b" (every rank then holds the WHOLE volume), each rank marches
    its rows of the image (split over b x r) with the kernel from its row
    origin, and the tiles are gathered over the mesh. Every row equals the
    single-card render's bit for bit.

    An explicit opt-in, as in the JAX package: pass
    ``replicate_volume_ok=True`` to accept O(volume) memory a rank; the
    bricked raycast holds O(slab). ``mode`` other than "sphere" and
    ``step_scale`` other than 0.75 have no kernel and raise on CUDA
    tensors; on CPU tensors they run the plain march.

    Returns (vertices, normals), (H, W, 3) each, on every rank.
    """
    if not replicate_volume_ok:
        raise ValueError(
            "raycast_sharded all_gathers the WHOLE volume to every "
            "device (O(volume) per-device memory). Use "
            "raycast_sharded_bricked (O(brick), any orientation), or "
            "pass replicate_volume_ok=True to accept the cost."
        )
    _check_slab(vol, mesh)
    full = torch.cat(all_gather(vol.tsdf, mesh.get_group("b")))
    whole = TSDFVolume.for_geometry(
        full, vol.physical_size, vol.offset, vol.truncation_distance)
    b, r = mesh.get_coordinate()
    row0, rows = _row_tile(height, mesh.size, b * mesh.shape["r"] + r)
    tile = _vertices(whole, camera, width, rows, mode, max_steps, step_scale,
                     row0=row0)
    del whole, full
    verts = torch.cat(all_gather(tile, mesh.get_group(AXES)))[:height]
    return verts, compute_normals_from_vertices(verts)


def _slab_march_volume(vol: SlabVolume, mesh: Mesh) -> TSDFVolume:
    """The slab with its neighbours' edge planes (``halo_exchange_z``), as
    a render-only volume whose box spans those planes: the trilinear taps
    of a sample between the slab's and a neighbour's planes are then the
    whole volume's. The first and last slabs take no halo on the volume's
    outer faces, where the march clamps as the single-card one does."""
    nb = mesh.shape["b"]
    if nb == 1:
        return TSDFVolume.for_geometry(
            vol.tsdf, vol.physical_size, vol.offset, vol.truncation_distance)
    b, _ = mesh.get_coordinate()
    ext = halo_exchange_z(vol.tsdf, mesh)
    lo = 0 if b > 0 else 1
    hi = ext.shape[0] if b < nb - 1 else ext.shape[0] - 1
    planes = ext[lo:hi]
    first = vol.z0 - (1 if b > 0 else 0)
    vs = vol.voxel_size
    offset = torch.stack([vol.offset[0], vol.offset[1],
                          vol.offset[2] + first * vs[2]])
    physical = torch.stack([vol.physical_size[0], vol.physical_size[1],
                            planes.shape[0] * vs[2]])
    return TSDFVolume.for_geometry(
        planes.contiguous(), physical, offset, vol.truncation_distance)


def _bricked_vertices(vol, camera, mesh, width, height):
    """The bricked march's (H, W, 3) vertices on every rank."""
    nb = mesh.shape["b"]
    b, r = mesh.get_coordinate()
    row0, rows = _row_tile(height, mesh.shape["r"], r)
    sub = _slab_march_volume(vol, mesh)
    tile = _vertices(sub, camera, width, rows, "sphere", REFERENCE_MAX_STEPS,
                     0.75, row0=row0)
    del sub
    # a ray crosses z monotonically: its first hit is the nearest one over
    # the slabs (on a tie, the lowest slab's)
    tiles = all_gather(tile, mesh.get_group("b"))
    origin = camera.position
    best = tiles[0]
    best_d = _hit_distance(best, origin)
    for t in tiles[1:]:
        d = _hit_distance(t, origin)
        nearer = d < best_d
        best = torch.where(nearer[..., None], t, best)
        best_d = torch.where(nearer, d, best_d)
    return torch.cat(all_gather(best.contiguous(), mesh.get_group("r")))[:height]


def _hit_distance(verts: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """|vertex - origin| a pixel, +inf on a miss."""
    d = verts - origin
    dist2 = (d * d).sum(-1)
    return torch.where(torch.isfinite(dist2), dist2, float("inf"))


def raycast_sharded_bricked(
    vol: SlabVolume,
    camera: Camera,
    mesh: Mesh,
    width: int = 640,
    height: int = 480,
    interpret: bool | None = None,
    axis_select: bool | None = None,
):
    """Slab-local sharded raycast: no rank holds more than its slab (and a
    copy of it with the two halo planes for the march) and the image.

    Rank (b, r) marches row tile r (the rows split over "r") through slab b
    and its halo with the raycast kernel, from where each ray enters the
    slab's box. A ray crosses z monotonically, so its first hit is the
    nearest of the slabs' hits: one all-gather of the tiles over "b" picks
    it, one over "r" joins the tiles. A slab's march starts mid-volume, so
    its samples, and the secant refinement of its hit, are not the single
    march's: the vertices agree within a fraction of a millimetre, not bit
    for bit.

    ``interpret`` has no effect; ``axis_select`` raises where the JAX
    function raises (Y or X not divisible by the "b" axis) and has no other
    effect: the march has no sweep axis. Returns (vertices, normals) on
    every rank.
    """
    del interpret
    _check_slab(vol, mesh)
    nb = mesh.shape["b"]
    y, x = vol.tsdf.shape[1:]
    if axis_select and (y % nb or x % nb):
        raise ValueError(
            f"axis_select needs Y={y} and X={x} divisible by the brick "
            f"axis ({nb}); pass axis_select=False for the z-only sweep"
        )
    verts = _bricked_vertices(vol, camera, mesh, width, height)
    return verts, compute_normals_from_vertices(verts)


def _sum_in_rank_order(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``: one all-gather, the parts added in rank
    order, so that every rank holds the same bits."""
    parts = all_gather(t.contiguous(), group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _mesh_sum(mesh: Mesh, *parts):
    """The sums of the 6x7 system, residual and inliers over the mesh: one
    all-gather of every rank's 44 floats, added in rank order, so that
    every rank holds the same bits and takes the same branches."""
    flat = torch.cat([p.reshape(-1).to(_F32) for p in parts])
    total = _sum_in_rank_order(flat, mesh.get_group(AXES))
    a, b, res, inl = torch.split(total, [36, 6, 1, 1])
    return a.reshape(6, 6), b, res[0], inl[0]


def _my_rows(planes, mesh: Mesh):
    """This rank's rows of (H, W) planes split over the whole mesh, padded
    with NaN rows (an invalid vertex adds nothing); and its first row."""
    b, r = mesh.get_coordinate()
    h = planes[0].shape[0]
    row0, rows = _row_tile(h, mesh.size, b * mesh.shape["r"] + r)
    out = []
    for p in planes:
        tile = p[row0:row0 + rows]
        if tile.shape[0] < rows:
            pad = p.new_full((rows - tile.shape[0], p.shape[1]), float("nan"))
            tile = torch.cat([tile, pad])
        out.append(tile)
    return tuple(out), row0


def icp_step_sharded(
    rot: torch.Tensor,
    trans: torch.Tensor,
    vmap_curr: torch.Tensor,
    nmap_curr: torch.Tensor,
    vmap_prev: torch.Tensor,
    nmap_prev: torch.Tensor,
    intrinsics: tuple,
    mesh: Mesh,
    dist_thresh: float = 100.0,
    angle_thresh: float = 0.342,
):
    """One ICP step's normal equations with the current maps' rows split
    over the mesh and the model maps replicated; (A, b, residual_sq_sum,
    inlier_count) summed over the mesh, the same on every rank."""
    fx, fy, cx, cy = intrinsics
    vc, _ = _my_rows(vmap_curr.unbind(-1), mesh)
    nc, _ = _my_rows(nmap_curr.unbind(-1), mesh)
    out = icp_step(rot, trans, vc, nc, vmap_prev.unbind(-1),
                   nmap_prev.unbind(-1), fx, fy, cx, cy, dist_thresh,
                   angle_thresh)
    return _mesh_sum(mesh, *out)


@torch.no_grad()
def get_incremental_transformation_sharded(
    depth_curr: torch.Tensor,
    depth_prev: torch.Tensor,
    intrinsics,
    mesh: Mesh,
    levels: int = 3,
    iterations: tuple[int, ...] = (10, 5, 4),
    band: int | None = None,
    conv_eps: float = 0.0,
    init_pose: torch.Tensor | None = None,
    dist_thresh: float | None = None,
    angle_thresh: float | None = None,
    adaptive: bool = True,
) -> ICPResult:
    """The coarse-to-fine ICP pyramid on the mesh.

    Every level's current maps are split by rows over all b x r ranks
    (padded with NaN rows); the model maps, or with ``band`` the model
    depth of the banded association (one lane-gather launch an iteration
    on a card), are replicated. Each Gauss-Newton iteration sums the 6x7
    system, residual and inliers over the mesh, and every rank solves the
    same bits, so the ``conv_eps`` early exits branch together.
    ``adaptive`` has no effect, as in ``tracking.icp.icp_step_banded``.

    Returns an ICPResult (pose T_prev_curr, error, inliers) on every rank.
    """
    del adaptive
    dist_thresh = DIST_THRESH_MM if dist_thresh is None else dist_thresh
    angle_thresh = ANGLE_THRESH if angle_thresh is None else angle_thresh
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    pyr_c = depth_pyramid(torch.as_tensor(depth_curr), levels)
    pyr_p = depth_pyramid(torch.as_tensor(depth_prev), levels)
    dev = pyr_c[0].device
    maps = []
    for lvl in range(levels):
        intr = level_intrinsics(fx, fy, cx, cy, lvl)
        vc_full = vertex_map_planes(pyr_c[lvl], *intr)
        vc, row0 = _my_rows(vc_full, mesh)
        nc, _ = _my_rows(normal_map_planes(*vc_full), mesh)
        vp = np_ = None
        if band is None:
            vp = vertex_map_planes(pyr_p[lvl], *intr)
            np_ = normal_map_planes(*vp)
        maps.append((vc, nc, vp, np_, intr, row0))

    pose = (torch.eye(4, dtype=_F32, device=dev) if init_pose is None
            else torch.as_tensor(init_pose, dtype=_F32, device=dev))
    err = torch.zeros((), dtype=_F32, device=dev)
    inl = torch.zeros((), dtype=_F32, device=dev)
    for lvl in range(levels - 1, -1, -1):
        vc, nc, vp, np_, intr, row0 = maps[lvl]

        def step(pose, lvl=lvl, vc=vc, nc=nc, vp=vp, np_=np_, intr=intr,
                 row0=row0):
            rot, trans = pose[0:3, 0:3], pose[0:3, 3]
            if band is not None:
                out = icp_step_banded_planes(
                    rot, trans, vc, nc, pyr_p[lvl], *intr,
                    band=max(band >> lvl, 8), dist_thresh=dist_thresh,
                    angle_thresh=angle_thresh, row_offset=row0)
            else:
                out = icp_step(rot, trans, vc, nc, vp, np_, *intr,
                               dist_thresh, angle_thresh)
            return _mesh_sum(mesh, *out)

        pose, err, inl = run_level(
            step, iterations[lvl], float(conv_eps), pose, err, inl)
    return ICPResult(pose=pose, error=err, inliers=inl)


@torch.no_grad()
def track_and_fuse_frames_sharded(
    vol: SlabVolume,
    camera: Camera,
    frames: Iterable,
    mesh: Mesh,
    use_bilateral_filter: bool = False,
    nk: int = 3,
    band: int | None = None,
    width: int = 640,
    height: int = 480,
    conv_eps: float = 0.0,
):
    """Tracked KinectFusion on the mesh: bilateral filter (replicated, the
    kernel) -> the bricked model render -> the model depth (replicated) ->
    the sharded ICP pyramid -> ``integrate_sharded``. The first frame is
    fused at the camera's pose.

    As in ``pipelines.track_and_fuse_frames``, which this loop's
    trajectories follow, the filtered depth feeds the tracker only and the
    raw depth is fused (the JAX sharded loop fuses the filtered depth).
    ``nk`` has no effect. Returns (slab, camera at the last pose, the (4, 4)
    poses, the (error, inliers) stats), the same on every rank.
    """
    del nk
    _check_slab(vol, mesh)
    dev = vol.device
    k = camera.k
    intr = (k[0, 0], k[1, 1], k[0, 2], k[1, 2])
    zero = torch.zeros((), dtype=_F32, device=dev)
    poses, stats = [], []
    for depth in frames:
        depth = torch.as_tensor(depth).to(dev).to(_F32).contiguous()
        if poses:
            depth_icp = (bilateral_filter_cuda(depth) if use_bilateral_filter
                         else depth)
            verts = _bricked_vertices(vol, camera, mesh, width, height)
            model_depth = vertices_to_camera_depth(verts, camera.pose_inv)
            res = get_incremental_transformation_sharded(
                depth_icp, model_depth, intr, mesh, band=band,
                conv_eps=conv_eps)
            camera = camera.set_pose(matmul_small(camera.pose, res.pose))
            stats.append((res.error, res.inliers))
        else:
            stats.append((zero, zero))
        vol = integrate_sharded(vol, depth, camera, mesh)
        poses.append(camera.pose)
    return vol, camera, poses, stats



# -- the surface, the non-rigid frame and the pose gradient -------------------


def _cube_planes(vol: SlabVolume, mesh: Mesh):
    """The float32 planes the cubes of a slab read: its own and the next
    slab's first (``halo_exchange_z``); and the cube z-rows the slab owns,
    one fewer on the last slab, which has no plane above it."""
    b, _ = mesh.get_coordinate()
    zl = vol.tsdf.shape[0]
    planes = halo_exchange_z(vol.tsdf, mesh, halo=1)[1:]
    return planes.to(_F32), (zl - 1 if b == mesh.shape["b"] - 1 else zl)


def _gather_prefixes(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """The ranks' (cap, ...) buffers ``t`` of ``group``, stacked, sent as
    their first ``n`` rows (the most any rank fills) and zero-padded on
    arrival."""
    parts = all_gather(t[:max(n, 1)].contiguous(), group)
    out = t.new_zeros((len(parts),) + tuple(t.shape))
    for i, p in enumerate(parts):
        out[i, :p.shape[0]] = p
    return out


def extract_surface_sharded(
    vol: SlabVolume,
    mesh: Mesh,
    max_cubes_per_brick: int = 1 << 16,
    max_vertices_per_brick: int = 1 << 18,
    use_chunked: bool = True,
):
    """Brick-parallel marching cubes.

    Each rank extracts the cubes whose base voxel its slab owns (dense
    layout), reading the next slab's first plane through
    ``halo_exchange_z``; its vertices are the single volume's bits (the
    centres come from the whole volume's planes) and its voxel indices are
    global. ``use_chunked`` selects a TPU compaction in the JAX package and
    has no effect here.

    Returns, on every rank, a TriangleSoup-like tuple of the slabs' buffers
    stacked over "b" (one all-gather of the counts, then of each slab's
    filled rows, over "b"):
      vertices:      (nb, max_vertices_per_brick, 3) world mm
      vertex_voxels: (nb, max_vertices_per_brick, 2) GLOBAL voxel indices
      n_vertices:    (nb,)
      overflowed:    (nb,)
    Merge on the host with ``merge_brick_soups``. Every rank calls it.
    """
    del use_chunked
    _check_slab(vol, mesh)
    planes, n_cube_z = _cube_planes(vol, mesh)
    _, sy, sx = vol.tsdf.shape
    soup = _extract(
        planes, vol.voxel_size, vol.offset, max_cubes_per_brick,
        max_vertices_per_brick, "dense", n_cube_z=n_cube_z,
        voxel_index_base=vol.z0 * sy * sx, z0=vol.z0,
    )
    del planes
    group = mesh.get_group("b")
    head = torch.stack([soup.n_vertices, soup.overflowed.to(torch.int32)])
    heads = torch.stack(all_gather(head, group))
    n = int(heads[:, 0].max())  # the dense layout's counts are host-sized
    return (
        _gather_prefixes(soup.vertices, n, group),
        _gather_prefixes(soup.vertex_voxels, n, group),
        heads[:, 0].contiguous(),
        heads[:, 1] > 0,
    )


def merge_brick_soups(brick_soups):
    """Host-side: concatenate per-brick triangle soups into
    (verts (n, 3), tris (n/3, 3)) numpy arrays. Takes the tuple of
    ``extract_surface_sharded`` with its tensors on the card or the CPU
    (or as numpy arrays); copies each brick's filled rows only."""
    import numpy as np

    def host(t):
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return np.asarray(t)

    verts_b, _voxels_b, n_b, overflow_b = brick_soups
    if bool(host(overflow_b).any()):
        raise ValueError(
            "a brick overflowed: raise max_cubes/max_vertices_per_brick, "
            "or — if this is the chunked compaction's active-chunk cap "
            "(dense surface on TPU) — re-extract with "
            "extract_surface_sharded(..., use_chunked=False)"
        )
    counts = [int(n) for n in host(n_b)]
    verts = np.concatenate(
        [host(verts_b[b, :n]) for b, n in enumerate(counts)], axis=0)
    n = len(verts) - len(verts) % 3
    verts = verts[:n]
    tris = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return verts, tris


def update_deformation_sharded(
    vol: SlabVolume,
    depth: torch.Tensor,
    camera: Camera,
    flow: torch.Tensor,
    mesh: Mesh,
    max_cubes_per_brick: int = 1 << 16,
    threshold_mm: float | None = None,
    tpu_safe: bool | None = None,
):
    """Brick-parallel deformation-field update (the single-card
    ``pipelines.scenefusion.update_deformation`` on the mesh).

    Each rank extracts the cubes its slab owns (masked layout, the next
    slab's first plane through ``halo_exchange_z``), finds their
    vertices' correspondences against the replicated depth and flow (the
    row-gather kernel on a card) and sums (count, flow) into a LOCAL
    accumulator of its planes plus one: the sums that land on the extra
    plane belong to the next slab's first plane, and one all-gather over
    "b" hands them on (slab 0 receives nothing). The per-voxel
    normalisation ``flow_sum / max(count, 1)`` follows the hand-off,
    exactly as in the single-card update. A voxel on a slab's first plane
    adds its own cubes' sums and its neighbour's in another order than the
    single card does, so the field agrees within rounding, not bit for
    bit (exactly where the sums are exact, as with whole-millimetre flows).

    ``tpu_safe`` selects TPU compactions in the JAX package and has no
    effect here. The correspondence count and the overflow flag (a slab's
    occupied cubes past ``max_cubes_per_brick``) are summed over "b" in
    one all-reduce; the flag is read once on the host and warns.

    Returns (slab with the new ``deform``, total correspondence count, a
    0-d int32 tensor). Every rank calls it.
    """
    import warnings

    del tpu_safe
    vol, n_corr, overflowed = deformation_update_slab(
        vol, depth, camera, flow, mesh, max_cubes_per_brick, threshold_mm)
    if overflowed:
        warnings.warn(
            "update_deformation_sharded: a brick's occupied cubes "
            f"exceed max_cubes_per_brick={max_cubes_per_brick}; the "
            "deformation update was truncated — raise the cap",
            stacklevel=2,
        )
    return vol, n_corr


def deformation_update_slab(vol, depth, camera, flow, mesh,
                            max_cubes_per_brick, threshold_mm):
    """``update_deformation_sharded`` without its warning: (slab, total
    correspondence count, whether a slab's occupied cubes overflowed, a
    bool read on the host: the update's one host read)."""
    from ..pipelines.scenefusion import (
        CORRESPONDENCE_THRESHOLD_MM,
        apply_deformation,
        deformation_sums,
    )

    _check_slab(vol, mesh)
    if vol.deform is None:
        raise ValueError("update_deformation_sharded needs vol.deform")
    if threshold_mm is None:
        threshold_mm = CORRESPONDENCE_THRESHOLD_MM
    dev = vol.device
    depth = torch.as_tensor(depth).to(dev).to(_F32).contiguous()
    flow = torch.as_tensor(flow).to(dev).to(_F32).contiguous()
    planes, n_cube_z = _cube_planes(vol, mesh)
    soup = _extract(planes, vol.voxel_size, vol.offset, max_cubes_per_brick,
                    1, "masked", n_cube_z=n_cube_z, z0=vol.z0)
    del planes
    zl, sy, sx = vol.tsdf.shape
    plane = sy * sx
    acc, n_corr = deformation_sums(soup, depth, camera, flow,
                                   float(threshold_mm), (zl + 1) * plane)
    group = mesh.get_group("b")
    halos = all_gather(acc[zl * plane:].contiguous(), group)
    own = acc[:zl * plane]
    b, _ = mesh.get_coordinate()
    if b > 0:
        own[:plane] += halos[b - 1]
    counts = all_reduce(
        torch.stack([n_corr, soup.overflowed.to(torch.int32)]),
        dist.ReduceOp.SUM, group)
    overflowed = bool(counts[1] > 0)  # the one host read
    return (vol.replace(deform=apply_deformation(vol.deform, own)), counts[0],
            overflowed)


def warped_topup_sharded(
    vol: SlabVolume,
    mask: torch.Tensor,
    depth: torch.Tensor,
    camera: Camera,
    mesh: Mesh,
    cap_weight: bool = False,
    max_topup_per_brick: int = 1 << 16,
):
    """Brick-parallel ``warped_miss_topup`` of the JAX package: each rank
    fuses exactly the voxels of its slab that ``mask`` (this rank's
    (Z, Y, X) slab of the miss mask) marks, at their deformed centres, with
    the update of ``ops.integrate.integrate`` on those voxels (plain
    PyTorch on the slab's device, as the JAX core is plain jnp). It takes
    at most ``max_topup_per_brick`` of them, in voxel order, found on the
    device with no host read.

    The port's warped kernel has one thread a voxel and misses none, so
    the port's own frame (``scenefusion_frame_sharded``) never calls this:
    it keeps the JAX contract for a mask made elsewhere.

    Returns (slab with the updated tsdf and weight, remaining): the marked
    voxels past the cap, summed over "b" (one all-reduce), a 0-d int32
    tensor; > 0 means the top-up is incomplete. Every rank calls it.
    """
    from ..ops.integrate import integrate as integrate_plain

    _check_slab(vol, mesh)
    if vol.deform is None:
        raise ValueError("warped_topup_sharded needs vol.deform")
    dev = vol.device
    depth = torch.as_tensor(depth).to(dev).to(_F32).contiguous()
    mask = torch.as_tensor(mask).to(dev).reshape(-1).to(torch.bool)
    n = mask.numel()
    # the k-th marked voxel is the first whose running count reaches k
    running = torch.cumsum(mask, 0, dtype=torch.int32)
    k = torch.arange(1, max_topup_per_brick + 1, dtype=torch.int32,
                     device=dev)
    take = k <= running[-1]
    ids = torch.where(take, torch.searchsorted(running, k), 0)
    picked = vol.replace(
        tsdf=vol.tsdf.reshape(-1)[ids], weight=vol.weight.reshape(-1)[ids],
        deform=vol.deform.reshape(-1, 3)[ids], color=None, deform_rot=None)
    fused = integrate_plain(picked, depth, camera, cap_weight=cap_weight)
    # the voxels not taken write to a row past the slab, which is dropped
    dest = torch.where(take, ids, n)

    def put(field, values):
        flat = torch.cat([field.reshape(-1), field.new_zeros(1)])
        flat[dest] = values
        return flat[:n].reshape(field.shape)

    remaining = torch.clamp(running[-1] - max_topup_per_brick, min=0)
    remaining = all_reduce(remaining.reshape(1), dist.ReduceOp.SUM,
                           mesh.get_group("b"))[0]
    out = vol.replace(tsdf=put(vol.tsdf, fused.tsdf),
                      weight=put(vol.weight, fused.weight))
    return out, remaining


def scenefusion_frame_sharded(
    vol: SlabVolume,
    depth: torch.Tensor,
    camera: Camera,
    flow: torch.Tensor,
    mesh: Mesh,
    max_cubes_per_brick: int = 1 << 16,
    threshold_mm: float | None = None,
    tpu_safe: bool | None = None,
    nk: int = 5,
):
    """One non-rigid SceneFusion frame on the mesh: the brick-parallel
    deformation update (``update_deformation_sharded``), then the deformed
    slab's integrate (``integrate_sharded``: the warped kernel on a card),
    the mesh analogue of ``pipelines.scenefusion.scenefusion_step``. The
    slab's tsdf and weight are updated IN PLACE; ``deform`` is replaced.

    The warped kernel has one thread a voxel and misses none (its miss
    count is 0), so no top-up runs, where the JAX frame tops up the
    voxels its line-sweep kernel skipped. ``tpu_safe`` and ``nk`` select
    TPU compactions and kernels in the JAX package and have no effect here.

    Returns (slab, total correspondence count). Every rank calls it.
    """
    del tpu_safe, nk
    vol, n_corr = update_deformation_sharded(
        vol, depth, camera, flow, mesh,
        max_cubes_per_brick=max_cubes_per_brick, threshold_mm=threshold_mm)
    return integrate_sharded(vol, depth, camera, mesh), n_corr


def integrate_pose_sharded(
    vol: SlabVolume,
    depth: torch.Tensor,
    camera: Camera,
    delta,
    mesh: Mesh,
    nk: int = 3,
    cap_weight: bool = False,
    image_term: bool = True,
    interpret: bool | None = None,
    mode: str = "exact",
):
    """Differentiable fusion with respect to the pose on the mesh.

    Forward: each rank fuses ``depth`` into COPIES of its slab at the pose
    ``se3_exp(delta) @ camera.pose`` (``kernels.integrate.integrate_pose``
    on the slab: the brick-walk kernel, or the fast one with
    ``mode="fast"``); the slabs equal the same planes of the single-volume
    fusion bit for bit. Backward: each rank runs the pose adjoint's slab
    instance on its slab; the volume cotangents dd and dw stay on the rank,
    and the 12 float64 sums of the pose_inv cotangent are summed over "b"
    only (never over "r", whose ranks hold the same slab), in rank order on
    every rank, before they are rounded to float32. Autograd chains them
    through the 4x4 inverse and ``se3_exp``.

    The contract: each rank's loss is its slab's share, and ``delta.grad``
    on every rank is the gradient of the sum of the shares over "b". Every
    rank must call ``backward``: the backward holds a collective.

    ``nk`` and ``interpret`` select TPU kernels in the JAX package and have
    no effect here. Returns (fused slab, miss count summed over "b", a 0-d
    int32 tensor with no gradient). Rigid slabs only.
    """
    from ..kernels.integrate import pose_fusion

    del nk, interpret
    _check_slab(vol, mesh)
    if vol.deform is not None:
        raise ValueError(
            "integrate_pose_sharded is the rigid path: the pose adjoint "
            "is computed at lattice centres (deformed volumes would get "
            "a silently wrong gradient)"
        )
    depth = torch.as_tensor(depth).to(vol.device)
    group = mesh.get_group("b")
    return pose_fusion(vol, depth, camera, delta, cap_weight, image_term,
                       mode, over_slabs=lambda t: _sum_in_rank_order(t, group))
