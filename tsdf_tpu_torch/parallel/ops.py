"""Sharded fusion on a ("b", "r") mesh of ranks: z-slab integrate, the two
sharded raycasts, the sharded ICP pyramid and tracked fusion.

Port of ``tsdf_tpu/parallel/ops.py``, its rigid half. Every rank runs the
single-card kernels on its own share: its z-slab of the volume (a
``SlabVolume``) for the integrate and for the march of the bricked
raycast, its row tile of the image for the replicated raycast and for the
ICP residuals. The collectives are those of ``mesh.py``:

  * integrate: none (each slab projects into the replicated frame); the
    miss count, when asked for, is one all-reduce over "b";
  * raycast_sharded_bricked: one all-gather over "b" of the slabs' edge
    planes (the halo), one over "b" of the tiles' vertices (the nearest hit
    wins), one over "r" of the tiles;
  * raycast_sharded: one all-gather over "b" of the slabs (the whole
    volume on every rank, by the caller's leave), one over the mesh of the
    row tiles;
  * ICP: one all-gather over the mesh of each iteration's 44 partial sums,
    added in rank order on every rank.

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


def _mesh_sum(mesh: Mesh, *parts):
    """The sums of the 6x7 system, residual and inliers over the mesh: one
    all-gather of every rank's 44 floats, added in rank order, so that
    every rank holds the same bits and takes the same branches."""
    flat = torch.cat([p.reshape(-1).to(_F32) for p in parts])
    every = all_gather(flat, mesh.get_group(AXES))
    total = every[0]
    for p in every[1:]:
        total = total + p
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

