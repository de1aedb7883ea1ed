"""SceneFusion: non-rigid fusion with a per-voxel deformation field.

Port of ``tsdf_tpu/pipelines/scenefusion.py`` (ref:
src/SceneFusion/SceneFusion.cpp:46-185, SceneFusion_krnl.cu:236-401). Per
frame after the first:

  1. extract the current isosurface with each vertex's two bracketing
     voxels, in the masked layout (``ops.marching_cubes``), queued on the
     device with no host read;
  2. find correspondences: project each vertex into the depth frame and
     accept it where the frame's depth agrees with the vertex's
     camera-space depth within 10 mm. The pixel's ``[depth, flow]`` row is
     fetched by ``kernels.gather.row_gather_op``;
  3. update the deformation field: every corresponding vertex adds
     flow(pixel) / usage(voxel) to BOTH its bracketing voxels, ``usage``
     counting all mesh vertices at the voxel. The reference does this with
     racy non-atomic adds; here the sums are deterministic (see
     ``_accumulate_rows``);
  4. integrate the depth frame at the deformed centres
     (``kernels.integrate.integrate_warped_cuda``).

On a CUDA volume the gathers and the integration are the hand-written
kernels; on a CPU volume their plain twins. The JAX module's TPU
factorings of the same update (cube-corner folding, per-edge streams, the
blocked gather walk, the cube-cap ladder, the prewarmed fallback and the
miss top-up) have no counterpart: a thread per voxel and a real gather
need none of them.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..camera import Camera
from ..kernels.gather import row_gather_op
from ..kernels.integrate import integrate_warped_cuda
from ..ops.marching_cubes import TriangleSoup, extract_surface
from ..volume import TSDFVolume, make_volume

# ref: SceneFusion_krnl.cu:15
CORRESPONDENCE_THRESHOLD_MM = 10.0


@dataclasses.dataclass(frozen=True)
class SceneFusionConfig:
    volume_size: tuple[int, int, int] = (255, 255, 255)  # ref: SceneFusion.cpp:49
    physical_size_mm: float = 2550.0
    offset_mm: tuple[float, float, float] = (-1275.0, -1275.0, 0.0)
    threshold_mm: float = CORRESPONDENCE_THRESHOLD_MM
    max_cubes: int = 1 << 18
    max_vertices: int = 1 << 20

    def make_volume(self, *, device) -> TSDFVolume:
        return make_volume(
            self.volume_size,
            self.physical_size_mm,
            offset=self.offset_mm,
            with_deformation=True,
            device=device,
        )


def _slot_correspondence(
    verts: torch.Tensor,
    slot_valid: torch.Tensor,
    depth: torch.Tensor,
    camera: Camera,
    flow: torch.Tensor,
    threshold_mm: float,
):
    """Project mesh vertices into the frame; accept a vertex where the
    frame's depth agrees with its camera-space depth within the threshold
    (ref: SceneFusion_krnl.cu:74-114). A vertex behind the camera would
    mirror-project into the image, so ``cam_z > 0`` gates too.

    Returns (corr (N,) bool, flow at each vertex (N, 3), zero where it
    does not correspond).
    """
    h, w = depth.shape
    cam_pts = camera.world_to_camera(verts)  # (N, 3)
    img_h = cam_pts @ camera.k.T
    pix = torch.round(img_h[:, 0:2] / img_h[:, 2:3])
    px, py = pix[:, 0], pix[:, 1]
    # compared as floats: a NaN or infinite projection is outside
    in_img = (px >= 0) & (px < w) & (py >= 0) & (py < h) & slot_valid
    lin = torch.where(in_img, py, 0.0).to(torch.int32) * w + torch.where(
        in_img, px, 0.0
    ).to(torch.int32)

    # one gather of whole rows: [depth, flow] as 4 channels a pixel. Slots
    # that are dead or outside the image read pixel 0 and are masked after.
    img = torch.cat(
        [depth.reshape(-1, 1), flow.to(torch.float32).reshape(-1, 3)], dim=-1
    )
    g = row_gather_op(img, lin)  # (N, 4)
    d = g[:, 0]
    cam_z = cam_pts[:, 2]
    corr = (
        in_img & (d > 0) & (cam_z > 0) & ((d - cam_z).abs() < threshold_mm)
    )
    return corr, torch.where(corr[:, None], g[:, 1:], 0.0)


def _accumulate_rows(acc: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """acc[idx[i], :] += rows[i, :] with duplicates in ``idx``, summed in
    an order that does not change from run to run.

    This site uses ``index_put_(accumulate=True)``. On a CUDA tensor
    PyTorch sorts the indices (a stable radix sort) and adds each run of
    duplicates sequentially, in order of appearance; float atomics
    (``index_add_``) would add in an order that differs between runs. On a
    CPU tensor the same call may add from several threads, so the sum is
    made here instead, touching no process-wide switch: a stable sort of
    the indices, ``torch.segment_reduce`` over each run of duplicates (one
    run is summed serially, in order of appearance), and one add of each
    run's sum into its row of ``acc``.
    """
    if acc.device.type != "cpu":
        acc.index_put_((idx,), rows, accumulate=True)
        return
    order = torch.argsort(idx, stable=True)
    hit, lengths = torch.unique_consecutive(idx[order], return_counts=True)
    acc[hit] += torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0)


def deformation_sums(
    soup: TriangleSoup,
    depth: torch.Tensor,
    camera: Camera,
    flow: torch.Tensor,
    threshold_mm: float,
    n_vox: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-voxel sums of one scene-flow observation: an (n_vox, 4)
    float32 accumulator whose channel 0 counts ALL valid mesh vertices a
    voxel brackets and channels 1-3 sum the flow of the corresponding ones
    (both bracketing voxels of a vertex receive its contribution), over the
    voxels ``soup.vertex_voxels`` indexes; and the number of corresponding
    vertices (0-d int32). ``update_deformation`` normalises them over a
    whole volume, the sharded update over a slab and its halo plane."""
    depth = depth.to(torch.float32)
    valid = soup.valid
    corr, flow_at_vert = _slot_correspondence(
        soup.vertices, valid, depth, camera, flow, threshold_mm
    )
    payload = torch.cat([valid.to(torch.float32)[:, None], flow_at_vert], dim=-1)
    # A dead slot adds an exact zero row. It is sent to a voxel of its own
    # (its slot number modulo the volume) and not to one shared dump row:
    # a run of millions of duplicates of one index would be added one
    # after the other.
    spread = torch.arange(valid.shape[0], device=valid.device) % n_vox
    acc = torch.zeros((n_vox, 4), dtype=torch.float32, device=depth.device)
    for side in (0, 1):
        vox = soup.vertex_voxels[:, side].to(torch.int64)
        _accumulate_rows(acc, torch.where(valid, vox, spread), payload)
    return acc, corr.sum().to(torch.int32)


def apply_deformation(deform: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``deform + flow_sum / max(count, 1)`` per voxel, from the sums of
    ``deformation_sums`` over ``deform``'s voxels."""
    delta = acc[:, 1:4] / torch.clamp(acc[:, 0:1], min=1.0)
    return deform + delta.reshape(deform.shape)


def update_deformation(
    vol: TSDFVolume,
    soup: TriangleSoup,
    depth: torch.Tensor,
    camera: Camera,
    flow: torch.Tensor,
    threshold_mm: float = CORRESPONDENCE_THRESHOLD_MM,
) -> tuple[TSDFVolume, torch.Tensor]:
    """Apply one scene-flow observation to the deformation field.

    Per voxel: ``counts`` over ALL valid mesh vertices the voxel brackets
    and ``flow_sum`` over the corresponding ones (both bracketing voxels
    of a vertex receive its contribution);
    ``deform += flow_sum / max(counts, 1)``.

    Args:
      soup: the current surface (vertices + bracketing voxel pairs), dense
        or masked layout.
      depth: (H, W) f32 mm, on the volume's device.
      flow: (H, W, 3) mm scene flow per pixel.

    Returns (volume with the new ``deform``, number of corresponding
    vertices as a 0-d int32 tensor). Nothing is read on the host.
    """
    acc, n_corr = deformation_sums(
        soup, depth, camera, flow, threshold_mm, vol.tsdf.numel()
    )
    return vol.replace(deform=apply_deformation(vol.deform, acc)), n_corr


def scenefusion_step(
    vol: TSDFVolume,
    depth: torch.Tensor,
    flow: torch.Tensor,
    camera: Camera,
    *,
    max_cubes: int,
    threshold_mm: float = CORRESPONDENCE_THRESHOLD_MM,
):
    """One SceneFusion frame: masked-layout surface extraction ->
    deformation update -> integrate at the deformed centres.

    Everything is queued on the volume's device; nothing is read on the
    host. ``vol.tsdf`` and ``vol.weight`` are updated in place; ``deform``
    is replaced.

    Returns (volume, correspondence count (0-d int32 tensor),
    extraction-overflow flag (0-d bool tensor): the occupied cubes exceeded
    ``max_cubes`` and the update saw a truncated surface).
    """
    soup = extract_surface(
        vol, max_cubes=max_cubes, max_vertices=1, layout="masked"
    )
    vol, n_corr = update_deformation(
        vol, soup, depth, camera, flow, threshold_mm
    )
    vol = integrate_warped_cuda(vol, depth, camera)
    return vol, n_corr, soup.overflowed


def _on_device(image, device) -> torch.Tensor:
    """A frame (numpy array of any real dtype, or tensor) as a contiguous
    float32 tensor on ``device``."""
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.ascontiguousarray(image))
    return image.to(device).to(torch.float32).contiguous()


def _same_device(a, b) -> bool:
    """Whether two device names name one device ("cuda" is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    return (a.index if a.index is not None else torch.cuda.current_device()) == (
        b.index if b.index is not None else torch.cuda.current_device())


class SceneFusion:
    """Orchestrator wiring an RGBD device to a scene-flow provider
    (ref: SceneFusion.cpp:46-185): per frame pair, update the warp field
    from scene flow and integrate.

    One host read per frame after the first: the extraction's overflow
    flag, which decides the warning. ``correspondence_counts`` keeps each
    frame's count on the device.

    With ``mesh`` (a ``parallel.make_mesh`` mesh) the class runs
    brick-parallel: ``volume`` is this rank's slab of the config's volume,
    made as a slab (``parallel.ops.make_sharded_volume``), and each later
    frame is ``parallel.scenefusion_frame_sharded``'s update and
    integrate. Every rank of the mesh constructs the class and feeds it the
    same frames; ``extract_mesh`` and ``dump`` gather the slabs onto the
    mesh's first rank, so every rank calls them too. ``device`` defaults to
    the mesh's and may not name another.
    """

    def __init__(
        self,
        scene_flow_provider,
        rgbd,
        config: SceneFusionConfig = SceneFusionConfig(),
        camera: Optional[Camera] = None,
        dump_every: int = 0,
        dump_dir: str = ".",
        mesh=None,
        *,
        device=None,
    ):
        if mesh is not None:
            if device is None:
                device = mesh.device
            elif not _same_device(device, mesh.device):
                raise ValueError(
                    f"device={device} is not the mesh's device {mesh.device}")
        elif device is None:
            raise TypeError("SceneFusion needs device= (or a mesh)")
        self.config = config
        self.sfa = scene_flow_provider
        self.rgbd = rgbd
        self.mesh = mesh
        self.camera = camera or Camera.default_depth_camera(device=device)
        if mesh is None:
            self.volume = config.make_volume(device=device)
        else:
            from ..parallel.ops import make_sharded_volume

            self.volume = make_sharded_volume(
                mesh, config.volume_size, config.physical_size_mm,
                offset=config.offset_mm, with_deformation=True)
        self.last_depth = None
        self.frame_index = 0
        self.dump_every = dump_every
        self.dump_dir = dump_dir
        self.correspondence_counts: list[torch.Tensor] = []
        rgbd.add_observer(self.process_frames)

    def process_frames(self, depth, colour=None):
        """Observer callback (ref: SceneFusion::process_frames :84-185)."""
        cfg = self.config
        dev = self.volume.device
        depth = _on_device(depth, dev)
        if self.last_depth is not None:
            _t, _r, flow = self.sfa.compute_scene_flow(depth, colour)
            flow = _on_device(flow, dev)
            if self.mesh is None:
                self.volume, n_corr, overflow = scenefusion_step(
                    self.volume, depth, flow, self.camera,
                    max_cubes=cfg.max_cubes, threshold_mm=cfg.threshold_mm,
                )
                overflow = bool(overflow)  # the frame's one host read
            else:
                # scenefusion_frame_sharded, with the overflow flag it reads
                # once on the host handed back for this class's warning
                from ..parallel.ops import (
                    deformation_update_slab,
                    integrate_sharded,
                )

                vol, n_corr, overflow = deformation_update_slab(
                    self.volume, depth, self.camera, flow, self.mesh,
                    cfg.max_cubes, cfg.threshold_mm)
                self.volume = integrate_sharded(vol, depth, self.camera,
                                                self.mesh)
            self.correspondence_counts.append(n_corr)
            if overflow:
                warnings.warn(
                    f"SceneFusion frame {self.frame_index}: occupied "
                    f"cubes exceed max_cubes={cfg.max_cubes}; mesh (and "
                    "the deformation update) truncated — raise "
                    "SceneFusionConfig.max_cubes",
                    stacklevel=2,
                )
        else:
            self.volume = self._integrate(depth)
        self.last_depth = depth
        if self.dump_every and self.frame_index % self.dump_every == 0:
            self.dump(self.frame_index)
        self.frame_index += 1

    def _integrate(self, depth: torch.Tensor) -> TSDFVolume:
        """The deformed-volume integrate: every voxel reads its own pixel,
        so there is no miss to fall back from (on a mesh, each rank's slab:
        ``parallel.integrate_sharded``)."""
        if self.mesh is not None:
            from ..parallel.ops import integrate_sharded

            return integrate_sharded(self.volume, depth, self.camera, self.mesh)
        return integrate_warped_cuda(self.volume, depth, self.camera)

    def _whole_volume(self) -> Optional[TSDFVolume]:
        """The whole volume: on a mesh, gathered onto its first rank (None
        on every other rank; every rank calls this)."""
        if self.mesh is None:
            return self.volume
        from ..parallel.ops import unshard_volume

        return unshard_volume(self.volume, self.mesh)

    def dump(self, index: int) -> None:
        """Periodic checkpoint + canonical and warped meshes
        (ref: SceneFusion.cpp:142-181). On a mesh the first rank writes
        the files from the gathered volume; every rank calls this."""
        from ..io.ply import write_ply
        from ..io.tsdf_file import save_tsdf
        from ..ops.deform import deform_points
        from ..ops.marching_cubes import soup_to_numpy

        vol = self._whole_volume()
        if vol is None:
            return
        os.makedirs(self.dump_dir, exist_ok=True)
        save_tsdf(vol, os.path.join(self.dump_dir, f"frame_{index:03d}.tsdf"))
        verts, tris = soup_to_numpy(self._extract(vol))
        write_ply(
            os.path.join(self.dump_dir, f"mesh_canonical_{index:03d}.ply"),
            verts,
            tris,
        )
        warped, _valid = deform_points(vol, verts)
        write_ply(
            os.path.join(self.dump_dir, f"mesh_warped_{index:03d}.ply"),
            warped.cpu().numpy(),
            tris,
        )

    def extract_mesh(self) -> Optional[TriangleSoup]:
        """The whole volume's surface. On a mesh: the slabs gathered onto
        the mesh's first rank and extracted there, which returns the soup
        of the single card's volume (None on every other rank; every rank
        calls this)."""
        vol = self._whole_volume()
        return None if vol is None else self._extract(vol)

    def _extract(self, vol: TSDFVolume) -> TriangleSoup:
        return extract_surface(
            vol,
            max_cubes=self.config.max_cubes,
            max_vertices=self.config.max_vertices,
        )
