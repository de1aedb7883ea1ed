"""Chip smoke of the PyTorch/CUDA port: the GT-pose fuse -> render -> mesh
path, the tracked KinectFusion loop, colour fusion (GT-pose and tracked),
the decimated "fast" integrate mode and pose recovery through
differentiable fusion and through the differentiable raycast at the
repository's 512^3 / 640x480 size, and non-rigid SceneFusion at the
reference's 255^3 / 2550 mm, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

  1. environment: torch/CUDA versions, the card, its power limit;
  2. build: compile csrc/*.cu with nvcc into the package's build dir,
     and the native PNG library (csrc/png_unfilter.cpp);
  3. each kernel against its plain PyTorch twin on the card, at the
     shapes the main paths give it, with CUDA-event median times
     (``tsdf_tpu_torch.utils.profiling.median_ms``), the
     least time the card could take for the same work (its bound) and,
     where one PyTorch call computes the same function, that call's time
     (integrate over two frames, so the second blends into voxels that
     already hold weight, tsdf and weight bit-equal, a frame with no depth
     timed beside it and the share of bricks culled; the raycast on the
     analytic scene and on the volume the 20-frame fuse leaves, hit masks
     and vertices bit-equal, with the share of samples in uniform bricks
     and a render of no step; the bilateral filter on a noisy frame with
     holes, float32 and uint16 at radius 5, float32 at radius 3 and at
     radius 60 (the runtime-radius instance, above 48 KB of shared
     memory) and on a frame with NaN, +inf, -inf and negative depths, with
     each instance's registers and launch plan and the issue-rate floor
     beside the bound; the lane gather on the recorded calls of
     a dense 512^3 and of a masked 255^3 extraction and at the ICP
     association's shapes on all three pyramid levels, each with the
     launch it took; the
     colour, fast and colour-fast integrate kernels over two frames:
     tsdf, weight, colour bytes and miss counts equal, each one's
     culled bricks and a frame with no depth beside them; the warped
     integrate at 512^3 under a uniform warp and at 255^3 under the field
     real deformation updates leave; the row gather at the correspondence
     and the deform_points shapes of a real frame (the instance picked,
     its SASS instructions a row) and on its edge inputs (group tails,
     extreme indices, unaligned views, other dtypes, a 4 GiB output); the
     windowed lane
     gather and its checked wrapper on coherent and wild indices (also at
     tiles of 128 rows and a window of 8 blocks), the checked wrapper's
     guarded fallback alone with its miss word 0 and 1, the plans and
     registers; the
     pose adjoint at 512^3 on the second frame over the volume the first
     fused, with a seeded cotangent: dd and dw bit-equal, the pose_inv
     cotangent within 1e-6 and bit-equal with the column sums of its
     per-brick model, a second launch bit-equal, the share of bricks
     culled, a frame with no depth (a copy of the cotangents) beside a
     device copy of the same bytes, the registers of its two brick
     kernels and its device time by kernel; the gather-roofline
     probe: out equal, its G elements/s, and beside its operation bound
     the shared-memory wavefront floor of its indices and the issue-rate
     floor of its gather loop, with the wavefronts a clock it reaches);
  3b. pose recovery at 512^3 / 640x480: the workload of
     tools/run_config4b.py (normalised steps through integrate_pose from a
     17 mm / 5.4 mrad twist, 14 steps, the best iterate kept: the gradient
     at the start through the kernels against the same through the twins,
     loss and |v| a step, ms a value-and-grad step by CUDA events and on
     the host, device time by kernel under the profiler, peak memory,
     integrate and integrate_pose_grad launches) and of
     tools/run_config4.py: first the linearisation kernel
     (csrc/lm_linearise.cu) at a twisted pose, float32 and bf16, two calls
     bit-equal, its sums against the plain twin's, its time beside its
     bound and the six dual passes it replaced; then
     Levenberg-Marquardt through raycast_diff from a 25.6 mm offset until
     the translation error is under 1 mm, at most 80 iterations: rms and
     error a step, ms a step, one raycast and one lm_linearise launch a
     step);
  4. the GT-pose path: a fabricated 20-frame TUM directory (a wall and
     two spheres, intersected in closed form) through
     ``tsdf_tpu_torch.cli.main(["fuse", ...])``, with launch counts,
     output checks and the raycast hits' distance from the analytic
     surface; then the ``icp`` verb on the saved volume and a depth
     frame from a nearby pose, with launch counts and the recovered
     motion; then the package-level API (``api``): the root ``integrate``
     (depth, and with colour) against ``integrate_cuda`` /
     ``integrate_color_cuda`` over two 512^3 frames and the stacked
     ``icp_step_banded`` against the planar form at level 0 of the first
     tracked frame, all bit-equal with their launches counted; a
     checkpoint resume at 512^3 (2 frames, ``save_sharded``,
     ``load_sharded``, 2 more) bit-equal with 4 frames fused straight,
     with the save and load seconds; the ``view`` verb on the saved .tsdf
     (seconds; the tiles on the card byte-equal with the CPU's); a
     ``Timer`` span and a ``profile_to`` trace around a fused frame;
  5. the tracked path: the same directory through
     ``cli.main(["fuse", "--track", "--filter", ...])`` (its poses serve
     only as the first pose and for the trajectory error), with launch
     counts, no lost frame, the trajectory error under one voxel, and the
     same output checks; then the tracked device loop alone on the same
     frames: no lost frame, the trajectory error under one voxel, at most
     one host sync a tracked frame;
  6. colour fusion: ``cli.main(["fuse", "--fuse-color", "--color", ...])``
     on the same directory, whose rgb/ frames hold a closed-form colour of
     the hit point (launch counts, the colour render against that colour,
     the coloured PLY, the .tsdf's colour against an in-process fuse);
     then ``fuse --fuse-color --track --filter`` (launch counts, no lost
     frame, trajectory error, colour render);
  7. ``integrate_mode="fast"`` through ``fuse_frames`` (depth, and depth +
     colour) and ``track_and_fuse_frames``: launch counts, no miss, the
     fused field against the exact fusion and the analytic surface, and
     ms/frame of the fast and the exact fuse loop side by side;
  8. bf16 storage (``TSDFVolume.astype``): each bf16 kernel instance (the
     four integrates of the brick walk, the raycast, the warped integrate
     with and without colour, the pose adjoint) bit-equal with its bf16
     twin, timed in turns with its float32 instance, its bound with 2-byte
     storage; ``fuse_frames`` of the 20 frames at 512^3 on a bf16 volume
     in depth, colour, fast and colour-fast modes (counted: the bf16
     instance only) against the same on float32 (weights and colour equal,
     tsdf within one bf16 ulp of its largest magnitude), the device peaks
     of both; the tracked loop on a bf16 volume; the marching-cubes vertex
     count beside float32's; the SceneFusion loop and colour frames into a
     deformed bf16 volume; one config4b step on a bf16 volume;
  9. SceneFusion: a fabricated RGB-D + PD-Flow directory (a sphere seen
     from the identity pose, a uniform +x flow of 4 + i mm) through
     ``cli.main(["sfusion", ...])`` with exact launch counts; the
     ``SceneFusion`` class on the same files with dumps, bit-equal to a
     run through the plain twins and to a second run; the deformation
     field against the flow that was fed; ms per frame, its split and its
     host syncs; colour frames into a deformed volume;
 10. sharded (run after phase 7): the mesh path of ``parallel/`` on the
     20 frames at 512^3. Four ranks share this card over gloo (a
     correctness configuration, not a multi-card speed), as mesh 4x1 and
     then 2x2: the GT-pose ``integrate_sharded`` gathered bit-equal with
     the single-volume kernel run (float32, bf16, colour),
     ``raycast_sharded`` bit-equal with the single-card render,
     ``raycast_sharded_bricked`` within the JAX gates of it (hit agreement,
     median, p99), ``track_and_fuse_frames_sharded`` with the filter, its
     poses within 2 mm / 3e-3 of the single-card loop's, its ATE, each
     rank's launches and its peak. Then ``fuse --devices 1x1`` on NCCL,
     with and without ``--fuse-color``, byte-equal with the verb without
     ``--devices``, and ``fuse --devices 1x1 --track --filter`` (poses held
     to the same gates). Inside the same four-rank spawn too: the
     sharded checkpoint at 512^3 (the fused float32 slabs and a bf16
     slab with deformation and colour saved on 4x1 and restored onto 2x2
     bit for bit, a resume on 4x1 of 2 + 2 frames bit-equal with 4 fused
     straight on one card; each rank's save and load seconds, the bytes on
     disk) and ``SceneFusion(mesh=)`` at 256^3 over 2560 mm on phase 9's
     files on both meshes, held after every frame to the single-card
     class beside it (n_corr equal, deform and tsdf within
     SF_MESH_DEFORM_MM / SF_MESH_TSDF_MM, weights equal, bit-equality
     logged), its ``extract_mesh`` PLY and one ``dump`` byte-equal with the
     single card's, then timed on the frames on the card (slowest rank,
     each rank's launches). After ``fuse --devices 1x1``, ``sfusion
     --devices 1x1`` on NCCL: stdout and PLY byte-equal with phase 9's
     verb (which runs before this phase), integrate_warped 6,
     row_gather 5, lane_gather at least phase 9's. With four cards,
     ``fuse`` on 4x1 and 2x2 meshes of cards, and ``sfusion -s 256`` on
     both against one card's (byte-equal); else one line says they did
     not run.

The next-to-last line of output is one JSON object naming each kernel,
the last is {"ok": true, "device": {...}}. Needs one card; imports no
JAX.

    python3 chip_smoke.py --parent DIR

runs the smoke and also builds the kernels of the checkout at DIR (the
parent commit, unpacked there) and times its raycast, integrate,
pose-adjoint, bilateral, row-gather (at both SceneFusion shapes),
windowed-gather (alone and with the checked wrapper's fallback, and the
fallback alone) and probe entry points (and a
frame with no depth through the fast integrate and the adjoint) on the
same inputs, in turns with this tree's;
the fast fuse loop and the config4b step with the parent's kernel in
turns; and the config4b descent through the parent's adjoint, whose
residual must stay within C4B_RESIDUAL_MM of this tree's.

    python3 chip_smoke.py --lm

runs only phase 3b's Levenberg-Marquardt half (the linearisation kernel,
then the recovery) and prints what it found as one JSON object on the
last line.

    python3 chip_smoke.py --config3 [--frames N] [--noise] [--eps]

runs, in place of phases 3-10, the tracked loop on the 500-pose orbit of a
wall-and-sphere scene at 256^3 (the workload of tools/run_config3.py) and
prints ms/frame and the trajectory errors as one JSON object on the last
line.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tsdf_tpu_torch.utils.profiling import median_ms, profile_step

SIZE = 512
PHYSICAL = 3000.0
W, H = 640, 480
N_FRAMES = 20
MAX_CUBES = 1 << 21
MAX_VERTICES = 1 << 23
FX, FY, CX, CY = 591.1, 590.1, 331.0, 234.6

# the scene, mm: a wall z = WALL_Z and two spheres (centre, radius)
WALL_Z = 2500.0
SPHERES = [((300.0, -150.0, 1500.0), 400.0), ((-450.0, 250.0, 1100.0), 250.0)]

# every kernel must equal its plain twin bit for bit; the gates below hold
# the paths' outputs against the analytic scene
SURFACE_MEDIAN_MM = PHYSICAL / SIZE  # one voxel
ATE_MAX_MM = PHYSICAL / SIZE  # one voxel
# the ``icp`` verb: the motion between the model's view and the depth
# frame (mm, rad about y), and how closely it must be recovered
ICP_VERB_MOTION = ((12.0, -8.0, 10.0), 0.01)
ICP_VERB_TRANS_MM = PHYSICAL / SIZE  # one voxel
ICP_VERB_ROT_RAD = 3e-3
BILATERAL_OTHER_SIGMAS = (35.0, 1.7)  # radius 3; the default pair gives 5
BILATERAL_WIDE_SIGMA_SPACE = 40.0  # radius 60: above 48 KB of shared memory
# colour: the render from the first pose against the analytic colour, in
# levels of 255 over the pixels the render hit (mean, and a cap on the
# share of pixels further off than 16 levels: silhouettes, where voxels
# blend two surfaces or border a voxel no frame coloured)
COLOR_MEAN_LEVELS = 4.0
COLOR_FAR_LEVELS, COLOR_FAR_SHARE = 16, 0.05
# fast mode against the exact fusion of the same frames: mean |tsdf
# difference| on voxels both updated, as the JAX package's own test gates
# it (0.1 voxel); colour-fast against exact colour: mean level difference
FAST_TSDF_MEAN_MM = 0.1 * PHYSICAL / SIZE
FAST_COLOR_MEAN_LEVELS = 2.0

# Published peaks of one H100 SXM: the bounds are stated against these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations the kernels' functions need, counted from their
# expressions (a compare, a min/max, a floor and a division count as one).
INTEGRATE_OPS = dict(voxel=27, in_front=12, updated=8)
# the fast convention per voxel: three centres (6), the y and z rows of the
# projection (12), the row pixel (3), its guard, clip and rounding (4), the
# decimated row (4), the line's column (7), the image and slope gates (6);
# its pre-pass per voxel column: two projections and the fit (60). A voxel
# in the colour band: two divisions and a max for the rate, and per channel
# two conversions, the blend (3), the rounding and the clip (3)
FAST_OPS = dict(voxel=42, column=60, updated=8)
COLOR_OPS_PER_BAND_VOXEL = 3 + 3 * 8
RAYCAST_OPS = dict(ray=60, sample=74)
# per tap: dv, dv^2, the exponent's product, expf counted as five (scale,
# round, two for the reduced argument, ex2), two weight products, two sums
BILATERAL_OPS_PER_TAP = 12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, operations: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its float32 peak."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


# The kernels library of another checkout (``--parent DIR``, the parent
# commit unpacked at DIR), built from its own sources: its entry points are
# timed beside this tree's on the same inputs, in the same process.
PARENT_LIB = None
PARENT_DIR = None


def load_parent(path: str):
    """Build and load the kernels library of the checkout at ``path``: its
    package is imported under another name (its ``_build`` imports from
    the package), so the build runs on its own sources."""
    import ctypes
    import importlib
    import importlib.util

    pkg_dir = os.path.join(path, "tsdf_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_tsdf_tpu_torch", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    mod = importlib.import_module(spec.name + ".kernels._build")
    t0 = time.perf_counter()
    mod.build(force=True)
    log(f"parent build: {time.perf_counter() - t0:.1f} s "
        f"({mod.library_path()})")
    return ctypes.CDLL(str(mod.library_path()))


@contextlib.contextmanager
def parent_kernels(*kernels):
    """Run ``kernels``' wrappers on the parent library's entry points of the
    same names (the wrappers' arguments are a superset of what the parent
    reads: its parameters come first, its scratch fits in this tree's)."""
    import ctypes

    saved = [k._fn for k in kernels]
    for k in kernels:
        fn = getattr(PARENT_LIB, k.symbol)
        fn.argtypes = k.argtypes
        fn.restype = ctypes.c_int
        k._fn = fn
    try:
        yield
    finally:
        for k, fn in zip(kernels, saved):
            k._fn = fn


def parent_ms(kernels, fn, reps: int, inner: int = 1) -> float | None:
    """``median_ms(fn)`` with ``kernels`` on the parent's entry points, or
    None without ``--parent``."""
    if PARENT_LIB is None:
        return None
    with parent_kernels(*kernels):
        return median_ms(fn, reps=reps, inner=inner)


def ms_text(ms: float | None) -> str:
    """A time for the log: four decimals, or "not run" (no ``--parent``)."""
    return "not run" if ms is None else f"{ms:.4f}"


def parent_in_turns(kernels, fn, reps: int, ms: float, what: str,
                    inner: int = 1):
    """With ``--parent``: the parent's time of ``fn``, then this tree's and
    the parent's again, logged beside ``ms`` (this tree's, just taken with
    the same ``reps`` and ``inner``); returns the parent's first time, or
    None without ``--parent``."""
    parent = parent_ms(kernels, fn, reps, inner)
    if parent is not None:
        ms2 = median_ms(fn, reps=reps, inner=inner)
        parent2 = parent_ms(kernels, fn, reps, inner)
        log(f"{what}, in turns: kernel {ms:.4f}, parent {parent:.4f}, kernel "
            f"{ms2:.4f}, parent {parent2:.4f} ms")
    return parent


# -- the fabricated dataset --------------------------------------------------


def look_at_pose(position, target) -> np.ndarray:
    """Camera->world pose with columns [left, up, forward, position]
    (the Camera.look_at convention, +Y up)."""
    position = np.asarray(position, np.float64)
    forward = np.asarray(target, np.float64) - position
    forward /= np.linalg.norm(forward)
    left = np.cross([0.0, 1.0, 0.0], forward)
    left /= np.linalg.norm(left)
    up = np.cross(forward, left)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = (
        left, up, forward, position,
    )
    return pose


def frame_poses() -> list[np.ndarray]:
    """A short arc at z ~ -400 mm, looking at +z."""
    poses = []
    for i in range(N_FRAMES):
        theta = -0.12 + 0.24 * i / (N_FRAMES - 1)
        pos = (500.0 * math.sin(theta), 60.0 * math.sin(2 * theta),
               -400.0 - 500.0 * (1.0 - math.cos(theta)))
        poses.append(look_at_pose(pos, (0.0, 0.0, 1500.0)))
    return poses


def analytic_depth(pose: np.ndarray) -> np.ndarray:
    """(H, W) camera-z depth in mm of the nearest ray hit."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], -1)
    d = d_cam @ pose[:3, :3].T  # world direction with camera z = 1
    o = pose[:3, 3]
    t = (WALL_Z - o[2]) / d[..., 2]
    for centre, radius in SPHERES:
        oc = o - np.asarray(centre)
        a = (d * d).sum(-1)
        b = 2.0 * (d @ oc)
        c = oc @ oc - radius * radius
        disc = b * b - 4 * a * c
        ts = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
        t = np.where((disc > 0) & (ts > 0), np.minimum(t, ts), t)
    return t  # camera z == t because d_cam.z == 1


def surface_distances(p: np.ndarray) -> np.ndarray:
    """(..., 3) distances of world points (..., 3) from the wall and from
    each sphere."""
    dist = [np.abs(p[..., 2] - WALL_Z)]
    for centre, radius in SPHERES:
        dist.append(np.abs(np.linalg.norm(p - np.asarray(centre), axis=-1) - radius))
    return np.stack(dist, axis=-1)


def analytic_color(p: np.ndarray) -> np.ndarray:
    """(..., 3) colour in [0, 255] of world surface points (..., 3): the
    wall a slow gradient in x and y, each sphere a gradient in its normal,
    every channel at least 40 so that no surface is black."""
    wall = np.stack([
        40.0 + 170.0 * (p[..., 0] + PHYSICAL / 2) / PHYSICAL,
        40.0 + 170.0 * (p[..., 1] + PHYSICAL / 2) / PHYSICAL,
        np.full(p.shape[:-1], 200.0)], axis=-1)
    colours = [wall]
    for n, (centre, radius) in enumerate(SPHERES):
        normal = (p - np.asarray(centre)) / radius
        colours.append(np.stack([
            140.0 + 90.0 * normal[..., 0], 140.0 + 90.0 * normal[..., 1],
            np.full(p.shape[:-1], 60.0 + 50.0 * n)], axis=-1))
    nearest = surface_distances(p).argmin(axis=-1)
    out = np.choose(nearest[..., None], colours)
    return np.clip(out, 0.0, 255.0)


def analytic_rgb(pose: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 colour frame seen from ``pose``: the analytic colour
    of each pixel's hit point."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], -1)
    points = pose[:3, 3] + analytic_depth(pose)[..., None] * (d_cam @ pose[:3, :3].T)
    return np.round(analytic_color(points)).astype(np.uint8)


def quaternion(r: np.ndarray) -> tuple[float, float, float, float]:
    """(qx, qy, qz, qw) of a rotation matrix."""
    w = math.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2.0
    return (
        (r[2, 1] - r[1, 2]) / (4 * w),
        (r[0, 2] - r[2, 0]) / (4 * w),
        (r[1, 0] - r[0, 1]) / (4 * w),
        w,
    )


def write_tum_dir(root: str) -> list[np.ndarray]:
    from tsdf_tpu_torch.io.png import save_png

    os.makedirs(os.path.join(root, "depth"))
    os.makedirs(os.path.join(root, "rgb"))
    lines = []
    poses = frame_poses()
    for i, pose in enumerate(poses):
        stamp = f"{i}.000000"
        z = analytic_depth(pose)
        save_png(
            os.path.join(root, "depth", f"{stamp}.png"),
            np.clip(np.round(z * 5.0), 0, 65535).astype(np.uint16),
        )
        save_png(os.path.join(root, "rgb", f"{stamp}.png"), analytic_rgb(pose))
        values = (*(pose[:3, 3] / 1000.0), *quaternion(pose[:3, :3]))
        lines.append(" ".join([stamp] + [repr(float(v)) for v in values]))
    with open(os.path.join(root, "ground_truth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return poses


def surface_distance(v: torch.Tensor) -> torch.Tensor:
    """Distance of world points (N, 3) from the analytic scene."""
    dist = (v[:, 2] - WALL_Z).abs()
    for centre, radius in SPHERES:
        c = torch.tensor(centre, dtype=v.dtype, device=v.device)
        dist = torch.minimum(dist, ((v - c).norm(dim=-1) - radius).abs())
    return dist


def analytic_volume(dev):
    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.utils import fixtures

    vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    tsdf = fixtures.wall_tsdf(vol, WALL_Z).tsdf
    for centre, radius in SPHERES:
        tsdf = torch.minimum(tsdf, fixtures.sphere_tsdf(vol, radius, centre).tsdf)
    return vol.replace(tsdf=tsdf.contiguous())


# -- phases ----------------------------------------------------------------


def phase_environment() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"device: {name} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    return name, smi


def phase_build() -> None:
    """The kernels' library with nvcc, and the native PNG library with the
    host's compiler: without it the verbs decode frames in Python."""
    from tsdf_tpu_torch import native
    from tsdf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path()})")
    check(native.available(), f"the native PNG library did not build: "
          f"{native.build_error()}")


def voxels_in_front(vol, cam) -> int:
    """How many voxel centres of ``vol`` have a positive camera z."""
    zc, yc, xc = vol.axis_centres()
    pi = cam.pose_inv
    camz = (pi[2, 0] * xc[None, None, :] + pi[2, 1] * yc[None, :, None]
            + pi[2, 2] * zc[:, None, None] + pi[2, 3])
    return int((camz > 0).sum())


def compare_integrate(dev, frames) -> dict:
    """Fuse the first two frames into one 512^3 volume with the kernel
    and into another with the plain twin, and compare after the second:
    the second frame blends into voxels that already hold weight, as 19
    of the main path's 20 frames do. tsdf and weight must be equal bit for
    bit. Then time the second frame, a frame with no depth beside it, and
    log the share of bricks the kernel culls on each (``brick_cull``)."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import integrate
    from tsdf_tpu_torch.kernels.integrate import brick_cull, integrate_cuda
    from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain

    ref = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    out = ref.replace(tsdf=ref.tsdf.clone(), weight=ref.weight.clone())
    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames]
    for (depth, _), cam in zip(frames, cams):
        before = ref
        ref = integrate_plain(ref, depth, cam)
        out = integrate_cuda(out, depth, cam)
    torch.cuda.synchronize()
    blended = int(((ref.weight > before.weight) & (before.weight > 0)).sum())
    equal = torch.equal(out.tsdf, ref.tsdf) and torch.equal(out.weight, ref.weight)
    err = float((out.tsdf - ref.tsdf).abs().max())
    log(f"integrate 512^3, two frames: tsdf and weight equal bit for bit: "
        f"{equal} (max |tsdf diff| {err:.3g} mm); the second frame blended "
        f"into {blended} voxels of weight > 0")
    check(blended > 0, "the second frame blended into no voxel")
    check(equal, "integrate differs from its twin")
    depth, cam = frames[1][0], cams[1]
    no_depth = torch.zeros_like(depth)
    culled = float(brick_cull(out, depth, cam).float().mean())
    check(bool(brick_cull(out, no_depth, cam).all()),
          "a frame with no depth leaves a brick unculled")
    ms = median_ms(lambda: integrate_cuda(out, depth, cam), reps=20)
    zero_depth_ms = median_ms(lambda: integrate_cuda(out, no_depth, cam), reps=20)
    parent = parent_in_turns([integrate.KERNEL],
                             lambda: integrate_cuda(out, depth, cam), 20, ms,
                             "integrate 512^3 one frame")
    # the work of that second frame: every voxel is projected, a voxel
    # in front of the camera is divided and rounded to its pixel, an
    # updated voxel reads and writes tsdf and weight (16 B)
    updated = int((ref.weight > before.weight).sum())
    in_front = voxels_in_front(ref, cam)
    ops = INTEGRATE_OPS
    least = bound(
        16 * updated + depth.numel() * 4,
        ops["voxel"] * SIZE**3 + ops["in_front"] * in_front
        + ops["updated"] * updated)
    log(f"integrate 512^3 one frame: kernel {ms:.4f} ms, "
        f"bound {least['bound_ms']:.4f} ms by {least['bound_by']} "
        f"({updated} voxels updated, {in_front} in front of the camera); "
        f"{culled:.4f} of the bricks culled; a frame with no depth "
        f"{zero_depth_ms:.4f} ms (every brick culled)")
    return dict(max_abs_err=err, ms=ms, **least,
                library_ms=None, zero_depth_ms=zero_depth_ms,
                culled_share=culled, parent_ms=parent)


def compare_integrate_variants(dev, frames, rgbs) -> dict:
    """The colour (exact), fast and colour-fast kernels against their
    plain twins at 512^3: the first two frames into one volume through the
    kernel and into another through the twin, compared after the second,
    which blends into weighted (and coloured) voxels. Everything must be
    equal: tsdf, weight, colour bytes, miss counts. For each (all three
    walk the bricks of integrate_bricks.cuh), the share of bricks culled
    and a frame with no depth (timed, with ``--parent`` the parent's too;
    the volume must not change)."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import integrate as kint
    from tsdf_tpu_torch.kernels.integrate import (
        brick_cull,
        integrate_color_cuda,
        integrate_fast_cuda,
    )
    from tsdf_tpu_torch.ops.integrate import integrate, integrate_fast

    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames]
    depths = [d for d, _ in frames]

    def twin(name, vol, i):
        if name == "integrate_color":
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return integrate(vol, depths[i], cams[i], rgb=rgbs[i]), zero
        rgb = rgbs[i] if name == "integrate_color_fast" else None
        return integrate_fast(vol, depths[i], cams[i], rgb=rgb)

    def kernel(name, vol, i, depth=None):
        depth = depths[i] if depth is None else depth
        if name == "integrate_fast":
            return integrate_fast_cuda(vol, depth, cams[i])
        mode = "fast" if name == "integrate_color_fast" else "exact"
        return integrate_color_cuda(vol, depth, rgbs[i], cams[i], mode=mode)

    wrappers = {"integrate_color": kint.KERNEL_COLOR,
                "integrate_fast": kint.KERNEL_FAST,
                "integrate_color_fast": kint.KERNEL_COLOR_FAST}

    # the masks of the second frame, from the twins on a cleared volume
    # and a white colour frame: a voxel is updated where its weight rose
    # and lies in the colour band where its colour left 0
    white = torch.full_like(rgbs[1], 255)
    blank = make_volume((SIZE,) * 3, PHYSICAL, with_color=True, device=dev)
    masks = {}
    for fast, fn in ((False, integrate), (True, integrate_fast)):
        out = fn(blank, depths[1], cams[1], rgb=white)
        out = out[0] if fast else out
        masks[fast] = (int((out.weight > 0).sum()),
                       int((out.color > 0).any(-1).sum()))
        del out
    in_front = voxels_in_front(blank, cams[1])
    del blank, white

    results = {}
    for name in ("integrate_color", "integrate_fast", "integrate_color_fast"):
        fast, color = name != "integrate_color", name != "integrate_fast"
        ref, out = (make_volume((SIZE,) * 3, PHYSICAL, with_color=color,
                                device=dev) for _ in range(2))
        for i in range(2):
            before = ref
            ref, want_miss = twin(name, ref, i)
            out, miss = kernel(name, out, i)
            check(int(miss) == int(want_miss),
                  f"{name}: miss count {int(miss)}, twin {int(want_miss)}")
        torch.cuda.synchronize()
        blended = int(((ref.weight > before.weight) & (before.weight > 0)).sum())
        n_w = int((out.weight != ref.weight).sum())
        n_t = int((out.tsdf != ref.tsdf).sum())
        err = float((out.tsdf - ref.tsdf).abs().max())
        text = (f"{name} 512^3, two frames: {n_w} weights and {n_t} tsdf "
                f"values differ (max |tsdf diff| {err:.3g} mm)")
        n_c = 0
        if color:
            n_c = int((out.color != ref.color).sum())
            recoloured = int(((ref.color != before.color).any(-1)
                              & (before.color > 0).any(-1)).sum())
            err = max(err, float((out.color.float() - ref.color.float()).abs().max()))
            text += (f", {n_c} colour bytes differ; the second frame changed "
                     f"the colour of {recoloured} coloured voxels")
            check(recoloured > 0, f"{name}: no coloured voxel was blended into")
        log(f"{text}; it blended into {blended} voxels of weight > 0; "
            f"miss {int(miss)}")
        check(blended > 0, f"{name}: the second frame blended into no voxel")
        check(n_w == 0 and n_t == 0 and n_c == 0,
              f"{name}: the kernel differs from its twin")

        ms = median_ms(lambda: kernel(name, out, 1), reps=20)
        # the bricks the kernel culls, and a frame with no depth: it must
        # leave the volume as it is
        extra = {"culled_share": float(
            brick_cull(out, depths[1], cams[1], fast=fast).float().mean())}
        no_depth = torch.zeros_like(depths[1])
        fields = [out.tsdf, out.weight] + ([out.color] if color else [])
        kept = [t.clone() for t in fields]

        def empty_frame():
            return kernel(name, out, 1, no_depth)

        extra["zero_depth_ms"] = median_ms(empty_frame, reps=20)
        extra["parent_zero_depth_ms"] = parent_ms([wrappers[name]],
                                                  empty_frame, 20)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(fields, kept)),
              f"{name}: a frame with no depth changed the volume")
        del kept
        log(f"{name}: {extra['culled_share']:.4f} of the bricks culled; a "
            f"frame with no depth {extra['zero_depth_ms']:.4f} ms (parent "
            f"{ms_text(extra['parent_zero_depth_ms'])}), the volume untouched")
        extra["parent_ms"] = parent_in_turns(
            [wrappers[name]], lambda: kernel(name, out, 1), 20, ms,
            f"{name} 512^3 one frame")
        # the work of that second frame: tsdf and weight read and written
        # where a voxel is updated (16 B), three colour bytes read and
        # written in the colour band (6 B), the images read once (the
        # fast convention can sample one pixel in eight)
        updated, band = masks[fast]
        check(updated == int((ref.weight > before.weight).sum()),
              f"{name}: the mask count disagrees with the frame's update")
        pixels = W * H // 8 if fast else W * H
        moved = 16 * updated + pixels * 4
        if fast:
            ops = (FAST_OPS["voxel"] * SIZE**3 + FAST_OPS["column"] * SIZE**2
                   + FAST_OPS["updated"] * updated)
        else:
            o = INTEGRATE_OPS
            ops = (o["voxel"] * SIZE**3 + o["in_front"] * in_front
                   + o["updated"] * updated)
        if color:
            moved += 6 * band + pixels * 3
            ops += COLOR_OPS_PER_BAND_VOXEL * band
        least = bound(moved, ops)
        log(f"{name} 512^3 one frame: kernel {ms:.4f} "
            f"ms, bound {least['bound_ms']:.4f} ms by {least['bound_by']} "
            f"({updated} voxels updated"
            + (f", {band} in the colour band" if color else "") + ")")
        results[name] = dict(max_abs_err=err, ms=ms,
                             **least, library_ms=None, **extra)
        del ref, out, before
    return results


def raycast_work(vol, cam) -> tuple[int, int, torch.Tensor, int]:
    """The work one render of ``vol`` from ``cam`` needs: the samples
    taken, the distinct voxels they read, the (H*W,) hit mask, and the
    samples whose lower corner lies in a uniform brick
    (``kernels.raycast.uniform_bricks``: the kernel reads no tap there).

    Counted by marching every ray with the sphere-traced rule of
    ``ops.raycast.march_rays`` (the same start, step and stops), one pass
    of all rays at a time."""
    from tsdf_tpu_torch.kernels.raycast import RAY_BRICK, uniform_bricks
    from tsdf_tpu_torch.ops.raycast import (
        REFERENCE_MAX_STEPS,
        ray_directions,
        slab_near_far,
    )
    from tsdf_tpu_torch.ops.trilinear import trilinear_sample

    dev = vol.tsdf.device
    sz, sy, sx = vol.tsdf.shape
    vs, trunc = vol.voxel_size, vol.truncation_distance
    far_face = torch.tensor([sx, sy, sz], dtype=torch.float32, device=dev) * vs
    touched = torch.zeros((sz, sy, sx), dtype=torch.bool, device=dev)
    samples = torch.zeros((), dtype=torch.int64, device=dev)
    uniform = torch.isfinite(uniform_bricks(vol.tsdf))
    in_uniform = torch.zeros((), dtype=torch.int64, device=dev)

    dirs = ray_directions(cam, W, H).reshape(-1, 3)
    origin = cam.position[None, :]
    near, far, active = slab_near_far(
        origin, dirs, vol.space_min[None, :], vol.space_max[None, :])
    start = origin + near[:, None] * dirs - vol.space_min[None, :]
    max_t = far - near
    t = torch.zeros_like(near)
    prev = t + trunc
    hit = torch.zeros_like(active)
    passes = 0
    while passes < REFERENCE_MAX_STEPS and bool(active.any()):
        pts = start + t[:, None] * dirs
        samples += active.sum()
        p = pts[active]
        p = torch.where(p >= far_face, far_face - vs / 10.0, p)  # the
        p = torch.where(p < 0.0, torch.zeros_like(p), p)  # sampler's border rules
        lo = torch.clamp(torch.floor(p / vs - 0.5), min=0.0).to(torch.int64)
        touched[lo[:, 2], lo[:, 1], lo[:, 0]] = True
        b = lo // RAY_BRICK
        in_uniform += uniform[b[:, 2], b[:, 1], b[:, 0]].sum()

        tsdf = trilinear_sample(vol.tsdf, pts, vs)
        new_t = t + torch.clamp(0.75 * tsdf, trunc * 0.05, trunc * 0.9)
        stops = (tsdf <= 0.0) | ((tsdf > 0.0) & (prev < 0.0)) | (new_t >= max_t)
        hit |= active & (tsdf <= 0.0)
        t = torch.where(active, new_t, t)
        prev = torch.where(active, tsdf, prev)
        active = active & ~stops
        passes += 1
    for dim in range(3):  # a sample reads its cell's eight corners
        upper = torch.zeros_like(touched)
        n = touched.shape[dim]
        upper.narrow(dim, 1, n - 1).copy_(touched.narrow(dim, 0, n - 1))
        touched |= upper
    return int(samples), int(touched.sum()), hit, int(in_uniform)


def compare_raycast(dev, vols: dict, pose) -> dict:
    """The kernel's vertices against the twin's on each volume of ``vols``
    (the analytic scene, then the volume the 20-frame fuse leaves): hit
    masks equal and vertices equal bit for bit where hit. Normals, plain
    in both, are outside the comparison and the times. Each volume's time,
    bound, share of samples in uniform bricks and the time of a render of
    no step (the brick table and the ray set-up) are logged; the first
    volume's numbers are the kernel's row, the others sit under their
    name."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.kernels.raycast import KERNEL, raycast_vertices_cuda
    from tsdf_tpu_torch.ops.raycast import raycast_vertices

    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(pose)
    rows = {}
    for name, vol in vols.items():
        vk = raycast_vertices_cuda(vol, cam, W, H)
        vp = raycast_vertices(vol, cam, W, H)
        torch.cuda.synchronize()
        hk = torch.isfinite(vk).all(-1)
        hp = torch.isfinite(vp).all(-1)
        n_samples, n_voxels, counted_hit, n_uniform = raycast_work(vol, cam)
        check(torch.equal(counted_hit, hp.reshape(-1)),
              "the counting march ends other rays on a hit than the twin")
        same_hits = torch.equal(hk, hp)
        equal = same_hits and torch.equal(vk[hk].view(torch.int32),
                                          vp[hp].view(torch.int32))
        both = hk & hp
        err = float((vk[both] - vp[both]).abs().max()) if bool(both.any()) else 0.0
        log(f"raycast 512^3 {W}x{H}, {name} volume: hit masks equal: "
            f"{same_hits} ({int(hk.sum())} hits), vertices equal bit for bit "
            f"where hit: {equal} (max abs diff {err:.3g} mm)")
        check(equal, f"raycast on the {name} volume differs from its twin")
        ms = median_ms(lambda: raycast_vertices_cuda(vol, cam, W, H), reps=10)
        prepass_ms = median_ms(
            lambda: raycast_vertices_cuda(vol, cam, W, H, max_steps=0), reps=10)
        parent = parent_in_turns(
            [KERNEL], lambda: raycast_vertices_cuda(vol, cam, W, H), 10, ms,
            f"raycast 512^3, {name} volume")
        least = bound(
            4 * n_voxels + 12 * W * H,
            RAYCAST_OPS["ray"] * W * H + RAYCAST_OPS["sample"] * n_samples)
        log(f"raycast 512^3 {W}x{H} vertices, {name} volume: kernel {ms:.4f} "
            f"ms, bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({n_samples} samples, {n_voxels} distinct "
            f"voxels read); {n_uniform / n_samples:.4f} of the samples in "
            f"uniform bricks; a render of no step (brick table, ray set-up) "
            f"{prepass_ms:.4f} ms")
        rows[name] = dict(max_abs_err=err, ms=ms, **least,
                          library_ms=None, samples=n_samples,
                          uniform_share=n_uniform / n_samples,
                          prepass_ms=prepass_ms, parent_ms=parent)
    first, *others = rows
    return {**rows[first], **{name: rows[name] for name in others}}


def fused_volume(dev, frames):
    """The 512^3 volume ``fuse_frames`` leaves after the frames: the model
    the renders and the tracked loop raycast."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames

    cfg = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL)
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    vol, _ = fuse_frames(cfg.make_volume(device=dev), cam, frames, cfg)
    return vol


def hold_lane_gathers(calls, whats, n_timed=None) -> dict:
    """Each ``(table, idx)`` of ``calls`` through ``lane_gather_op`` and
    through ``take_or_zero``, which must agree bit for bit; the first
    ``n_timed`` of them (all by default) are timed, beside ``torch.gather``
    and the bound. ``whats[n]`` names call ``n`` in the log, beside the
    launch the kernel took. Returns the sums of the times and bounds, the
    largest |difference|, and the per-call values."""
    from tsdf_tpu_torch.kernels.gather import (
        lane_gather_launch,
        lane_gather_op,
        take_or_zero,
    )

    n_timed = len(calls) if n_timed is None else n_timed
    out = dict(max_abs_err=0.0, ms=0.0, library_ms=0.0,
               bound_ms=0.0, bound_by="bytes", each=[], launch_choices=[])
    for n, ((table, idx), what) in enumerate(zip(calls, whats)):
        launch, tile_rows = lane_gather_launch(
            idx.shape[1], table.shape[1], table.stride(0))
        out["launch_choices"].append(launch)
        shapes = (f"{tuple(table.shape)} -> {tuple(idx.shape)} ({what}; "
                  f"launch {launch}, tile {tile_rows} rows)")
        got = lane_gather_op(table, idx)
        want = take_or_zero(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"lane gather differs at {shapes}")
        out["max_abs_err"] = max(
            out["max_abs_err"], float((got.double() - want.double()).abs().max()))
        del got, want
        if n >= n_timed:
            log(f"lane gather {shapes}: bit-equal")
            continue
        ms = median_ms(lambda: lane_gather_op(table, idx), reps=10, inner=10)
        # the one PyTorch call for the same function; it takes int64
        # indices inside the table, prepared outside the timing
        idx64 = idx.clamp(0, table.shape[1] - 1).to(torch.int64)
        library_ms = median_ms(
            lambda: torch.gather(table, 1, idx64), reps=10, inner=10)
        # index read and output written once, the table's own words once
        words = table.shape[1] if table.stride(0) == 0 else table.numel()
        least = bound(4 * (2 * idx.numel() + words), idx.numel())
        check(least["bound_by"] == "bytes", "lane gather bound")
        log(f"lane gather {shapes}: bit-equal; kernel {ms:.4f} ms, "
            f"torch.gather {library_ms:.4f} ms, bound "
            f"{least['bound_ms']:.4f} ms by bytes")
        each = dict(ms=ms, library_ms=library_ms,
                    bound_ms=least["bound_ms"], launch=launch)
        for key in ("ms", "library_ms", "bound_ms"):
            out[key] += each[key]
        out["each"].append(each)
    return out


def compare_gather(dev, vol, depth_prev: torch.Tensor) -> dict:
    """The four lane-gather calls of one dense extraction of ``vol``,
    recorded from the extraction itself: vertex counts (n_occ x 1 from a
    256-word broadcast table), triangle table (max_cubes x 24 from 6144
    words), slot vertices (max_cubes x 72 from 36-word rows), slot voxels
    (max_cubes x 48 from 24-word int rows); and the ICP association's
    lookup into the model depth ``depth_prev`` on each pyramid level,
    (H, W) down to (H/4, W/4). The times are sums over the first five: of
    the ICP lookups only level 0's is timed."""
    from tsdf_tpu_torch.ops import marching_cubes
    from tsdf_tpu_torch.tracking.icp import depth_pyramid

    calls = []
    with recorded(marching_cubes, "lane_gather_op", calls):
        soup = marching_cubes.extract_surface(
            vol, max_cubes=MAX_CUBES, max_vertices=MAX_VERTICES)
    check(not bool(soup.overflowed), "the 512^3 extraction overflowed")
    del soup
    n_occ = calls[0][1].shape[0]
    shapes = [(tuple(t.shape), tuple(i.shape)) for t, i in calls]
    check(0 < n_occ <= MAX_CUBES and shapes == [
        ((n_occ, 256), (n_occ, 1)),
        ((MAX_CUBES, 256 * 24), (MAX_CUBES, 24)),
        ((MAX_CUBES, 36), (MAX_CUBES, 72)),
        ((MAX_CUBES, 24), (MAX_CUBES, 48))],
        f"the dense extraction's lane gathers have shapes {shapes}")
    whats = ["marching cubes"] * 4
    # the ICP association's lookup on each pyramid level: three taps per
    # pixel by linear pixel index over the model depth image as one
    # broadcast row (a shift of a few pixels; -1 where the tap would
    # leave the image). Level 0 comes first: it alone is timed.
    n_timed = len(calls) + 1
    for level in depth_pyramid(depth_prev):
        h, w = level.shape
        ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None] + 3
        xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :] - 5
        inside = (ys >= 0) & (ys < h - 1) & (xs >= 0) & (xs < w - 1)
        lin = torch.where(inside, ys * w + xs, torch.full_like(ys * w + xs, -1))
        icp_idx = torch.cat([lin, lin + 1, lin + w], dim=1).contiguous()
        calls.append((level.contiguous().reshape(1, -1).expand(h, -1), icp_idx))
        whats.append("ICP lookup" if len(calls) == n_timed
                     else "ICP lookup, a coarser level")
    check([tuple(i.shape) for _, i in calls[-3:]]
          == [(H, 3 * W), (H // 2, 3 * W // 2), (H // 4, 3 * W // 4)],
          "ICP lookup shapes")

    out = hold_lane_gathers(calls, whats, n_timed)
    icp = out.pop("each")[-1]
    out.update({f"icp_lookup_{k}": v for k, v in icp.items()})
    log(f"lane gather, one extraction's four calls ({n_occ} occupied cubes, "
        f"max_cubes {MAX_CUBES}) and the ICP lookup of each level: bit-equal, "
        f"max |diff| {out['max_abs_err']:.3g}; timed without the two coarser "
        f"levels: kernel {out['ms']:.4f} ms, "
        f"torch.gather {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms")
    return out


def loaded_sm_clock_mhz(fn, seconds: float = 1.5) -> float:
    """The median SM clock nvidia-smi reads while ``fn`` runs back to back
    on the card for ``seconds``."""
    poll = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(500):
            fn()
        torch.cuda.synchronize()
    poll.terminate()
    readings = [float(v) for v in poll.communicate(timeout=30)[0].split()]
    # the first readings may predate the load
    return float(np.median(readings[len(readings) // 3:]))


def compare_bilateral(dev, depth: torch.Tensor) -> dict:
    """The bilateral kernel against its twin on a noisy frame with holes:
    float32 and uint16 at the default sigmas (radius 5), float32 at
    another pair (radius 3), both compiled instances; float32 at
    sigma_space 40 (radius 60: the runtime-radius instance, a block above
    48 KB of shared memory); the float32 frame with NaN, +inf, -inf and
    negative depths. Every comparison must be exact. With ``--parent``, the
    parent's kernel in turns on the radius-5 and radius-3 cases. Logs each
    instance's registers and launch plan, and beside the bound by the
    published peak the issue-rate floor: the instructions a tap of the
    radius-5 body (SASS) over the card's rate of issuing them."""
    from tsdf_tpu_torch.kernels import _build
    from tsdf_tpu_torch.kernels.bilateral import (
        KERNEL, bilateral_filter_cuda, launch_plan)
    from tsdf_tpu_torch.ops.bilateral import bilateral_filter, filter_radius
    from tsdf_tpu_torch.utils.fixtures import kinect_noise

    gen = torch.Generator(device=dev).manual_seed(7)
    noisy = kinect_noise(depth, gen).contiguous()
    holes = float((noisy == 0).float().mean())
    check(0.001 < holes < 0.5, f"noisy frame has {holes:.4f} holes")
    as_u16 = torch.round(noisy).to(torch.uint16)
    special = noisy.clone()
    for v in (float("nan"), float("inf"), -float("inf"), -250.0):
        special[torch.rand(noisy.shape, generator=gen, device=dev) < 0.001] = v
    other = "f32, sigmas %g/%g" % BILATERAL_OTHER_SIGMAS
    wide = "f32, sigma_space %g" % BILATERAL_WIDE_SIGMA_SPACE
    cases = {
        "f32": (noisy, ()),
        "u16": (as_u16, ()),
        other: (noisy, BILATERAL_OTHER_SIGMAS),
        wide: (noisy, (20.0, BILATERAL_WIDE_SIGMA_SPACE)),
        "f32, NaN/inf/negative depths": (special, ()),
    }
    out = {}
    for name, (d, sigmas) in cases.items():
        got = bilateral_filter_cuda(d, *sigmas)
        want = bilateral_filter(d, *sigmas)
        torch.cuda.synchronize()
        check(got.dtype == d.dtype, "bilateral dtype")
        if d.dtype == torch.uint16:
            equal = torch.equal(got.to(torch.int32), want.to(torch.int32))
        else:  # NaN too: one bit pattern for every NaN result on the card
            equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
        diff = (got.double() - want.double()).abs()
        err = float(diff.nan_to_num(0.0).max())
        nans = int(torch.isnan(want.float()).sum())
        ms = median_ms(
            lambda: bilateral_filter_cuda(d, *sigmas), reps=10, inner=10)
        plan = launch_plan(filter_radius(sigmas[1] if sigmas else 3.0),
                           *d.shape)
        log(f"bilateral {W}x{H} {name}: bit-equal {equal} (max |diff| "
            f"{err:.3g}, {nans} NaN in the twin), kernel {ms:.4f} ms; "
            f"instance {plan.instance or 'runtime radius'},"
            f" {plan.block[0]}x{plan.block[1]} threads x {plan.rows} rows, "
            f"grid {plan.grid[0]}x{plan.grid[1]}, {plan.shared_bytes} B of "
            f"shared memory")
        check(equal, f"bilateral kernel differs from its twin ({name})")
        check(not bool(((d == 0) & (got.to(torch.float32) != 0)).any()),
              "bilateral filled a hole")
        parent = None
        if name in ("f32", "u16", other):
            parent = parent_in_turns(
                [KERNEL], lambda: bilateral_filter_cuda(d, *sigmas), 10, ms,
                f"bilateral {name}", inner=10)
        out[name] = dict(max_abs_err=err, ms=ms, parent_ms=parent)
    # the work the float32 default case needs: a tap counts where the
    # centre and the tap both hold data; the image is read and written once
    side = 2 * filter_radius(3.0) + 1
    valid = (noisy > 0).float()[None, None]
    taps = torch.nn.functional.avg_pool2d(
        valid, side, stride=1, padding=side // 2, divisor_override=1)
    pairs = int((valid * taps).sum())
    least = bound(2 * noisy.numel() * 4 + side * side * 4,
                  BILATERAL_OPS_PER_TAP * pairs)
    # the issue-rate floor: every tap of every pixel runs the unrolled body
    # (a tap with no data too), a warp issues one instruction for its 32
    # threads, an SM issues 4 a clock
    registers = kernel_registers(
        [f"bilateral_stripI{t}Li{r}E" for r in (5, 3, 0) for t in "ft"])
    body = sass_loop(str(_build.library_path()),
                     str(_build.BUILD_DIR / "build.log"), "bilateral_stripIfLi5E")
    per_tap = body["instructions_per_expf"]
    mhz = loaded_sm_clock_mhz(lambda: bilateral_filter_cuda(noisy))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    issue_floor = (per_tap * noisy.numel() * side * side / 32
                   / (4 * sms * mhz * 1e6) * 1e3)
    log(f"bilateral {W}x{H} f32: {pairs} valid taps of "
        f"{noisy.numel() * side * side}, bound {least['bound_ms']:.4f} ms by "
        f"{least['bound_by']}; {holes:.4f} of the frame is holes")
    log(f"bilateral instances' registers: {registers}; the radius-5 float32 "
        f"body: {body['instructions']} SASS instructions, {body['expf']} expf")
    log(f"bilateral issue-rate floor: {per_tap:.3f} instructions a tap x "
        f"{noisy.numel() * side * side} taps / 32 / (4 x {sms} SMs x "
        f"{mhz:.0f} MHz, the SM clock nvidia-smi reads under the kernel) = "
        f"{issue_floor:.4f} ms; kernel {out['f32']['ms']:.4f} ms, "
        f"{issue_floor / out['f32']['ms']:.3f} of the floor's rate")
    return dict(**out["f32"], **least, library_ms=None,
                issue_floor_ms=issue_floor, instructions_per_tap=per_tap,
                sm_clock_mhz=mhz,
                registers=registers,
                u16_ms=out["u16"]["ms"],
                u16_parent_ms=out["u16"]["parent_ms"],
                r3_ms=out[other]["ms"], r3_parent_ms=out[other]["parent_ms"],
                r60_ms=out[wide]["ms"],
                nan_inf_ms=out["f32, NaN/inf/negative depths"]["ms"])


def fuse_argv(dev, tum: str, out_dir: str, extra=(), mesh=True, tsdf=True,
              color=False) -> tuple[list[str], dict]:
    """A main path's ``fuse`` command line and its output files: the two
    renders always, the mesh, the .tsdf and the colour render as asked."""
    names = [("scene", "scene.png"), ("normals", "normals.png")]
    names += [("tsdf", "out.tsdf")] * tsdf + [("mesh", "mesh.ply")] * mesh
    names += [("color", "color.png")] * color
    outs = {k: os.path.join(out_dir, f) for k, f in names}
    argv = [
        "fuse", "-d", tum, "-m", str(N_FRAMES), "-s", str(SIZE),
        "--physical", str(PHYSICAL), "--device", dev.type,
        "--scene", outs["scene"], "--normals", outs["normals"],
        "--mesh", outs.get("mesh", ""),
        "--max-cubes", str(MAX_CUBES), "--max-vertices", str(MAX_VERTICES),
    ]
    if tsdf:
        argv += ["-o", outs["tsdf"]]
    if color:
        argv += ["--color", outs["color"]]
    return argv + list(extra), outs


def run_fuse(dev, tum: str, out_dir: str, extra=(), **outputs) -> dict:
    """Drive ``cli.main(["fuse", ...])`` with every launch count set to 0
    just before and read just after; check the return code and the output
    files. Returns the outputs, the counts and what the command printed."""
    from tsdf_tpu_torch import cli
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    argv, outs = fuse_argv(dev, tum, out_dir, extra, **outputs)
    err, out = io.StringIO(), io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    sys.stderr.write(err.getvalue())
    log(out.getvalue().rstrip())
    log(f"fuse {' '.join(extra)}: rc {rc} in {seconds:.2f} s; launches {counts}")
    check(rc == 0, f"fuse returned {rc}")
    for k, path in outs.items():
        check(os.path.getsize(path) > 0, f"missing output {k}")
    check("overflowed" not in err.getvalue(), "mesh buffers overflowed")
    check("skipped" not in err.getvalue(), "the integrate skipped voxels")
    header = []
    if "mesh" in outs:
        with open(outs["mesh"]) as f:
            for line in f:
                header.append(line.strip())
                if header[-1] == "end_header":
                    break
        (n_vert,) = [int(h.split()[-1]) for h in header
                     if h.startswith("element vertex")]
        (n_face,) = [int(h.split()[-1]) for h in header
                     if h.startswith("element face")]
        log(f"mesh: {n_vert} vertices, {n_face} triangles")
        check(n_vert > 0 and n_vert == 3 * n_face, "mesh is empty or torn")
    return dict(outs=outs, counts=counts, stdout=out.getvalue(),
                seconds=seconds, ply_header=header)


def check_counts(counts: dict, what: str, at_least=None, **exact) -> None:
    """Each kernel named in ``exact`` was launched that many times, each in
    ``at_least`` no fewer, and every other kernel not at all."""
    at_least = at_least or {}
    for name, n in counts.items():
        if name in at_least:
            check(n >= at_least[name],
                  f"{what}: {name} launched {n} times, expected >= {at_least[name]}")
        else:
            check(n == exact.get(name, 0),
                  f"{what}: {name} launched {n} times, expected {exact.get(name, 0)}")


def phase_gt_path(dev, tum: str, out_dir: str) -> dict:
    run = run_fuse(dev, tum, out_dir)
    check_counts(run["counts"], "GT-pose path", at_least=dict(lane_gather=1),
                 integrate=N_FRAMES, raycast=1)
    return run


def phase_icp_verb(dev, tsdf_path: str, out_dir: str) -> dict:
    """``cli.main(["icp", ...])`` on the fused volume: the model is seen
    from the identity pose (the saved volume's global pose is zero), the
    depth PNG is the analytic scene from a pose a small known motion away,
    and the printed T_prev_curr must be that motion. On the card the verb
    renders its model depth with the raycast kernel, once."""
    import re

    from tsdf_tpu_torch import cli
    from tsdf_tpu_torch.io.png import save_png
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    (tx, ty, tz), angle = ICP_VERB_MOTION
    c, s = math.cos(angle), math.sin(angle)
    motion = np.array([[c, 0, s, tx], [0, 1, 0, ty], [-s, 0, c, tz],
                       [0, 0, 0, 1.0]])
    png = os.path.join(out_dir, "icp_depth.png")
    save_png(png, np.clip(np.round(analytic_depth(motion)), 0, 65535)
             .astype(np.uint16))
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["icp", "-v", tsdf_path, "-d", png, "--device", dev.type])
    torch.cuda.synchronize()
    counts = launch_counts()
    os.remove(png)
    log(out.getvalue().rstrip())
    log(f"icp: rc {rc}; launches {counts}")
    check(rc == 0, f"icp returned {rc}")
    check(counts["raycast"] == 1, "icp verb raycast launches")
    check(counts["integrate"] == 0 and counts["bilateral"] == 0,
          "the icp verb fused or filtered")
    text = out.getvalue()
    matrix = text[text.index("(T_prev_curr):"):text.index("lastError=")]
    values = [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", matrix)]
    check(len(values) == 16, "no 4x4 pose printed")
    got = np.array(values).reshape(4, 4)
    trans_err = float(np.linalg.norm(got[:3, 3] - motion[:3, 3]))
    r = got[:3, :3].T @ motion[:3, :3]
    rot_err = float(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
    inliers = int(re.search(r"lastInliers=(\d+)", text).group(1))
    log(f"icp: recovered the motion to {trans_err:.4f} mm and "
        f"{rot_err * 1e3:.4f} mrad, {inliers} inliers")
    check(trans_err < ICP_VERB_TRANS_MM, "icp verb translation")
    check(rot_err < ICP_VERB_ROT_RAD, "icp verb rotation")
    check(inliers > 0.02 * W * H, "icp verb inliers")
    return counts


def equal_volumes(a, b) -> bool:
    """Every field of two volumes equal bit for bit (None where None)."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            return False
    return True


def api_integrate(dev, frames, rgbs, smi: str) -> None:
    """The root ``integrate`` against the wrapper its route names: two
    frames into a 512^3 volume each way, bit-equal, two launches each;
    then the same with colour frames against ``integrate_color_cuda``."""
    from tsdf_tpu_torch import Camera, integrate, make_volume
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.integrate import (
        integrate_color_cuda,
        integrate_cuda,
    )

    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames[:2]]
    for what, kernel, color in (("integrate", "integrate", False),
                                ("integrate(rgb=)", "integrate_color", True)):
        vols = []
        for route in ("root", "wrapper"):
            vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev,
                              with_color=color)
            reset_launch_counts()
            for (depth, _), rgb, cam in zip(frames, rgbs, cams):
                if route == "root":
                    vol = integrate(vol, depth, cam, rgb=rgb if color else None)
                elif color:
                    vol, _miss = integrate_color_cuda(vol, depth, rgb, cam,
                                                      mode="exact")
                else:
                    vol = integrate_cuda(vol, depth, cam)
            torch.cuda.synchronize()
            check_counts(launch_counts(), f"api: {what}, {route}",
                         **{kernel: 2})
            vols.append(vol)
        same = equal_volumes(*vols)
        log(f"api: root {what} against {kernel}_cuda at 512^3, two frames: "
            f"bit-equal {same}, {kernel} launched 2 and 2 times ({smi})")
        check(same, f"api: root {what} differs from {kernel}_cuda")
        del vols, vol
        torch.cuda.empty_cache()


def api_icp_step(dev, frames, smi: str) -> None:
    """The stacked ``icp_step_banded`` against the planar form at level 0
    of the tracked loop's first frame (the filtered second frame against
    the model depth of the volume the first one fused), one lane-gather
    launch each."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.bilateral import bilateral_filter_cuda
    from tsdf_tpu_torch.kernels.integrate import integrate_cuda
    from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
    from tsdf_tpu_torch.ops.raycast import vertices_to_camera_depth
    from tsdf_tpu_torch.tracking.icp import (
        icp_step_banded,
        icp_step_banded_planes,
        normal_map,
        normal_map_planes,
        vertex_map,
        vertex_map_planes,
    )

    vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(
        frames[0][1])
    integrate_cuda(vol, frames[0][0], cam)

    cfg = tracked_config()
    model = vertices_to_camera_depth(raycast_vertices_cuda(vol, cam, W, H),
                                     cam.pose_inv)
    current = bilateral_filter_cuda(frames[1][0], cfg.sigma_colour,
                                    cfg.sigma_space)
    rot = torch.eye(3, dtype=torch.float32, device=dev)
    trans = torch.zeros(3, dtype=torch.float32, device=dev)
    intr = (FX, FY, CX, CY)
    vc = vertex_map_planes(current, *intr)
    planar, stacked = None, None
    for what in ("planar", "stacked"):
        reset_launch_counts()
        if what == "planar":
            planar = icp_step_banded_planes(
                rot, trans, vc, normal_map_planes(*vc), model, *intr,
                band=cfg.icp_band)
        else:
            vmap = vertex_map(current, *intr)
            stacked = icp_step_banded(rot, trans, vmap, normal_map(vmap),
                                      model, *intr, band=cfg.icp_band)
        torch.cuda.synchronize()
        check_counts(launch_counts(), f"api: icp_step_banded, {what}",
                     lane_gather=1)
    same = all(torch.equal(a, b) for a, b in zip(planar, stacked))
    inliers = int(planar[3])
    log(f"api: stacked icp_step_banded against the planar form at level 0 of "
        f"the first tracked frame: A, b, residual and inliers bit-equal {same} "
        f"({inliers} inliers), one lane-gather launch each ({smi})")
    check(inliers > 0.02 * W * H, "api: too few ICP inliers")
    check(same, "api: stacked icp_step_banded differs from the planar form")


def api_checkpoint(dev, frames, tmp: str, smi: str) -> None:
    """Fuse two frames, ``save_sharded``, ``load_sharded`` onto a fresh
    volume, fuse two more: bit-equal with four frames fused straight."""
    from tsdf_tpu_torch import Camera, integrate, make_volume
    from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames[:4]]
    straight = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    for (depth, _), cam in zip(frames, cams):
        integrate(straight, depth, cam)
    vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    for (depth, _), cam in zip(frames[:2], cams[:2]):
        integrate(vol, depth, cam)
    path = os.path.join(tmp, "checkpoint")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_sharded(vol, path)
    save_s = time.perf_counter() - t0
    del vol
    like = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    t0 = time.perf_counter()
    vol = load_sharded(path, like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del like
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    for (depth, _), cam in zip(frames[2:4], cams[2:4]):
        integrate(vol, depth, cam)
    torch.cuda.synchronize()
    same = equal_volumes(vol, straight)
    log(f"api: checkpoint at 512^3: save_sharded {save_s:.3f} s, load_sharded "
        f"{load_s:.3f} s, {size} bytes; 2 frames + resume + 2 frames bit-equal "
        f"with 4 straight: {same} ({smi})")
    check(same, "api: the resumed fusion differs from the straight one")
    shutil.rmtree(path)


def api_view(dev, tsdf_path: str, out_dir: str, smi: str) -> None:
    """``cli.main(["view", ...])`` on the GT-pose path's 512^3 .tsdf; the
    three tiles computed on the card against the same computed on the
    CPU, byte for byte, and each PNG the verb wrote against its tile."""
    from tsdf_tpu_torch import cli
    from tsdf_tpu_torch.io.png import load_png
    from tsdf_tpu_torch.io.tsdf_file import load_tsdf
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    view_dir = os.path.join(out_dir, "view")
    out = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["view", "-f", tsdf_path, "-o", view_dir,
                       "--device", dev.type])
    seconds = time.perf_counter() - t0
    log(out.getvalue().rstrip())
    check(rc == 0, f"view returned {rc}")
    check_counts(launch_counts(), "api: view")
    vol = load_tsdf(tsdf_path, device=dev)
    card = [(n, t.cpu()) for n, t in cli.view_tiles(vol)]
    del vol
    torch.cuda.empty_cache()
    host = cli.view_tiles(load_tsdf(tsdf_path, device=torch.device("cpu")))
    shapes = []
    for (name, a), (_, b) in zip(card, host):
        png = load_png(os.path.join(view_dir, f"{name}.png"))
        shapes.append(f"{name} {tuple(a.shape)}")
        check(torch.equal(a, b), f"api: view tile {name}: card != CPU")
        check(np.array_equal(png, a.numpy()), f"api: view {name}.png != tile")
    log(f"api: view of the 512^3 .tsdf in {seconds:.2f} s ({', '.join(shapes)}"
        f"): tiles on the card byte-equal with the CPU's, PNGs equal to them "
        f"({smi})")
    shutil.rmtree(view_dir)


def api_profiling(dev, frames, tmp: str, smi: str) -> None:
    """One ``Timer`` span and one ``profile_to`` trace around a fused
    frame: the span logs one JSON line with a positive ``ms``, the trace
    is a file."""
    import logging

    from tsdf_tpu_torch import Camera, integrate, make_volume
    from tsdf_tpu_torch.utils import profiling

    depth, pose = frames[0]
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(pose)
    vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    integrate(vol, depth, cam)  # warm
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    profiling.log.addHandler(handler)
    level = profiling.log.level
    profiling.log.setLevel(logging.INFO)
    trace_dir = os.path.join(tmp, "trace")
    try:
        with profiling.profile_to(trace_dir):
            with profiling.Timer("integrate", voxels=SIZE**3) as t:
                with profiling.trace("api integrate"):
                    t.result = integrate(vol, depth, cam)
    finally:
        profiling.log.removeHandler(handler)
        profiling.log.setLevel(level)
    span = json.loads(records[0].getMessage())
    files = [f for f in os.listdir(trace_dir)
             if os.path.isfile(os.path.join(trace_dir, f))]
    size = sum(os.path.getsize(os.path.join(trace_dir, f)) for f in files)
    log(f"api: Timer span {span} ; profile_to wrote {files} ({size} bytes) "
        f"({smi})")
    check(len(records) == 1 and span["span"] == "integrate" and span["ms"] > 0,
          "api: the Timer span")
    check(size > 0, "api: profile_to wrote no trace file")
    shutil.rmtree(trace_dir)


def phase_api(dev, frames, rgbs, tsdf_path: str, tmp: str, smi: str) -> None:
    """The package-level API and the verbs and utilities ported with it:
    the root integrate against the wrappers its routes name, the stacked
    ICP step against the planar one, a checkpoint resume at 512^3, the
    ``view`` verb, and the profiling helpers. Any mismatch fails the
    run."""
    api_integrate(dev, frames, rgbs, smi)
    torch.cuda.empty_cache()
    api_icp_step(dev, frames, smi)
    torch.cuda.empty_cache()
    api_checkpoint(dev, frames, tmp, smi)
    torch.cuda.empty_cache()
    api_view(dev, tsdf_path, os.path.dirname(tsdf_path), smi)
    torch.cuda.empty_cache()
    api_profiling(dev, frames, tmp, smi)
    torch.cuda.empty_cache()


def phase_tracked_path(dev, tum: str, out_dir: str) -> dict:
    """``fuse --track --filter``: every later frame is filtered, rendered
    against, tracked (19 Gauss-Newton iterations, one lane-gather launch
    each) and fused; then the render (no mesh: the GT-pose and the colour
    path each extract one at this size)."""
    from tsdf_tpu_torch.pipelines import kinfu

    got = []
    with returned(kinfu, "track_and_fuse_frames", got):
        run = run_fuse(dev, tum, out_dir, ("--track", "--filter"), mesh=False)
    run["poses"] = [p.cpu().numpy() for p in got[0][2]]
    tracked = N_FRAMES - 1
    check_counts(run["counts"], "tracked path",
                 at_least=dict(lane_gather=19 * tracked),
                 bilateral=tracked, raycast=tracked + 1, integrate=N_FRAMES)
    check_tracked_output(run["stdout"], "frames")
    return run


def check_tracked_output(stdout: str, what: str) -> None:
    """The ``tracked N <what>; ...`` line and the ATE line of a tracked
    ``fuse``: every frame tracked, inliers on the last, ATE under a voxel."""
    import re

    found = re.search(
        rf"tracked (\d+) {what}; lastError=([0-9.]+)mm lastInliers=(\d+)",
        stdout)
    check(found is not None, f"no 'tracked N {what}' line")
    check(int(found.group(1)) == N_FRAMES, "tracked frame count")
    check(int(found.group(3)) > 0.02 * W * H, "too few inliers on the last frame")
    ate = re.search(r"ATE rmse=([0-9.]+)mm", stdout)
    check(ate is not None, "no ATE line")
    check(float(ate.group(1)) < ATE_MAX_MM,
          f"ATE {ate.group(1)} mm is not under one voxel")


def phase_surface(dev, outs: dict, first_pose: np.ndarray) -> float:
    """Raycast the saved volume from the first pose, as the CLI's render
    did, and measure the hits against the analytic scene."""
    from tsdf_tpu_torch import Camera, raycast
    from tsdf_tpu_torch.io.png import load_png
    from tsdf_tpu_torch.io.tsdf_file import load_tsdf

    vol = load_tsdf(outs["tsdf"], device=dev)
    check(tuple(vol.tsdf.shape) == (SIZE,) * 3, "saved volume shape")
    check(bool(torch.isfinite(vol.tsdf).all()), "non-finite tsdf")
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(
        torch.as_tensor(first_pose, dtype=torch.float32))
    verts, _ = raycast(vol, cam, W, H)
    hit = torch.isfinite(verts).all(-1)
    dist = surface_distance(verts[hit])
    med = float(dist.median())
    scene = load_png(outs["scene"])
    normals = load_png(outs["normals"])
    log(f"surface: {float(hit.float().mean()):.4f} of pixels hit, median "
        f"distance from the analytic surface {med:.4f} mm "
        f"(p99 {float(dist.quantile(0.99)):.3f} mm); scene.png "
        f"{scene.shape} max {scene.max()}, normals.png {normals.shape}")
    check(float(hit.float().mean()) > 0.5, "raycast hit too few pixels")
    check(med < SURFACE_MEDIAN_MM, "raycast hits far from the surface")
    check(scene.shape == (H, W) and scene.max() > 50, "scene.png")
    check(normals.shape == (H, W, 3), "normals.png")
    return med


def load_frames(dev, tum: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Every (depth mm f32, pose) of the TUM directory, on the card."""
    from tsdf_tpu_torch.io.tum import TUMDataLoader

    return [
        (torch.from_numpy(d.data.astype(np.float32)).to(dev),
         torch.as_tensor(p, dtype=torch.float32, device=dev))
        for d, p in TUMDataLoader(tum)
    ]


def load_rgbs(dev, tum: str) -> list[torch.Tensor]:
    """Every (H, W, 3) u8 colour frame of the TUM directory, on the card."""
    from tsdf_tpu_torch.io.tum import TUMDataLoader

    return [torch.from_numpy(rgb).to(dev)
            for _, _, rgb in TUMDataLoader(tum).iter_with_rgb()]


def tracked_config():
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig

    return FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                        width=W, height=H, use_bilateral_filter=True)


def phase_tracked_loop(dev, frames, gt_poses) -> None:
    """The tracked loop on frames already on the card, under torch's sync
    debug mode: the trajectory error under one voxel, no lost frame, and
    at most one host sync a tracked frame."""
    import traceback
    import warnings

    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines.kinfu import track_and_fuse_frames
    from tsdf_tpu_torch.utils.trajectory import ate, rpe

    cfg = tracked_config()
    depths = [d for d, _ in frames]
    cam0 = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(frames[0][1])
    tracked = len(depths) - 1
    vol = cfg.make_volume(device=dev)
    torch.cuda.synchronize()
    syncs = []  # (file, line, the stack that led there)

    def note(message, category, filename, lineno, file=None, line=None):
        # every sync warns "called a synchronizing CUDA operation";
        # switching the mode on warns once that it is a prototype
        if "synchronizing" in str(message) and "prototype" not in str(message):
            syncs.append((filename, lineno, traceback.extract_stack()[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _vol, _cam, poses, stats = track_and_fuse_frames(
                vol, cam0, depths, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    est = [p.cpu().numpy() for p in poses]
    a, r = ate(est, gt_poses), rpe(est, gt_poses)
    inliers = [int(n) for _, n in stats[1:]]
    per_frame = len(syncs) / tracked
    log(f"tracked loop on the device, 512^3 {W}x{H}: ATE rmse "
        f"{a['rmse']:.4f} mm (max {a['max']:.4f}), RPE trans "
        f"{r['trans_rmse']:.4f} mm/frame rot {r['rot_rmse'] * 1e3:.4f} mrad/frame; "
        f"inliers {min(inliers)}..{max(inliers)}; host syncs: {len(syncs)} in "
        f"{tracked} tracked frames ({per_frame:.3f} per frame)")
    places = {}
    for filename, lineno, stack in syncs:
        places.setdefault((filename, lineno), []).append(stack)
    for (filename, lineno), stacks in places.items():
        via = " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                          for f in reversed(stacks[0][-4:]))
        log(f"  {len(stacks)} at {filename}:{lineno} ({via})")
    check(a["rmse"] < ATE_MAX_MM, "tracked loop ATE is not under one voxel")
    check(min(inliers) > 0.02 * W * H, "a frame was lost")
    check(len(syncs) <= tracked, "more than one host sync per tracked frame")


def check_color_render(path: str, first_rgb: np.ndarray, what: str) -> float:
    """The colour render from the first pose against the analytic colour
    of each pixel's hit point, which is the first colour frame itself."""
    from tsdf_tpu_torch.io.png import load_png

    img = load_png(path)
    check(img.shape == (H, W, 3) and img.dtype == np.uint8, f"{what}: color.png")
    hit = img.any(-1)  # a missed ray is black; no surface is
    diff = np.abs(img.astype(np.int32) - first_rgb.astype(np.int32))[hit]
    mean, far = float(diff.mean()), float((diff > COLOR_FAR_LEVELS).mean())
    log(f"{what}: colour render hit {hit.mean():.4f} of the pixels; against "
        f"the analytic colour: mean |diff| {mean:.4f} levels, "
        f"{far:.5f} of the channels off by more than {COLOR_FAR_LEVELS} "
        f"(max {int(diff.max())})")
    check(hit.mean() > 0.5, f"{what}: the colour render hit too few pixels")
    check(mean < COLOR_MEAN_LEVELS, f"{what}: colour render far from analytic")
    check(far < COLOR_FAR_SHARE, f"{what}: too many pixels far from analytic")
    return mean


def phase_color_path(dev, tum: str, out_dir: str, frames, rgbs) -> dict:
    """``fuse --fuse-color --color``: every frame through the colour
    kernel, the colour render, the coloured PLY and a .tsdf whose fields
    equal an in-process fuse of the same frames."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.io.tsdf_file import load_tsdf
    from tsdf_tpu_torch.kernels.integrate import KERNEL_COLOR
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run = run_fuse(dev, tum, out_dir, ("--fuse-color",), color=True)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"fuse --fuse-color: own peak device memory {peak:.3f} GiB")
    check_counts(run["counts"], "colour path", at_least=dict(lane_gather=1),
                 integrate_color=N_FRAMES, raycast=1)
    check(f"fused {N_FRAMES} frames with colour" in run["stdout"],
          "no 'fused N frames with colour' line")
    check(all(f"property uchar {c}" in run["ply_header"]
              for c in ("red", "green", "blue")),
          "the PLY header lacks the three uchar colour properties")
    with open(run["outs"]["mesh"]) as f:
        rows = [next(f).split() for _ in range(len(run["ply_header"]) + 3)]
    check(all(len(r) == 6 for r in rows[-3:]), "PLY vertex rows lack colours")
    check_color_render(run["outs"]["color"], rgbs[0].cpu().numpy(), "colour path")

    cfg = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL)
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    triples = [(d, p, c) for (d, p), c in zip(frames, rgbs)]
    vol, _ = fuse_frames(cfg.make_volume(device=dev).with_color(), cam, triples, cfg)
    saved = load_tsdf(run["outs"]["tsdf"], device=dev)
    check(saved.color is not None and saved.color.dtype == torch.uint8,
          "the saved volume has no colour")
    for field in ("tsdf", "weight", "color"):
        check(torch.equal(getattr(saved, field), getattr(vol, field)),
              f"the reloaded .tsdf's {field} differs from an in-process fuse")
    coloured = int((vol.color > 0).any(-1).sum())
    log(f"colour path: .tsdf reloads with tsdf, weight and colour equal to an "
        f"in-process fuse; {coloured} voxels hold colour")
    check(coloured > 0, "no voxel holds colour")
    del saved
    ms = median_ms(lambda: fuse_frames(vol, cam, triples, cfg), reps=3) / len(triples)
    log(f"colour fuse loop on the device, 512^3: {ms:.4f} ms/frame (median of "
        f"3 runs of {len(triples)} frames already on the card)")
    parent = parent_ms([KERNEL_COLOR],
                       lambda: fuse_frames(vol, cam, triples, cfg), 3)
    if parent is not None:
        log(f"colour fuse loop on the device, the parent's colour kernel: "
            f"{parent / len(triples):.4f} ms/frame")
    run.update(peak_gib=peak, fuse_ms_per_frame=ms)
    return run


def phase_color_tracked_path(dev, tum: str, out_dir: str, rgbs) -> dict:
    """``fuse --fuse-color --track --filter``: the tracked loop with the
    colour kernel in place of the depth one (renders only: no mesh, no
    .tsdf)."""
    run = run_fuse(dev, tum, out_dir, ("--fuse-color", "--track", "--filter"),
                   mesh=False, tsdf=False, color=True)
    tracked = N_FRAMES - 1
    check_counts(run["counts"], "tracked colour path",
                 at_least=dict(lane_gather=19 * tracked),
                 bilateral=tracked, raycast=tracked + 1, integrate_color=N_FRAMES)
    check_tracked_output(run["stdout"], "colour frames")
    check_color_render(run["outs"]["color"], rgbs[0].cpu().numpy(),
                       "tracked colour path")
    return run


def phase_fast(dev, frames, rgbs, gt_poses) -> dict:
    """``FusionConfig(integrate_mode="fast")`` through ``fuse_frames``
    (depth, and depth + colour) and ``track_and_fuse_frames``, each with
    the launch counts set to 0 just before and read just after; the fused
    fields against the exact fusion of the same frames and the analytic
    surface; ms/frame of the fast and the exact fuse loop side by side."""
    import warnings

    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.kernels import integrate as kint
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
    from tsdf_tpu_torch.pipelines.kinfu import (
        FusionConfig,
        fuse_frames,
        track_and_fuse_frames,
    )
    from tsdf_tpu_torch.utils.trajectory import ate

    exact = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                         width=W, height=H, integrate_mode="exact")
    fast = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                        width=W, height=H, integrate_mode="fast")
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    cam0 = cam.set_pose(frames[0][1])
    triples = [(d, p, c) for (d, p), c in zip(frames, rgbs)]
    n = len(frames)

    def counted(fn, what, **want):
        """Run ``fn`` with fresh counts; no voxel may be skipped."""
        reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"{what}: launches {counts}")
        check(not [w for w in caught if "skipped" in str(w.message)],
              f"{what}: the fast integrate skipped voxels (miss > 0)")
        check_counts(counts, what, **want)
        return out, counts

    def surface_median(vol):
        verts = raycast_vertices_cuda(vol, cam0, W, H)
        hit = torch.isfinite(verts).all(-1)
        check(float(hit.float().mean()) > 0.5, "raycast hit too few pixels")
        return float(surface_distance(verts[hit]).median())

    def tsdf_gap(a, b):
        both = (a.weight > 0) & (b.weight > 0)
        gap = (a.tsdf - b.tsdf)[both].abs()
        same_w = float((a.weight == b.weight).float().mean())
        p99 = gap.kthvalue(max(1, int(0.99 * gap.numel()))).values
        return float(gap.mean()), float(p99), same_w

    # GT poses, depth only
    ref, _ = fuse_frames(exact.make_volume(device=dev), cam, frames, exact)
    (vol, _), fuse_counts = counted(
        lambda: fuse_frames(fast.make_volume(device=dev), cam, frames, fast),
        "fuse_frames, fast", integrate_fast=n)
    mean, p99, same_w = tsdf_gap(ref, vol)
    med = surface_median(vol)
    log(f"fast against exact fusion of {n} frames, 512^3: weights equal on "
        f"{same_w:.6f} of the voxels; |tsdf diff| on voxels both updated: mean "
        f"{mean:.4f} mm, p99 {p99:.4f} mm (gate: mean < {FAST_TSDF_MEAN_MM:.4f}); "
        f"raycast hits a median {med:.4f} mm from the analytic surface; miss 0")
    check(mean < FAST_TSDF_MEAN_MM, "fast fusion is far from the exact fusion")
    check(med < SURFACE_MEDIAN_MM, "fast fusion: hits far from the surface")
    fast_ms = median_ms(lambda: fuse_frames(vol, cam, frames, fast), reps=3) / n
    exact_ms = median_ms(lambda: fuse_frames(ref, cam, frames, exact), reps=3) / n
    fast_ms2 = median_ms(lambda: fuse_frames(vol, cam, frames, fast), reps=3) / n
    exact_ms2 = median_ms(lambda: fuse_frames(ref, cam, frames, exact), reps=3) / n
    log(f"fuse loop on the device, 512^3, ms/frame (medians of 3 runs of {n} "
        f"frames, in turns): fast {fast_ms:.4f}, exact {exact_ms:.4f}, fast "
        f"{fast_ms2:.4f}, exact {exact_ms2:.4f}")
    parent = parent_in_turns(
        [kint.KERNEL_FAST], lambda: fuse_frames(vol, cam, frames, fast), 3,
        fast_ms * n, f"fuse loop fast, {n} frames")
    if parent is not None:
        log(f"fuse loop fast on the device, ms/frame: {fast_ms:.4f}, with the "
            f"parent's fast kernel {parent / n:.4f}")
    del ref, vol

    # GT poses, depth + colour
    ref, _ = fuse_frames(exact.make_volume(device=dev).with_color(), cam,
                         triples, exact)
    (vol, _), color_counts = counted(
        lambda: fuse_frames(fast.make_volume(device=dev).with_color(), cam,
                            triples, fast),
        "fuse_frames, fast, colour", integrate_color_fast=n)
    mean, p99, same_w = tsdf_gap(ref, vol)
    both = (ref.color > 0).any(-1) & (vol.color > 0).any(-1)
    gap = (ref.color[both].float() - vol.color[both].float()).abs()
    level = float(gap.mean())
    log(f"colour-fast against exact colour fusion: weights equal on {same_w:.6f}, "
        f"mean |tsdf diff| {mean:.4f} mm; colour on {int(both.sum())} voxels "
        f"both coloured: mean |diff| {level:.4f} levels (gate < "
        f"{FAST_COLOR_MEAN_LEVELS}), max {int(gap.max())}")
    check(mean < FAST_TSDF_MEAN_MM, "colour-fast tsdf is far from exact")
    check(level < FAST_COLOR_MEAN_LEVELS, "colour-fast colour is far from exact")
    del ref, vol, both, gap

    # tracked, depth only (no filter: the fast mode concerns the fuse)
    depths = [d for d, _ in frames]
    (out, tracked_counts) = counted(
        lambda: track_and_fuse_frames(fast.make_volume(device=dev), cam0,
                                      depths, fast),
        "track_and_fuse_frames, fast", at_least=dict(lane_gather=19 * (n - 1)),
        integrate_fast=n, raycast=n - 1)
    vol, _cam, poses, stats = out
    a = ate([p.cpu().numpy() for p in poses], gt_poses)
    med = surface_median(vol)
    inliers = [int(k) for _, k in stats[1:]]
    log(f"tracked with fast integrate, {n} frames: ATE rmse {a['rmse']:.4f} mm "
        f"(max {a['max']:.4f}), inliers {min(inliers)}..{max(inliers)}, raycast "
        f"hits a median {med:.4f} mm from the analytic surface; miss 0")
    check(a["rmse"] < ATE_MAX_MM, "fast tracked ATE is not under one voxel")
    check(min(inliers) > 0.02 * W * H, "fast tracked loop lost a frame")
    check(med < SURFACE_MEDIAN_MM, "fast tracked: hits far from the surface")
    return dict(fuse=fuse_counts, color=color_counts, tracked=tracked_counts,
                fast_ms_per_frame=fast_ms, exact_ms_per_frame=exact_ms,
                parent_fast_ms_per_frame=None if parent is None else parent / n)


# -- non-rigid SceneFusion -----------------------------------------------------

# the reference's configuration (SceneFusion.cpp:49): 255^3 over 2550 mm
SF_SIZE = 255
SF_PHYSICAL = 2550.0
SF_OFFSET = (-1275.0, -1275.0, 0.0)
SF_FRAMES = 6
SF_MAX_CUBES = 1 << 18
SF_SPHERE = ((0.0, 0.0, 1300.0), 500.0)
# the uniform +x flow of frame i's file, mm; frame i + 1 reads it
SF_FLOW_MM = [4.0 + i for i in range(SF_FRAMES)]
SF_TOTAL_FLOW_MM = sum(SF_FLOW_MM[:SF_FRAMES - 1])
# the uniform warp of the 512^3 kernel comparison, mm
WARP_512_MM = (80.0, 0.0, 0.0)


def write_sfusion_dirs(dev, root: str) -> tuple[str, str, np.ndarray]:
    """An RGB-D directory and a PD-Flow directory: a sphere (r = 500 mm at
    z = 1300 mm) in the 255^3 / 2550 mm volume, its depth rendered with the
    raycast kernel from the identity pose, the same frame SF_FRAMES times
    (depth_NNNNN.png / colour_NNNNN.png), and per frame a text file of
    307200 lines with a uniform +x flow of 4 + i mm; one of them read
    back."""
    from tsdf_tpu_torch import Camera, make_volume, render_to_depth_image
    from tsdf_tpu_torch.io.png import save_png
    from tsdf_tpu_torch.io.sceneflow import read_pdflow
    from tsdf_tpu_torch.utils import fixtures

    rgbd, flow = os.path.join(root, "rgbd"), os.path.join(root, "flow")
    os.makedirs(rgbd)
    os.makedirs(flow)
    centre, radius = SF_SPHERE
    scene = fixtures.sphere_tsdf(
        make_volume((SF_SIZE,) * 3, SF_PHYSICAL, offset=SF_OFFSET, device=dev),
        radius, centre=centre)
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    depth = render_to_depth_image(scene, cam, W, H).to(torch.int32)
    depth = depth.cpu().numpy().astype(np.uint16)
    hit = float((depth > 0).mean())
    log(f"sfusion frames: depth {depth.shape} {depth.dtype}, "
        f"{hit:.4f} of the pixels hit, range {depth[depth > 0].min()}.."
        f"{depth.max()} mm")
    check(0.2 < hit < 0.9, "the rendered sphere fills an odd share of the frame")
    ys, xs = np.mgrid[0:H, 0:W]
    for i in range(SF_FRAMES):
        save_png(os.path.join(rgbd, f"depth_{i:05d}.png"), depth)
        save_png(os.path.join(rgbd, f"colour_{i:05d}.png"),
                 np.full((H, W, 3), 128, np.uint8))
        rows = np.stack([ys.ravel(), xs.ravel(), np.zeros(H * W),
                         np.full(H * W, SF_FLOW_MM[i] / 1000.0),
                         np.zeros(H * W)], axis=1)
        np.savetxt(os.path.join(flow, f"sflow_{i:05d}_results01.txt"), rows,
                   fmt="%.0f %.0f %.6f %.6f %.6f")
    got = read_pdflow(os.path.join(flow, "sflow_00001_results01.txt"))
    check(got.shape == (H, W, 3) and abs(float(got[7, 9, 0]) - SF_FLOW_MM[1]) < 1e-4
          and float(np.abs(got[..., 1:]).max()) == 0.0, "read_pdflow")
    return rgbd, flow, depth


@contextlib.contextmanager
def plain_twins():
    """Inside, the SceneFusion step runs every kernel's plain PyTorch twin
    on the tensors it is given (CUDA tensors included): the modules' kernel
    wrappers are swapped for the twins, and swapped back."""
    from tsdf_tpu_torch.kernels import gather
    from tsdf_tpu_torch.ops import deform, marching_cubes
    from tsdf_tpu_torch.ops.integrate import integrate
    from tsdf_tpu_torch.pipelines import scenefusion

    def integrate_plain_in_place(vol, depth, camera, cap_weight=False, rgb=None):
        out = integrate(vol, depth, camera, cap_weight=cap_weight, rgb=rgb)
        vol.tsdf.copy_(out.tsdf)
        vol.weight.copy_(out.weight)
        return vol

    swaps = [
        (marching_cubes, "lane_gather_op", gather.take_or_zero),
        (scenefusion, "row_gather_op", gather.take_rows),
        (deform, "row_gather_op", gather.take_rows),
        (scenefusion, "integrate_warped_cuda", integrate_plain_in_place),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, twin in swaps:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def recorded(mod, name: str, calls: list):
    """Inside, every call of ``mod.name`` appends its arguments to
    ``calls`` and goes on to the function itself."""
    fn = getattr(mod, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    setattr(mod, name, wrapper)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def sf_camera(dev):
    from tsdf_tpu_torch import Camera

    return Camera.from_intrinsics(FX, FY, CX, CY, device=dev)


def sf_inputs(dev, depth_u16: np.ndarray):
    """The frames of the fabricated sequence on the card: one float32
    depth image, and the flow each later frame reads."""
    depth = torch.from_numpy(depth_u16.astype(np.float32)).to(dev)
    flows = []
    for mm in SF_FLOW_MM[:SF_FRAMES - 1]:
        f = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
        f[..., 0] = mm
        flows.append(f)
    return depth, flows


def sf_run(dev, depth, flows, n_frames=SF_FRAMES):
    """The SceneFusion loop on frames already on the card, through
    ``scenefusion_step``: returns the volume, the correspondence counts and
    the overflow flags (tensors; nothing is read here)."""
    from tsdf_tpu_torch.pipelines import scenefusion as sf

    cfg = sf.SceneFusionConfig()
    cam = sf_camera(dev)
    vol = cfg.make_volume(device=dev)
    vol = sf.integrate_warped_cuda(vol, depth, cam)
    n_corrs, overflows = [], []
    for flow in flows[:n_frames - 1]:
        vol, n_corr, overflow = sf.scenefusion_step(
            vol, depth, flow, cam, max_cubes=cfg.max_cubes,
            threshold_mm=cfg.threshold_mm)
        n_corrs.append(n_corr)
        overflows.append(overflow)
    return vol, n_corrs, overflows


def warped_bound(vol, in_front: int, updated: int, band: int = 0,
                 storage_bytes: int = 4) -> dict:
    """The least time for one warped integrate of a 640x480 frame: the
    deformed centre of every voxel (12 B), tsdf and weight read and
    written where a voxel is updated (16 B, 8 B in bf16: a voxel that fails
    a gate needs neither), the depth image once; with colour, 6 B per voxel
    in the colour band and the rgb image. The operations are the rigid
    kernel's less the centre's six."""
    n = vol.tsdf.numel()
    o = INTEGRATE_OPS
    moved = 12 * n + 4 * storage_bytes * updated + W * H * 4
    ops = (o["voxel"] - 6) * n + o["in_front"] * in_front + o["updated"] * updated
    if band:
        moved += 6 * band + W * H * 3
        ops += COLOR_OPS_PER_BAND_VOXEL * band
    return bound(moved, ops)


def compare_integrate_warped(dev, frames, sf_depth, sf_flows) -> dict:
    """``integrate_warped_cuda`` against the twin, bit for bit in tsdf and
    weight: at 512^3 with the volume warped uniformly by 80 mm in x, over
    two frames of the TUM scene (the second blends into weighted voxels)
    and a third with ``cap_weight``; at 255^3 with the non-uniform field
    two real deformation updates leave, over two frames; and the colour
    variant at 255^3."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import integrate_warped_cuda
    from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain

    def clone(vol):
        return vol.replace(
            tsdf=vol.tsdf.clone(), weight=vol.weight.clone(),
            color=None if vol.color is None else vol.color.clone())

    def equal(out, ref, what):
        torch.cuda.synchronize()
        n_w = int((out.weight != ref.weight).sum())
        n_t = int((out.tsdf != ref.tsdf).sum())
        n_c = 0 if ref.color is None else int((out.color != ref.color).sum())
        err = float((out.tsdf - ref.tsdf).abs().max())
        log(f"integrate_warped {what}: {n_w} weights, {n_t} tsdf values"
            + ("" if ref.color is None else f", {n_c} colour bytes")
            + f" differ (max |tsdf diff| {err:.3g} mm)")
        check(n_w == 0 and n_t == 0 and n_c == 0,
              f"integrate_warped differs from its twin ({what})")
        return err

    out = {}
    # 512^3, uniform warp
    ref = make_volume((SIZE,) * 3, PHYSICAL, with_deformation=True, device=dev)
    ref = ref.replace(deform=(ref.deform + torch.tensor(
        WARP_512_MM, device=dev)).contiguous())
    vol = clone(ref)
    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames]
    for (depth, _), cam in zip(frames, cams):
        before = ref
        ref = integrate_plain(ref, depth, cam)
        vol = integrate_warped_cuda(vol, depth, cam)
    blended = int(((ref.weight > before.weight) & (before.weight > 0)).sum())
    check(blended > 0, "integrate_warped 512^3: nothing was blended into")
    err = equal(vol, ref, f"512^3 warped by {WARP_512_MM} mm, two frames, "
                          f"{blended} voxels blended into")
    updated = int((ref.weight > before.weight).sum())
    # a third frame under cap_weight, at a cap the weights have reached
    capped = torch.tensor(2.0, device=dev)
    ref = integrate_plain(ref.replace(max_weight=capped), frames[0][0], cams[0],
                          cap_weight=True)
    vol = integrate_warped_cuda(vol.replace(max_weight=capped), frames[0][0],
                                cams[0], cap_weight=True)
    check(float(ref.weight.max()) == 2.0, "cap_weight did not cap")
    err = max(err, equal(vol, ref, "512^3, a third frame with cap_weight"))
    depth, cam = frames[1][0], cams[1]
    ms = median_ms(lambda: integrate_warped_cuda(vol, depth, cam), reps=20)
    least = warped_bound(before, voxels_in_front(before, cam), updated)
    log(f"integrate_warped 512^3 one frame: kernel {ms:.4f} ms, "
        f"bound {least['bound_ms']:.4f} ms by "
        f"{least['bound_by']} ({updated} voxels updated)")
    out.update(ms_512=ms, bound_ms_512=least["bound_ms"],
               updated_512=updated)
    del ref, vol, before

    # 255^3, the field two real updates leave
    ref, n_corrs, _ = sf_run(dev, sf_depth, sf_flows, n_frames=3)
    check(all(int(k) > 0 for k in n_corrs), "no correspondences at 255^3")
    centres = ref.voxel_centres()
    moved = int(((ref.deform - centres).abs().amax(-1) > 1e-3).sum())
    del centres
    check(moved > 1000, "the 255^3 field is not deformed")
    cam = sf_camera(dev)
    vol = clone(ref)
    for _ in range(2):
        before = ref
        ref = integrate_plain(ref, sf_depth, cam)
        vol = integrate_warped_cuda(vol, sf_depth, cam)
    err = max(err, equal(vol, ref, f"255^3 after two deformation updates "
                                   f"({moved} voxels moved), two more frames"))
    updated = int((ref.weight > before.weight).sum())
    ms = median_ms(lambda: integrate_warped_cuda(vol, sf_depth, cam), reps=20,
                   inner=4)
    # the camera sits at the identity pose: camera z is the centre's z
    in_front = int((ref.deform[..., 2] > 0).sum())
    least = warped_bound(ref, in_front, updated)
    log(f"integrate_warped 255^3 one frame: kernel {ms:.4f} ms, "
        f"bound {least['bound_ms']:.4f} ms by "
        f"{least['bound_by']} ({updated} voxels updated)")
    out.update(max_abs_err=err, ms=ms, **least,
               library_ms=None, updated=updated)

    # the colour variant, 255^3: two frames of a grey-ramp image
    rgb = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        (np.arange(W) * 255 // W).astype(np.uint8)[None, :, None], (H, W, 3))
    )).to(dev)
    cref = ref.with_color()
    cvol = clone(cref)
    for _ in range(2):
        cref = integrate_plain(cref, sf_depth, cam, rgb=rgb)
        cvol = integrate_warped_cuda(cvol, sf_depth, cam, rgb=rgb)
    cerr = equal(cvol, cref, "255^3 with rgb, two frames")
    band = int((cref.color.to(torch.int32) > 0).any(-1).sum())
    check(band > 1000, "the warped colour kernel coloured nothing")
    cms = median_ms(lambda: integrate_warped_cuda(cvol, sf_depth, cam, rgb=rgb),
                    reps=20, inner=4)
    cleast = warped_bound(cref, in_front, updated, band)
    log(f"integrate_warped_color 255^3 one frame: kernel {cms:.4f} ms, "
        f"bound {cleast['bound_ms']:.4f} ms by "
        f"{cleast['bound_by']} ({band} voxels in the colour band)")
    color = dict(max_abs_err=cerr, ms=cms, **cleast,
                 library_ms=None)
    return {"integrate_warped": out, "integrate_warped_color": color}


def compare_row_gather(dev, sf_depth, sf_flows) -> dict:
    """``row_gather_op`` against its twin, equal bytes, at the two shapes
    the SceneFusion path gives it: the correspondence lookup of a real
    255^3 frame (a (307200, 4) table, one index per mesh slot) and the 8
    taps of ``deform_points`` on that frame's mesh (the (255^3, 3) field).
    The arguments are recorded from the real calls. Each shape logs the
    instance the library picks and the share of the bound; with
    ``--parent``, the parent's kernel in turns on the same inputs. Then
    the edge inputs (``row_gather_edges``)."""
    from tsdf_tpu_torch.kernels import _build
    from tsdf_tpu_torch.kernels.gather import (
        KERNEL_ROWS,
        row_gather_instance,
        row_gather_op,
        take_rows,
    )
    from tsdf_tpu_torch.ops import deform
    from tsdf_tpu_torch.ops.marching_cubes import extract_surface, soup_to_numpy
    from tsdf_tpu_torch.pipelines import scenefusion as sf

    calls = []
    with recorded(sf, "row_gather_op", calls):
        vol, _, _ = sf_run(dev, sf_depth, sf_flows, n_frames=3)
    verts, _ = soup_to_numpy(extract_surface(
        vol, max_cubes=SF_MAX_CUBES, max_vertices=1 << 20))
    with recorded(deform, "row_gather_op", calls):
        deform.deform_points(vol, verts)
    check(len(calls) == 3, "expected two correspondence lookups and one warp")
    shapes = [(tuple(t.shape), tuple(i.shape)) for t, i in calls]
    check(shapes[1] == ((H * W, 4), (SF_MAX_CUBES * 24,)),
          f"correspondence lookup shapes {shapes[1]}")
    check(shapes[2] == ((SF_SIZE**3, 3), (8 * len(verts),)),
          f"deform_points lookup shapes {shapes[2]}")
    out = {}
    for what, (table, idx) in (("corr", calls[1]), ("deform", calls[2])):
        got, want = row_gather_op(table, idx), take_rows(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"row gather differs at table {tuple(table.shape)}")
        err = float((got.double() - want.double()).abs().max())
        instance = row_gather_instance(table, idx)
        fn = lambda: row_gather_op(table, idx)  # noqa: E731
        ms = median_ms(fn, reps=10, inner=10)
        parent = parent_in_turns([KERNEL_ROWS], fn, 10, ms,
                                 f"row gather ({what})", inner=10)
        idx64 = idx.clamp(0, table.shape[0] - 1).to(torch.int64)
        library_ms = median_ms(lambda: torch.index_select(table, 0, idx64),
                               reps=10, inner=10)
        # index read and row written once per output row; of the table,
        # the distinct rows these indices name
        row_bytes = table.shape[1] * 4
        distinct = int(torch.unique(idx64).numel())
        least = bound(idx.numel() * (4 + row_bytes) + distinct * row_bytes, 0)
        log(f"row gather {tuple(table.shape)} -> {tuple(idx.shape)} ({what}): "
            f"equal bytes, max |diff| {err:.3g}; instance {instance}; kernel "
            f"{ms:.4f} ms (parent {ms_text(parent)}), "
            f"torch.index_select {library_ms:.4f} ms, bound "
            f"{least['bound_ms']:.4f} ms by bytes ({distinct} distinct rows): "
            f"{least['bound_ms'] / ms:.3f} of the bound")
        out[what] = dict(max_abs_err=err, ms=ms, parent_ms=parent,
                         library_ms=library_ms,
                         instance=instance, **least)
    edge_cases = row_gather_edges(dev)
    lib, build_log = str(_build.library_path()), str(_build.BUILD_DIR / "build.log")
    # the loop of each compiled instance: 4 rows a lane (16 B), a pair (12 B)
    sass = {name: sass_loop(lib, build_log, kernel) for name, kernel in
            (("rows16", "rows16_kernel"), ("rows12", "rows12_kernelILb1E"))}
    per_row = {"rows16": sass["rows16"]["loop_instructions"] / 4,
               "rows12": sass["rows12"]["loop_instructions"] / 2}
    log("row gather SASS: " + "; ".join(
        f"{k} {sass[k]['loop_instructions']} instructions a loop "
        f"({per_row[k]:.2f} a row, {sass[k]['loop_loads']} global loads), "
        f"{sass[k]['registers']} registers" for k in sass))
    d = out["deform"]
    out["corr"]["max_abs_err"] = max(out["corr"]["max_abs_err"], d["max_abs_err"])
    return dict(**out["corr"], deform_points_ms=d["ms"],
                deform_points_parent_ms=d["parent_ms"],
                deform_points_library_ms=d["library_ms"],
                deform_points_bound_ms=d["bound_ms"],
                deform_points_instance=d["instance"],
                deform_points_rows=int(calls[2][1].numel()),
                sass_instructions_a_row=per_row,
                registers={k: v["registers"] for k, v in sass.items()},
                edge_inputs=edge_cases)


def row_gather_edges(dev) -> int:
    """``row_gather_op`` bit-equal with ``take_rows`` on the inputs the
    kernel's instances must get right: J around its groups at 12- and
    16-byte rows; indices at INT32_MIN, -1, N-1, N and INT32_MAX; an idx
    view one element into its allocation (no vector index load); a
    table view at +4 B; u8, i16 and f64 rows; and once an output past 2^32
    bytes (J = 2^28 + 3 rows of 16 B). Each case checks the instance the
    library picks for it. Returns the number of cases."""
    from tsdf_tpu_torch.kernels.gather import (
        row_gather_instance,
        row_gather_op,
        take_rows,
    )

    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rng = np.random.default_rng(12)

    def held(what, table, idx, instance):
        picked = row_gather_instance(table, idx)
        check(picked == instance,
              f"row gather edge {what}: instance {picked}, expected {instance}")
        got = row_gather_op(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.uint8),
                          take_rows(table, idx).view(torch.uint8)),
              f"row gather edge {what} differs from take_rows")

    def f32_rows(n, w):
        t = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32))
        t[0, 0] = -0.0
        t[1, -1] = float("nan")
        return t.to(dev)

    def ints(values):
        return torch.from_numpy(np.asarray(values, np.int32)).to(dev)

    cases = 0
    for w, name in ((3, "rows12"), (4, "rows16")):
        table = f32_rows(61, w)
        for j in (1, 2, 3, 4, 5, 7, 8, 9, 4097):
            held(f"w{w} J={j}", table, ints(rng.integers(-3, 64, j)), name)
            cases += 1
        held(f"w{w} extreme indices", table,
             ints([lo, -1, 60, 61, hi, 0, lo + 1, hi - 1, 5]), name)
        idx = ints(np.concatenate([[0], rng.integers(-3, 64, 4097)]))[1:]
        check(idx.data_ptr() % 16 == 4, "the idx view is 16-byte aligned")
        held(f"w{w} idx view at +4 B", table, idx,
             name + (", scalar indices" if w == 3 else ""))
        cases += 2
    base = torch.arange(4 * 50 + 1, dtype=torch.float32, device=dev)
    held("table view at +4 B", base[1:].view(50, 4),
         ints([49, 0, 7, 7, 60, -1]), "generic 4 B")
    cases += 1
    for dtype, w, name in ((torch.uint8, 3, "generic 1 B"),
                           (torch.uint8, 12, "rows12"),
                           (torch.int16, 5, "generic 2 B"),
                           (torch.int16, 8, "rows16"),
                           (torch.float64, 3, "generic 8 B"),
                           (torch.float64, 65, "generic 8 B")):
        table = torch.from_numpy(rng.integers(0, 255, (300, w))).to(dtype).to(dev)
        held(f"{dtype} x {w}", table, ints(rng.integers(-5, 305, 1001)), name)
        cases += 1
    n, j = 1000, (1 << 28) + 3
    table = torch.arange(4 * n, dtype=torch.int32, device=dev).view(n, 4)
    idx = (torch.arange(j, dtype=torch.int64, device=dev) * 7919 % (n + 10)
           - 5).to(torch.int32)
    held("J = 2^28 + 3 rows of 16 B (4 GiB out)", table, idx, "rows16")
    cases += 1
    del idx
    torch.cuda.empty_cache()
    log(f"row gather edge inputs: {cases} cases, each bit-equal with take_rows "
        f"through the instance expected")
    return cases


def compare_gather_masked(dev, sf_depth, sf_flows) -> dict:
    """The lane gather at the shapes the SceneFusion path gives it: the four
    ``lane_gather_op`` calls of one masked-layout extraction of a real
    255^3 volume, recorded from the extraction itself (vertex counts of
    every cube, (254^3, 1) from a 256-word broadcast table; triangle table,
    (2^18, 24) from 6144 words; slot vertices, (2^18, 72) from 36-word
    rows; slot voxels, (2^18, 48) from 24-word int rows), each against
    ``take_or_zero`` bit for bit. The times are sums over the four."""
    from tsdf_tpu_torch.ops import marching_cubes

    vol, _, _ = sf_run(dev, sf_depth, sf_flows, n_frames=2)
    calls = []
    with recorded(marching_cubes, "lane_gather_op", calls):
        marching_cubes.extract_surface(
            vol, max_cubes=SF_MAX_CUBES, max_vertices=1, layout="masked")
    cubes = (SF_SIZE - 1) ** 3
    shapes = [(tuple(t.shape), tuple(i.shape)) for t, i in calls]
    check(shapes == [((cubes, 256), (cubes, 1)),
                     ((SF_MAX_CUBES, 256 * 24), (SF_MAX_CUBES, 24)),
                     ((SF_MAX_CUBES, 36), (SF_MAX_CUBES, 72)),
                     ((SF_MAX_CUBES, 24), (SF_MAX_CUBES, 48))],
          f"the masked extraction's lane gathers have shapes {shapes}")
    out = hold_lane_gathers(calls, ["masked extraction, 255^3"] * 4)
    del out["each"], out["bound_by"]
    log(f"lane gather, one masked 255^3 extraction's four calls: bit-equal, "
        f"max |diff| {out['max_abs_err']:.3g}; kernel {out['ms']:.4f} ms, "
        f"torch.gather {out['library_ms']:.4f} ms, "
        f"bound {out['bound_ms']:.4f} ms")
    return {f"masked_{k}": v for k, v in out.items()}


def guarded_fallback(table, idx, only_if, out):
    """One launch of ``lane_gather_checked``'s guarded fallback, with
    ``only_if`` as the miss word it reads."""
    from tsdf_tpu_torch.kernels import gather as kg
    from tsdf_tpu_torch.kernels._build import stream_handle

    s, w = table.shape
    kg.KERNEL_IF_MISSED(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        only_if.data_ptr(), s, idx.shape[1], w, w,
                        stream_handle(table.device),
                        kg.lane_gather_launch(idx.shape[1], w, w)[1])


def compare_windowed(dev) -> dict:
    """``lane_gather_windowed_op`` against its twin (out equal, miss
    equal) and ``lane_gather_checked``, the guarded fallback alone with its
    miss word set, and ``lane_gather_op`` against the plain full gather
    ``take_or_zero`` (equal, the checked wrapper with no host sync inside), on a coherent index set (miss 0) and a wild
    one (miss > 0), at a wide table (4096, 2048) and at the ICP/raycast
    width (480, 640); at (4096, 2048) also with tiles of 128 rows and a
    window of 8 blocks (more than a block could stage in shared memory). The
    guarded fallback alone is timed with its miss word 0 and 1. With ``--parent``,
    the parent's windowed kernel, checked pair and fallback in turns on the
    same inputs. No path of either package calls these functions."""
    from tsdf_tpu_torch.kernels.gather import (
        KERNEL_IF_MISSED,
        KERNEL_WINDOWED,
        lane_gather_checked,
        lane_gather_op,
        lane_gather_windowed_op,
        take_or_zero,
        take_windowed,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for s, w, c in ((4096, 2048, 2048), (H, W, W)):
        table = torch.randn(s, w, generator=gen, device=dev)
        rows = torch.arange(s, dtype=torch.int32, device=dev)[:, None]
        cols = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
        # coherent: a tile of 64 rows x 128 columns spans 128 + 63 // 4
        # columns from its aligned first column: inside a 256-wide window;
        # some slots out of range
        coherent = cols + rows % 64 // 4
        coherent = torch.where((rows + cols) % 97 == 0, -1, coherent).contiguous()
        wild = torch.randint(-10, w + 10, (s, c), generator=gen, device=dev,
                             dtype=torch.int32)
        for what, idx in (("coherent", coherent), ("wild", wild)):
            got, miss = lane_gather_windowed_op(table, idx)
            want, want_miss = take_windowed(table, idx)
            # the plain full gather: what the checked wrapper, its fallback
            # and lane_gather_op must all give
            want_full = take_or_zero(table, idx)
            full = lane_gather_op(table, idx)
            torch.cuda.synchronize()
            check(torch.equal(full.view(torch.int32),
                              want_full.view(torch.int32)),
                  f"lane_gather_op differs from take_or_zero ({s}x{w}, {what})")
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"windowed gather differs from its twin ({s}x{w}, {what})")
            check(int(miss) == int(want_miss),
                  f"windowed miss {int(miss)}, twin {int(want_miss)}")
            err = float((got.double() - want.double()).abs().max())
            check((int(miss) == 0) == (what == "coherent"),
                  f"windowed miss {int(miss)} on the {what} indices")
            if what == "coherent":
                check(torch.equal(got.view(torch.int32),
                                  want_full.view(torch.int32)),
                      "windowed gather with miss 0 differs from the full gather")
            torch.cuda.set_sync_debug_mode("error")
            try:
                checked = lane_gather_checked(table, idx)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            check(torch.equal(checked.view(torch.int32),
                              want_full.view(torch.int32)),
                  f"lane_gather_checked differs from take_or_zero ({what})")
            checked_err = float((checked.double() - want_full.double())
                                .abs().max())
            # the fallback alone, its miss word set: it rewrites every output
            word = torch.ones(1, dtype=torch.int32, device=dev)
            alone = torch.zeros_like(want_full)
            guarded_fallback(table, idx, word, alone)
            torch.cuda.synchronize()
            check(torch.equal(alone.view(torch.int32),
                              want_full.view(torch.int32)),
                  f"the guarded fallback with its word set differs from "
                  f"take_or_zero ({s}x{w}, {what})")
            checked_err = max(checked_err, float(
                (alone.double() - want_full.double()).abs().max()))
            times = dict(
                ms=median_ms(lambda: lane_gather_windowed_op(table, idx),
                             reps=10, inner=4),
                checked_ms=median_ms(lambda: lane_gather_checked(table, idx),
                                     reps=10, inner=4),
                full_ms=median_ms(lambda: lane_gather_op(table, idx),
                                  reps=10, inner=4),
            )
            times["parent_ms"] = parent_in_turns(
                [KERNEL_WINDOWED], lambda: lane_gather_windowed_op(table, idx),
                10, times["ms"], f"windowed ({s}, {w}) {what}", inner=4)
            times["checked_parent_ms"] = parent_in_turns(
                [KERNEL_WINDOWED, KERNEL_IF_MISSED],
                lambda: lane_gather_checked(table, idx), 10,
                times["checked_ms"], f"checked ({s}, {w}) {what}", inner=4)
            in_range = (idx >= 0) & (idx < w)
            idx64 = idx.clamp(0, w - 1).to(torch.int64)
            times["library_ms"] = median_ms(
                lambda: torch.gather(table, 1, idx64), reps=10, inner=4)
            # index read and output written once; of the table, the
            # distinct words these indices name
            words = int(torch.unique((rows.to(torch.int64) * w + idx64)[in_range])
                        .numel())
            least = bound(4 * (2 * idx.numel() + words), idx.numel())
            log(f"windowed lane gather ({s}, {w}) -> ({s}, {c}), {what}: out and "
                f"miss ({int(miss)}) equal the twin's (max |diff| {err:.3g}), "
                f"checked equals the full gather (max |diff| {checked_err:.3g}) "
                f"with no host sync; windowed {times['ms']:.4f} ms (parent "
                f"{ms_text(times['parent_ms'])}), checked "
                f"{times['checked_ms']:.4f} ms (parent "
                f"{ms_text(times['checked_parent_ms'])}), lane_gather_op "
                f"{times['full_ms']:.4f} ms, "
                f"torch.gather {times['library_ms']:.4f} ms, bound "
                f"{least['bound_ms']:.4f} ms by {least['bound_by']}")
            out[(w, what)] = dict(max_abs_err=err, checked_err=checked_err,
                                  miss=int(miss), **times, **least)
            if w == 2048 and what == "coherent":
                # the guarded fallback alone: its miss word 0 (one wave of
                # blocks that read it) and 1 (the whole output rewritten)
                dst = torch.empty_like(full)
                for flag in (0, 1):
                    word = torch.full((1,), flag, dtype=torch.int32, device=dev)
                    fn = lambda: guarded_fallback(table, idx, word, dst)  # noqa: E731
                    ms = median_ms(fn, reps=10, inner=4)
                    parent = parent_in_turns([KERNEL_IF_MISSED], fn, 10, ms,
                                             f"guarded fallback, word {flag}",
                                             inner=4)
                    out[("guarded", flag)] = dict(ms=ms, parent_ms=parent)
                # tiles of 128 rows, a window of 8 blocks: 512 KB a tile,
                # which the staging kernel refused
                tall = dict(window_blocks=8, block_rows=128)
                got, miss = lane_gather_windowed_op(table, idx, **tall)
                want, want_miss = take_windowed(table, idx, **tall)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int32), want.view(torch.int32))
                      and int(miss) == int(want_miss),
                      "windowed gather at block_rows 128, window_blocks 8 "
                      "differs from its twin")
                ms = median_ms(lambda: lane_gather_windowed_op(table, idx, **tall),
                               reps=10, inner=4)
                log(f"windowed lane gather ({s}, {w}), coherent, block_rows 128, "
                    f"window_blocks 8: out and miss ({int(miss)}) equal the "
                    f"twin's, {ms:.4f} ms")
                out[("tall", 0)] = dict(ms=ms, miss=int(miss))
    registers = kernel_registers(["lane_gather_windowed_kernel",
                                  "lane_gather_if_missed_kernel"])
    guarded = out[("guarded", 0)], out[("guarded", 1)]
    log(f"windowed gather and guarded fallback: registers {registers}; the "
        f"fallback alone at (4096, 2048): word 0 "
        f"{guarded[0]['ms']:.4f} ms (parent {ms_text(guarded[0]['parent_ms'])}), "
        f"word 1 {guarded[1]['ms']:.4f} ms (parent "
        f"{ms_text(guarded[1]['parent_ms'])})")
    wide, wide_wild = out[(2048, "coherent")], out[(2048, "wild")]
    icp, icp_wild = out[(W, "coherent")], out[(W, "wild")]
    keys = ("max_abs_err", "ms", "library_ms", "bound_ms", "bound_by")
    windowed = {k: wide[k] for k in keys}
    windowed["max_abs_err"] = max(o["max_abs_err"] for k, o in out.items()
                                  if "max_abs_err" in o)
    windowed.update(lane_gather_op_ms=wide["full_ms"], wild_ms=wide_wild["ms"],
                    wild_miss=wide_wild["miss"], w640_ms=icp["ms"],
                    w640_lane_gather_op_ms=icp["full_ms"],
                    w640_library_ms=icp["library_ms"],
                    w640_bound_ms=icp["bound_ms"], w640_wild_ms=icp_wild["ms"],
                    parent_ms=wide["parent_ms"],
                    wild_parent_ms=wide_wild["parent_ms"],
                    bs128_wb8_ms=out[("tall", 0)]["ms"],
                    registers=registers)
    # the checked wrapper where it has to fall back: both launches
    checked = {k: wide_wild[k] for k in keys}
    checked.update(max_abs_err=max(o["checked_err"] for k, o in out.items()
                                   if "checked_err" in o),
                   ms=wide_wild["checked_ms"],
                   parent_ms=wide_wild["checked_parent_ms"],
                   no_miss_ms=wide["checked_ms"],
                   no_miss_parent_ms=wide["checked_parent_ms"],
                   w640_ms=icp_wild["checked_ms"],
                   w640_no_miss_ms=icp["checked_ms"],
                   fallback_word0_ms=guarded[0]["ms"],
                   fallback_word0_parent_ms=guarded[0]["parent_ms"],
                   fallback_word1_ms=guarded[1]["ms"],
                   fallback_word1_parent_ms=guarded[1]["parent_ms"])
    return {"lane_gather_windowed": windowed, "lane_gather_checked": checked}


def run_sfusion_cli(dev, rgbd: str, flow: str, mesh: str, extra=()) -> dict:
    """``cli.main(["sfusion", rgbd, flow, "--mesh", mesh, *extra])`` (by
    default at the verb's defaults: 255^3 over 2550 mm, max_cubes 2^18)
    with every launch count set to 0 just before and read just after:
    the counts (this process's ranks only), seconds, vertices, stdout and
    the PLY's digest."""
    import warnings

    from tsdf_tpu_torch import cli
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    err, out = io.StringIO(), io.StringIO()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        warnings.simplefilter("always")
        rc = cli.main(["sfusion", rgbd, flow, "--mesh", mesh,
                       "--device", dev.type, *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    what = " ".join(("sfusion",) + tuple(extra))
    sys.stderr.write(err.getvalue())
    log(out.getvalue().rstrip())
    log(f"{what}: rc {rc} in {seconds:.2f} s; launches {counts}")
    check(rc == 0, f"{what} returned {rc}")
    check(f"processed {SF_FRAMES} frames" in out.getvalue(),
          f"{what}: no 'processed N frames' line")
    check(not [w for w in caught if "max_cubes" in str(w.message)],
          f"{what}: the extraction overflowed max_cubes")
    with open(mesh) as f:
        header = [next(f).strip() for _ in range(12)]
    (n_vert,) = [int(h.split()[-1]) for h in header
                 if h.startswith("element vertex")]
    check(n_vert > 1000 and f"({n_vert} vertices)" in out.getvalue(),
          f"{what}: the PLY is empty or its vertex count was not printed")
    return dict(counts=counts, seconds=seconds, vertices=n_vert,
                stdout=out.getvalue(), digest=digests({"ply": mesh})["ply"],
                mesh=mesh)


class CardFrames:
    """An RGB-D source and a scene-flow provider over frames that are
    already on the card: the SceneFusion class without file I/O."""

    def __init__(self, depth, flows):
        self.depth, self.flows, self.index = depth, flows, 0
        self.observer = None

    def add_observer(self, observer):
        self.observer = observer

    def compute_scene_flow(self, depth=None, rgb=None):
        self.index += 1
        return None, None, self.flows[self.index - 1]

    def start(self):
        for _ in range(len(self.flows) + 1):
            self.observer(self.depth, None)


def phase_sfusion_cli(dev, rgbd: str, flow: str, out_dir: str) -> dict:
    """The ``sfusion`` verb on the fabricated directories, its launches
    exact: per frame after the first four lane gathers in the masked
    extraction, one row gather, one warped integrate; four more lane
    gathers for the final mesh."""
    run = run_sfusion_cli(dev, rgbd, flow, os.path.join(out_dir, "sf_mesh.ply"))
    check_counts(run["counts"], "sfusion path", integrate_warped=SF_FRAMES,
                 row_gather=SF_FRAMES - 1,
                 lane_gather=4 * (SF_FRAMES - 1) + 4)
    return run


def phase_sfusion(dev, rgbd: str, flow: str, out_dir: str, sf_depth,
                  sf_flows, cli_run: dict) -> dict:
    """The SceneFusion path (the verb's run, ``phase_sfusion_cli``, is
    ``cli_run``): the ``SceneFusion`` class on the same files with dumps
    (bit-equal to a run through the plain twins and to a second run;
    the field against the flow that was fed); ms per frame, its split and
    its host syncs on frames already on the card."""
    import traceback
    import warnings

    from tsdf_tpu_torch.io.mock_kinect import MockKinect
    from tsdf_tpu_torch.io.sceneflow import PDSFMockSceneFlow
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.integrate import integrate_warped_cuda
    from tsdf_tpu_torch.ops.marching_cubes import extract_surface
    from tsdf_tpu_torch.pipelines import scenefusion as sf

    # the class on the same files, with a dump on the first and last frame
    dumps = os.path.join(out_dir, "sf_dumps")
    sfa = PDSFMockSceneFlow(flow)
    check(sfa.init(), "no scene-flow files")
    kinect = MockKinect(rgbd)
    kinect.initialise()
    fusion = sf.SceneFusion(sfa, kinect, sf.SceneFusionConfig(),
                            camera=sf_camera(dev), dump_every=SF_FRAMES - 1,
                            dump_dir=dumps, device=dev)
    reset_launch_counts()
    kinect.start()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"SceneFusion class with two dumps: launches {counts}")
    # as the verb's frames, plus per dump one dense extraction (four lane
    # gathers) and the 8 taps of deform_points (one row gather)
    check_counts(counts, "SceneFusion class", integrate_warped=SF_FRAMES,
                 row_gather=SF_FRAMES - 1 + 2,
                 lane_gather=4 * (SF_FRAMES - 1) + 2 * 4)
    n_corrs = [int(k) for k in fusion.correspondence_counts]
    log(f"correspondences per frame after the first: {n_corrs}")
    check(len(n_corrs) == SF_FRAMES - 1 and min(n_corrs) > 1000,
          "a frame found no correspondences")
    want = sorted(f"{stem}_{i:03d}.{ext}" for i in (0, SF_FRAMES - 1)
                  for stem, ext in (("frame", "tsdf"), ("mesh_canonical", "ply"),
                                    ("mesh_warped", "ply")))
    check(sorted(os.listdir(dumps)) == want, f"dump files {os.listdir(dumps)}")
    vol = fusion.volume

    # the same frames through the plain twins, and through the kernels again
    reset_launch_counts()
    with plain_twins():
        twin, twin_corrs, _ = sf_run(dev, sf_depth, sf_flows)
    torch.cuda.synchronize()
    check(launch_counts() == dict.fromkeys(launch_counts(), 0),
          "the all-twin run launched a kernel")
    again, again_corrs, overflows = sf_run(dev, sf_depth, sf_flows)
    torch.cuda.synchronize()
    check(not any(bool(o) for o in overflows), "the extraction overflowed")
    check([int(k) for k in twin_corrs] == n_corrs == [int(k) for k in again_corrs],
          "correspondence counts differ between the runs")
    for name, other in (("the all-twin run", twin), ("a second kernel run", again)):
        diff = {f: int((getattr(vol, f) != getattr(other, f)).sum())
                for f in ("tsdf", "weight", "deform")}
        log(f"sfusion {SF_FRAMES} frames at {SF_SIZE}^3 against {name}: values "
            f"that differ {diff}")
        check(not any(diff.values()), f"the SceneFusion path differs from {name}")
    del twin, again

    # the field against the flow that was fed
    delta = vol.deform - vol.voxel_centres()
    dx = delta[..., 0]
    full = int(((dx - SF_TOTAL_FLOW_MM).abs() < 1e-3).sum())
    moved = int((dx.abs() > 1e-3).sum())
    behind = delta[SF_SIZE // 2 + 5:]  # centres beyond z = 1325 mm
    log(f"deformation field after {SF_FRAMES} frames (flow fed: "
        f"{SF_TOTAL_FLOW_MM} mm in x): {moved} voxels moved in x, {full} of them "
        f"by the whole flow, x range {float(dx.min()):.4f}..{float(dx.max()):.4f} "
        f"mm; max |y| {float(delta[..., 1].abs().max()):.3g}, max |z| "
        f"{float(delta[..., 2].abs().max()):.3g} mm; behind the sphere's centre "
        f"max |move| {float(behind.abs().max()):.3g} mm")
    check(abs(float(dx.max()) - SF_TOTAL_FLOW_MM) < 1e-3 and float(dx.min()) > -1e-3,
          "the field's x range is not 0..the flow fed")
    check(full > 1000, "few voxels moved by the whole flow")
    check(float(delta[..., 1:].abs().max()) < 1e-3, "the field moved in y or z")
    check(float(behind.abs().max()) == 0.0, "voxels behind the surface moved")
    del delta, dx, behind

    def ply_vertices(name):
        with open(os.path.join(dumps, name)) as f:
            lines = f.read().splitlines()
        head = lines.index("end_header")
        (n,) = [int(h.split()[-1]) for h in lines[:head]
                if h.startswith("element vertex")]
        return np.array([ln.split() for ln in lines[head + 1:head + 1 + n]],
                        np.float64)

    last = f"{SF_FRAMES - 1:03d}"
    canon, warped = (ply_vertices(f"mesh_{k}_{last}.ply")
                     for k in ("canonical", "warped"))
    check(canon.shape == warped.shape and len(canon) > 1000, "dumped meshes")
    shift = warped - canon
    front = np.abs(np.linalg.norm(canon - np.asarray(SF_SPHERE[0]), axis=1)
                   - SF_SPHERE[1]) < 15.0
    log(f"dumped meshes ({len(canon)} vertices): deform_points moved them by "
        f"{shift[:, 0].min():.3f}..{shift[:, 0].max():.3f} mm in x (median of the "
        f"{int(front.sum())} near the sphere {np.median(shift[front, 0]):.3f}), "
        f"max |y, z| {np.abs(shift[:, 1:]).max():.3g} mm")
    check(shift[:, 0].min() > -1e-2
          and shift[:, 0].max() < SF_TOTAL_FLOW_MM + 1e-2, "warped mesh x range")
    check(shift[:, 0].max() > 0.5 * SF_TOTAL_FLOW_MM, "the warped mesh hardly moved")
    check(np.abs(shift[:, 1:]).max() < 1e-2, "the warped mesh moved in y or z")
    for name in os.listdir(dumps):
        os.remove(os.path.join(dumps, name))

    # ms per frame: the class on frames already on the card
    def timed():
        src = CardFrames(sf_depth, sf_flows)
        run = sf.SceneFusion(src, src, sf.SceneFusionConfig(),
                             camera=sf_camera(dev), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src.start()
        torch.cuda.synchronize()
        return run, (time.perf_counter() - t0) * 1e3 / SF_FRAMES

    timed()
    times = []
    for _ in range(3):
        run, ms = timed()
        times.append(ms)
    ms_frame = float(np.median(times))
    check(torch.equal(run.volume.deform, vol.deform)
          and torch.equal(run.volume.tsdf, vol.tsdf),
          "the card-resident run differs from the run on files")
    log(f"SceneFusion loop on the device, {SF_SIZE}^3 {W}x{H}: {ms_frame:.4f} "
        f"ms/frame (median of 3 runs of {SF_FRAMES} frames already on the card; "
        f"runs {', '.join(f'{t:.4f}' for t in times)})")

    syncs = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message) and "prototype" not in str(message):
            syncs.append((filename, lineno, traceback.extract_stack()[:-1]))

    src = CardFrames(sf_depth, sf_flows)
    sf.SceneFusion(src, src, sf.SceneFusionConfig(), camera=sf_camera(dev),
                   device=dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            src.start()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    per_frame = len(syncs) / (SF_FRAMES - 1)
    log(f"SceneFusion loop host syncs: {len(syncs)} in {SF_FRAMES - 1} frames "
        f"after the first ({per_frame:.3f} per frame)")
    places = {}
    for filename, lineno, stack in syncs:
        places.setdefault((filename, lineno), []).append(stack)
    for (filename, lineno), stacks in places.items():
        via = " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                          for f in reversed(stacks[0][-4:]))
        log(f"  {len(stacks)} at {filename}:{lineno} ({via})")
    check(len(syncs) <= SF_FRAMES - 1, "more than one host sync per frame")

    # the frame's stages by CUDA events
    cfg = sf.SceneFusionConfig()
    cam = sf_camera(dev)
    staged = cfg.make_volume(device=dev)
    staged = integrate_warped_cuda(staged, sf_depth, cam)
    split = dict(extract=0.0, update=0.0, integrate=0.0)
    marks = []
    for f in sf_flows:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        soup = extract_surface(staged, max_cubes=cfg.max_cubes, max_vertices=1,
                               layout="masked")
        ev[1].record()
        staged, _ = sf.update_deformation(staged, soup, sf_depth, cam, f,
                                          cfg.threshold_mm)
        ev[2].record()
        staged = integrate_warped_cuda(staged, sf_depth, cam)
        ev[3].record()
        marks.append(ev)
    torch.cuda.synchronize()
    for ev in marks:
        for i, name in enumerate(split):
            split[name] += ev[i].elapsed_time(ev[i + 1]) / len(marks)
    check(torch.equal(staged.deform, vol.deform), "the staged loop's field differs")
    log("SceneFusion frame by stage, CUDA events (extract masked, "
        "correspondences + update, integrate): "
        + ", ".join(f"{n} {t:.4f} ms" for n, t in split.items())
        + f"; sum {sum(split.values()):.4f} ms")
    return dict(counts=cli_run["counts"], cli_seconds=cli_run["seconds"],
                ms_per_frame=ms_frame, syncs_per_frame=per_frame, split_ms=split)


def phase_warped_color(dev, sf_depth) -> dict:
    """``fuse_frames`` on (depth, pose, rgb) triples into a deformed colour
    volume at 255^3: the pipeline sends them to the warped colour kernel."""
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames
    from tsdf_tpu_torch.pipelines.scenefusion import SceneFusionConfig

    cam = sf_camera(dev)
    vol = SceneFusionConfig().make_volume(device=dev).with_color()
    rgb = torch.full((H, W, 3), 200, dtype=torch.uint8, device=dev)
    triples = [(sf_depth, cam.pose, rgb)] * 3
    reset_launch_counts()
    vol, _ = fuse_frames(vol, cam, triples, FusionConfig(width=W, height=H))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"fuse_frames, colour frames into a deformed volume: launches {counts}")
    check_counts(counts, "deformed colour fuse", integrate_warped_color=3)
    coloured = vol.color[(vol.color.to(torch.int32) > 0).any(-1)]
    check(len(coloured) > 1000 and int(coloured.min()) == int(coloured.max()) == 200,
          "the deformed colour fuse did not store the frame's colour")
    check(float(vol.weight.max()) == 3.0, "deformed colour fuse weights")
    return counts


def sass_loop(lib_path: str, build_log: str, kernel: str) -> dict:
    """The registers of ``kernel`` (from the build log of ``-Xptxas=-v``)
    and the instructions of its longest innermost loop (the longest span of
    a backward branch in ``cuobjdump -sass`` of the library that holds no
    other such span), with the global loads among them; for a body that
    unrolls a loop with one expf an iteration, its instructions an expf
    (the span from the first MUFU.EX2 to the last over the expf between
    them); the shared-memory loads (LDS) of that loop."""
    import re

    text = open(build_log).read()
    regs = None
    for block in text.split("Function properties for ")[1:]:
        name = block.split()[0]
        m = re.search(r"Used (\d+) registers", block)
        if kernel in name and m:
            regs = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(
        __import__("tsdf_tpu_torch.kernels._build", fromlist=["x"]).nvcc_path()),
        "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = [f for f in sass.split("Function : ")[1:] if kernel in f.split()[0]]
    insts = [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body[0] if body else "")]
    spans = []
    for addr, t in insts:
        m = re.search(r"BRA.*0x([0-9a-f]+)$", t)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [a for a in spans
             if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in spans)]
    lo, hi = max(inner, key=lambda a: a[1] - a[0], default=(0, -1))
    span = [t for a, t in insts if lo <= a <= hi]
    ex2 = [i for i, (_, t) in enumerate(insts) if "MUFU.EX2" in t]
    per_expf = (ex2[-1] - ex2[0]) / (len(ex2) - 1) if len(ex2) > 2 else None
    return dict(registers=regs, instructions=len(insts), loop_instructions=len(span),
                loop_loads=sum("LDG" in t for t in span),
                loop_shared_loads=sum(re.search(r"(^|\s)LDS(\.|\s)", t) is not None
                                      for t in span),
                expf=len(ex2), instructions_per_expf=per_expf)


# -- differentiable fusion and raycast: the pose adjoint, the probe, and the
#    two pose recoveries (tools/run_config4b.py, tools/run_config4.py) -------

# Float32 operations of the pose adjoint: the integrate's prologue at every
# voxel and in front of the camera; an updated voxel's volume cotangents
# (dd: a division and a product; dw: min, difference, two products, a
# division, the cap factor and a sum), its coefficient, the image term (dx,
# dy: 3 each; dz: 10) and the 12 products and float64 sums
POSE_GRAD_OPS = dict(voxel=27, in_front=12, updated=10, band=41)
# the probe: per gather an index sum, a clip (2) and the add
PROBE_OPS_PER_GATHER = 4
PROBE_ROWS = 64 * 512  # tools/probe_gather_roofline.py: N_PROG x S rows
# dpinv: float64 sums of the same float32 terms in another order
POSE_GRAD_DPINV_RTOL = 1e-6
# the slab the adjoint's slab instance is timed on: a 4x1 mesh's second
# slab of the 512^3 volume
SLAB_Z0, SLAB_PLANES = SIZE // 4, SIZE // 4
# the walk kernel of each slab instance, by the volume's dtype (its
# registers are logged)
SLAB_WALK = {torch.float32: "pose_grad_walk_kernelIfLb1EE",
             torch.bfloat16: "pose_grad_walk_kernelI13__nv_bfloat16Lb1EE"}
# config4b (tools/run_config4b.py)
C4B_CAMERA = ((120.0, -80.0, -500.0), (0.0, 0.0, 1500.0))
C4B_DELTA0 = (0.004, -0.003, 0.002, 12.0, -9.0, 8.0)
C4B_STEPS = 14
# config4b through the parent's adjoint (``--parent``): the residual after
# C4B_STEPS steps may differ by this much
C4B_RESIDUAL_MM = 0.05
# config4 (tools/run_config4.py)
C4_SPHERES = [((-700.0, -500.0, 900.0), 250.0), ((650.0, 400.0, 1200.0), 300.0),
              ((-300.0, 700.0, 1800.0), 350.0)]
C4_CAMERA = ((40.0, -30.0, -420.0), (0.0, 0.0, 1500.0))
C4_PERTURB = (0.01, -0.008, 0.005, 15.0, -12.0, 16.0)
C4_ITERS = 80
C4_TERR_MM = 1.0
POSE_OFFSET = (-1500.0, -1500.0, 0.0)


def default_camera(dev, at, target):
    from tsdf_tpu_torch import Camera

    return Camera.default_depth_camera(device=dev).move_to(list(at)).look_at(
        list(target))


def parent_pose_grad(vol, depth, camera, gbar_d, gbar_w, cap_weight=False,
                     image_term=True):
    """``pose_grad_cuda`` on the parent library's entry point (``--parent``),
    called with that library's interface. The one-thread-per-voxel adjoint
    before the brick walk (its source reads ``gx_img``) takes the depth
    gradient images after the depth and one row of partials a 32 x 64-voxel
    tile of a z slice; the brick walk takes neither image and one row a
    brick. Not counted as a launch."""
    import ctypes

    from tsdf_tpu_torch.kernels import integrate as kint
    from tsdf_tpu_torch.kernels._build import stream_handle
    from tsdf_tpu_torch.ops.integrate_diff import depth_image_gradients

    source = os.path.join(PARENT_DIR, "tsdf_tpu_torch", "csrc",
                          "integrate_pose_grad.cu")
    per_voxel = "gx_img" in open(source).read()
    argtypes = list(kint.KERNEL_POSE_GRAD.argtypes)
    fn = PARENT_LIB.tsdf_integrate_pose_grad
    fn.argtypes = argtypes[:5] + [ctypes.c_void_p] * 2 + argtypes[5:] \
        if per_voxel else argtypes
    fn.restype = ctypes.c_int
    dev = vol.tsdf.device
    sz, sy, sx = vol.tsdf.shape
    h, w = depth.shape
    images = depth_image_gradients(depth) if per_voxel else ()
    params = kint._brick_params(vol, camera)
    dd, dw = torch.empty_like(vol.tsdf), torch.empty_like(vol.weight)
    nb = kint.brick_grid(vol.tsdf.shape)
    rows = (-(-sx // 32) * -(-sy // 64) * sz if per_voxel
            else nb[0] * nb[1] * nb[2])
    partials = torch.empty((rows, 12), dtype=torch.float64, device=dev)
    err = fn(vol.tsdf.data_ptr(), vol.weight.data_ptr(), gbar_d.data_ptr(),
             gbar_w.data_ptr(), depth.data_ptr(),
             *(t.data_ptr() for t in images), dd.data_ptr(),
             dw.data_ptr(), partials.data_ptr(), rows, params.data_ptr(), sx,
             sy, sz, w, h, int(bool(cap_weight)), int(bool(image_term)),
             stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"the parent's tsdf_integrate_pose_grad: error {err}")
    sums = partials.sum(dim=0).to(torch.float32)
    return dd, dw, torch.cat([sums.reshape(3, 4),
                              torch.zeros((1, 4), device=dev)])


@contextlib.contextmanager
def parent_adjoint():
    """``integrate_pose``'s backward on the parent's adjoint kernel."""
    from tsdf_tpu_torch.kernels import integrate as kint

    saved = kint.pose_grad_cuda
    kint.pose_grad_cuda = parent_pose_grad
    try:
        yield
    finally:
        kint.pose_grad_cuda = saved


def kernel_registers(names) -> dict:
    """Registers a thread of each named kernel, from the build log of
    ``-Xptxas=-v`` (``sass_loop``)."""
    from tsdf_tpu_torch.kernels import _build

    return {k: sass_loop(str(_build.library_path()),
                         str(_build.BUILD_DIR / "build.log"), k)["registers"]
            for k in names}


def compare_pose_grad(dev, frames) -> dict:
    """The pose-adjoint kernel against its twin at 512^3 / 640x480: the
    second frame's adjoint over a volume the first frame fused (its
    updated voxels blend into weight), with a seeded cotangent. dd and dw
    bit-equal, dpinv within POSE_GRAD_DPINV_RTOL of its largest entry and
    bit-equal with the plain model of its per-brick sums, a second launch
    bit-equal. Then its time, the share of bricks culled, a frame with no
    depth (a pure copy: dd and dw must equal the cotangents, dpinv 0) beside
    a device copy of the same bytes, the registers of its two brick
    kernels, its device time by kernel under the profiler, and with
    ``--parent`` the parent's kernel in turns."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import (
        brick_cull,
        integrate_cuda,
        pose_grad_cuda,
        pose_grad_partials,
    )
    from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad, sample_frame

    vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames]
    integrate_cuda(vol, frames[0][0], cams[0])
    depth, cam = frames[1][0], cams[1]
    gen = torch.Generator(device=dev).manual_seed(5)
    gd = torch.randn(vol.tsdf.shape, generator=gen, device=dev)
    gw = torch.randn(vol.tsdf.shape, generator=gen, device=dev)
    dd, dw, dp = pose_grad_cuda(vol, depth, cam, gd, gw)
    dd2, dw2, dp2 = pose_grad_cuda(vol, depth, cam, gd, gw)
    rd, rw, rp = integrate_pose_grad(vol, depth, cam, gd, gw)
    torch.cuda.synchronize()
    # the voxels the frame updates, and those in the band sdf < trunc,
    # where the pose terms are summed
    *_, sdf, updated = sample_frame(depth, vol, cam)
    in_band = int((updated & (sdf < vol.truncation_distance)).sum())
    del sdf
    n_upd = int(updated.sum())
    blended = int((updated & (vol.weight > 0)).sum())
    same = [int((a != b).sum()) for a, b in ((dd, rd), (dw, rw))]
    err = float((dp - rp).abs().max())
    scale = float(rp.abs().max())
    again = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in ((dd, dd2), (dw, dw2), (dp, dp2)))
    del dd2, dw2, rd, rw
    model = pose_grad_partials(vol, depth, cam, gd).sum(dim=0)
    as_model = torch.equal(dp[:3].view(torch.int32),
                           model.to(torch.float32).reshape(3, 4).view(torch.int32))
    del model
    log(f"pose adjoint 512^3: dd and dw differ from the twin on {same} "
        f"voxels; dpinv max |diff| {err:.4g} (largest entry {scale:.6g}); "
        f"{n_upd} voxels updated, {blended} of them blending into weight; "
        f"a second launch bit-equal: {again}; dpinv bit-equal with the "
        f"per-brick model's sums: {as_model}")
    log(f"pose adjoint dpinv rows R|t: {dp[:3].cpu().numpy().tolist()}")
    check(same == [0, 0], "the pose adjoint's dd/dw differ from the twin")
    check(err <= POSE_GRAD_DPINV_RTOL * scale, "the pose adjoint's dpinv disagrees")
    check(again, "two launches of the pose adjoint differ")
    check(as_model, "the pose adjoint's sums differ from the per-brick model")
    check(blended > 0 and scale > 0, "the pose adjoint did no work")
    culled = float(brick_cull(vol, depth, cam).float().mean())
    ms = median_ms(lambda: pose_grad_cuda(vol, depth, cam, gd, gw), reps=20)
    parent = None
    if PARENT_LIB is not None:
        pd, pw, pp = parent_pose_grad(vol, depth, cam, gd, gw)
        torch.cuda.synchronize()
        check(torch.equal(pd, dd) and torch.equal(pw, dw)
              and float((pp - rp).abs().max()) <= POSE_GRAD_DPINV_RTOL * scale,
              "the parent's pose adjoint disagrees with this tree's")
        del pd, pw, pp

        def parent_run():
            return parent_pose_grad(vol, depth, cam, gd, gw)

        parent = median_ms(parent_run, reps=20)
        ms2 = median_ms(lambda: pose_grad_cuda(vol, depth, cam, gd, gw), reps=20)
        parent2 = median_ms(parent_run, reps=20)
        log(f"pose adjoint 512^3 one frame, in turns: kernel {ms:.4f}, parent "
            f"{parent:.4f}, kernel {ms2:.4f}, parent {parent2:.4f} ms; the "
            f"slab-free instance over the parent's adjoint "
            f"{(ms + ms2) / (parent + parent2):.4f}")
    # a frame with no depth culls every brick: a copy of the cotangents
    no_depth = torch.zeros_like(depth)
    zd, zw, zp = pose_grad_cuda(vol, no_depth, cam, gd, gw)
    torch.cuda.synchronize()
    check(torch.equal(zd.view(torch.int32), gd.view(torch.int32))
          and torch.equal(zw.view(torch.int32), gw.view(torch.int32))
          and float(zp.abs().max()) == 0.0,
          "the pose adjoint of a frame with no depth is not a copy")
    del zd, zw, zp
    zero_depth_ms = median_ms(lambda: pose_grad_cuda(vol, no_depth, cam, gd, gw),
                              reps=20)
    parent_zero_depth_ms = None
    if PARENT_LIB is not None:
        parent_zero_depth_ms = median_ms(
            lambda: parent_pose_grad(vol, no_depth, cam, gd, gw), reps=20)
    # what a device copy of the same bytes takes (gbar_d, gbar_w into two
    # outputs), in the same call
    cd, cw = torch.empty_like(gd), torch.empty_like(gw)

    def copy_both():
        cd.copy_(gd)
        cw.copy_(gw)

    copy_ms = median_ms(copy_both, reps=20)
    del cd, cw
    registers = kernel_registers(["pose_grad_copy_kernelIfLb1ELb0EE",
                                  "pose_grad_walk_kernelIfLb0EE"])
    # device time by kernel: the copy of the culled bricks, the walk of the
    # live ones, the pre-passes and the wrapper's small launches
    split = {what: profile_and_log(
                 lambda: pose_grad_cuda(vol, d, cam, gd, gw),
                 f"pose adjoint 512^3, {what}")["top"]
             for what, d in (("frame", depth), ("no depth", no_depth))}
    # bytes: gbar_d, gbar_w in and dd, dw out at every voxel, tsdf and
    # weight at an updated one, depth and its two gradient images once
    o = POSE_GRAD_OPS
    least = bound(
        16 * vol.tsdf.numel() + 8 * n_upd + 3 * 4 * depth.numel(),
        o["voxel"] * vol.tsdf.numel() + o["in_front"] * voxels_in_front(vol, cam)
        + o["updated"] * n_upd + o["band"] * in_band)
    zero_bound = bound(16 * vol.tsdf.numel() + 4 * depth.numel(), 0)["bound_ms"]
    log(f"pose adjoint 512^3 one frame: kernel {ms:.4f} "
        f"ms, bound {least['bound_ms']:.4f} ms by {least['bound_by']} "
        f"({n_upd} updated, {in_band} in the band); {culled:.4f} of the bricks "
        f"culled; a frame with no depth {zero_depth_ms:.4f} ms (parent "
        f"{ms_text(parent_zero_depth_ms)}; bound {zero_bound:.4f} ms by bytes; "
        f"a device copy of gbar_d and gbar_w {copy_ms:.4f} ms); registers a "
        f"thread {registers}")
    slab = slab_adjoint(vol, depth, cam, gd, gw)
    return dict(max_abs_err=err, dd_dw_voxels_differ=sum(same),
                bit_equal_second_run=again, bit_equal_model_sums=as_model,
                slab=slab,
                ms=ms, updated=n_upd, in_band=in_band,
                culled_share=culled, zero_depth_ms=zero_depth_ms,
                zero_depth_bound_ms=zero_bound, copy_ms=copy_ms,
                registers=registers, device_ms_by_kernel=split, parent_ms=parent,
                parent_zero_depth_ms=parent_zero_depth_ms, **least,
                library_ms=None)


def slab_adjoint(vol, depth, cam, gd, gw) -> dict:
    """The adjoint's slab instance on planes SLAB_Z0 .. SLAB_Z0 +
    SLAB_PLANES - 1 of ``vol`` (a ``SlabVolume``, the instance of the
    volume's dtype): dd, dw and each brick's row of partials bit-equal with
    the twin on the slab (``integrate_pose_grad``, ``pose_grad_partials``)
    and with the same planes and bricks of the whole-volume kernel, one
    launch of the slab instance; its time, the twin's and the bound for the
    slab's work."""
    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.kernels import integrate as kint
    from tsdf_tpu_torch.ops.integrate_diff import (
        integrate_pose_grad,
        pose_inv_cotangent,
        sample_frame,
    )

    planes = slice(SLAB_Z0, SLAB_Z0 + SLAB_PLANES)
    slab = make_volume((SIZE,) * 3, PHYSICAL, dtype=vol.tsdf.dtype,
                       device=vol.device, slab=(SLAB_Z0, SLAB_PLANES))
    slab = slab.replace(tsdf=vol.tsdf[planes].contiguous(),
                        weight=vol.weight[planes].contiguous())
    sgd, sgw = gd[planes].contiguous(), gw[planes].contiguous()
    kern = kint.instance(kint.KERNEL_POSE_GRAD_SLAB, slab)
    before = kern.launches
    dd, dw, parts = kint._pose_grad_kernel(slab, depth, cam, sgd, sgw, False,
                                           True)
    launched = kern.launches - before
    wd, ww, wparts = kint._pose_grad_kernel(vol, depth, cam, gd, gw, False,
                                            True)
    rd, rw, rp = integrate_pose_grad(slab, depth, cam, sgd, sgw)
    model = kint.pose_grad_partials(slab, depth, cam, sgd)
    torch.cuda.synchronize()
    per_z = parts.shape[0] // (SLAB_PLANES // kint.BRICK[0])
    first = SLAB_Z0 // kint.BRICK[0] * per_z
    equal = dict(
        twin=bits_equal(dd, rd) and bits_equal(dw, rw),
        model=torch.equal(parts.view(torch.int64), model.view(torch.int64)),
        whole=bits_equal(dd, wd[planes]) and bits_equal(dw, ww[planes])
        and torch.equal(parts.view(torch.int64),
                        wparts[first:first + parts.shape[0]].view(torch.int64)))
    err = float((pose_inv_cotangent(parts.sum(dim=0)) - rp).abs().max())
    scale = float(rp.abs().max())
    del wd, ww, wparts, rd, rw, model
    what = f"pose adjoint's slab instance ({vol.tsdf.dtype}, planes " \
           f"{SLAB_Z0}..{SLAB_Z0 + SLAB_PLANES - 1} of 512^3)"
    log(f"{what}: bit-equal with the twin on the slab {equal['twin']}, per-brick "
        f"partials with its model {equal['model']}, with the whole volume's "
        f"planes and bricks {equal['whole']}; dpinv max |diff| {err:.4g} "
        f"(largest entry {scale:.6g}); launches {launched}")
    check(all(equal.values()) and launched == 1 and scale > 0
          and err <= POSE_GRAD_DPINV_RTOL * scale,
          f"{what} differs from its twin or the whole volume's kernel")
    *_, sdf, updated = sample_frame(depth, slab, cam)
    n_upd = int(updated.sum())
    in_band = int((updated & (sdf < slab.truncation_distance)).sum())
    del sdf, updated
    ms = median_ms(lambda: kint.pose_grad_cuda(slab, depth, cam, sgd, sgw),
                   reps=20)
    word = slab.tsdf.element_size()
    o = POSE_GRAD_OPS
    n = slab.tsdf.numel()
    least = bound(4 * word * n + 2 * word * n_upd + 3 * 4 * depth.numel(),
                  o["voxel"] * n + o["in_front"] * voxels_in_front(slab, cam)
                  + o["updated"] * n_upd + o["band"] * in_band)
    log(f"{what}: kernel {ms:.4f} ms, bound "
        f"{least['bound_ms']:.4f} ms by {least['bound_by']} ({n_upd} updated, "
        f"{in_band} in the band); registers a thread "
        f"{kernel_registers([SLAB_WALK[vol.tsdf.dtype]])}")
    return dict(max_abs_err=err, ms=ms, updated=n_upd,
                in_band=in_band, **least, library_ms=None)


def compare_probe(dev) -> dict:
    """The gather-roofline probe at tools/probe_gather_roofline.py's shape
    ((64 x 512, 128) table, 64 chained gathers) against its twin (out
    equal), the card's in-row gather rate it reaches, and beside the
    operation bound its two floors: the shared-memory wavefronts these
    indices take (``probe_wavefronts``) at one an SM a clock, and the
    instructions of its gather loop (SASS) at 4 warp instructions an SM a
    clock. With ``--parent``, the parent's kernel in turns."""
    from tsdf_tpu_torch.kernels import _build
    from tsdf_tpu_torch.kernels.gather import (
        KERNEL_PROBE,
        PROBE_GATHERS,
        gather_probe_cuda,
        gather_probe_plain,
        probe_wavefronts,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    tab = torch.randn(PROBE_ROWS, 128, generator=gen, device=dev)
    idx = torch.randint(0, 128, (PROBE_ROWS, 128), generator=gen, device=dev,
                        dtype=torch.int32)
    got = gather_probe_cuda(tab, idx)
    want = gather_probe_plain(tab, idx)
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(differ == 0, "the gather probe disagrees with its twin")
    ms = median_ms(lambda: gather_probe_cuda(tab, idx), reps=20)
    parent = parent_in_turns([KERNEL_PROBE], lambda: gather_probe_cuda(tab, idx),
                             20, ms, "gather probe")
    n = tab.numel() * PROBE_GATHERS
    rate = n / (ms / 1e3)
    least = bound(3 * 4 * tab.numel(), PROBE_OPS_PER_GATHER * n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = loaded_sm_clock_mhz(lambda: gather_probe_cuda(tab, idx))
    wavefronts = probe_wavefronts(idx)
    wave_floor = wavefronts / (sms * mhz * 1e6) * 1e3
    loop = sass_loop(str(_build.library_path()),
                     str(_build.BUILD_DIR / "build.log"), "probe_gather_kernel")
    per_gather = loop["loop_instructions"] / loop["loop_shared_loads"]
    issue_floor = per_gather * n / 32 / (4 * sms * mhz * 1e6) * 1e3
    reached = wavefronts / (ms / 1e3) / (sms * mhz * 1e6)
    log(f"gather probe: {ms:.4f} ms (parent {ms_text(parent)}) for {n} gathered "
        f"elements = {rate / 1e9:.1f} G elements/s ("
        f"bound {least['bound_ms']:.4f} ms by {least['bound_by']}); "
        f"{loop['registers']} registers")
    log(f"gather probe floors at {mhz:.0f} MHz (the SM clock nvidia-smi reads "
        f"under the kernel) x {sms} SMs: shared-memory wavefronts "
        f"{wavefronts} ({wavefronts / (n / 32):.4f} a warp-load) at one an SM "
        f"a clock = {wave_floor:.4f} ms; issue rate {per_gather:.4f} SASS "
        f"instructions a gather ({loop['loop_instructions']} in the loop, "
        f"{loop['loop_shared_loads']} shared loads) / 32 / 4 a clock = "
        f"{issue_floor:.4f} ms; reached {reached:.3f} wavefronts an SM a clock")
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                parent_ms=parent,
                g_elements_per_s=rate / 1e9, **least, library_ms=None,
                wavefronts=wavefronts, wavefront_floor_ms=wave_floor,
                wavefronts_per_clock=reached, issue_floor_ms=issue_floor,
                instructions_per_gather=per_gather, sm_clock_mhz=mhz,
                registers=loop["registers"])


def profile_and_log(fn, what: str, n: int = 3) -> dict:
    """``profile_step(fn, n)``, its top kernels and host operators and its
    totals logged; returns what it returned."""
    prof = profile_step(fn, n)
    for name, count, ms in prof["top"]:
        log(f"{what} step, kernel {name}: {count} a step, {ms:.4f} ms a step")
    for name, count, ms, us in prof["host"]:
        log(f"{what} step, host op {name}: {count} a step, {ms:.4f} ms of "
            f"host time a step, {us:.1f} us a call")
    log(f"{what} step under the profiler: device busy {prof['busy_ms']:.4f} "
        f"ms, {prof['launches']:.0f} kernel launches, {prof['syncs']:.0f} "
        "host syncs a step")
    return prof


def c4b_depth() -> np.ndarray:
    """config4b's frame: a sphere and three bumps, so that all six degrees
    of freedom are observable (tools/run_config4b.py)."""
    from tsdf_tpu_torch.utils import fixtures

    depth = fixtures.sphere_depth_map(W, H, 150.0, 1000.0, 2500.0)
    ys, xs = np.mgrid[0:H, 0:W]
    for cx_, cy_, r_ in ((160, 120, 90.0), (480, 120, 70.0), (480, 360, 110.0)):
        rr = (xs - cx_) ** 2 + (ys - cy_) ** 2
        depth = np.where(rr < r_ ** 2, 900.0 + 0.3 * np.sqrt(rr), depth)
    return depth.astype(np.float32)


def phase_config4b(dev) -> dict:
    """tools/run_config4b.py on the card: pose recovery THROUGH fusion at
    512^3 / 640x480. The target is the four-bump frame fused at the true
    pose; from delta0, 14 normalised steps of the masked MSE loss through
    integrate_pose (integrate kernel forward, pose-adjoint kernel
    backward), keeping the best iterate. First the gradient at delta0
    through the kernels against the same through the plain twins."""
    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.kernels import integrate as kint
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain
    from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad
    from tsdf_tpu_torch.pipelines.pose_recovery import (
        descend_through_fusion,
        fusion_loss_and_grad,
    )

    vol = make_volume((SIZE,) * 3, PHYSICAL, offset=POSE_OFFSET, device=dev)
    cam = default_camera(dev, *C4B_CAMERA)
    depth = torch.from_numpy(c4b_depth()).to(dev)
    with torch.no_grad():
        target, miss = kint.integrate_pose(vol, depth, cam, torch.zeros(6, device=dev),
                                           mode="line")
    check(int(miss) == 0, "config4b: the target fusion missed voxels")
    delta0 = torch.tensor(C4B_DELTA0, dtype=torch.float32, device=dev)

    # the gradient at delta0 through the kernels, then through the twins
    loss_k, g_k = fusion_loss_and_grad(vol, depth, cam, target, delta0)

    def integrate_twin(v, d, c, cap_weight=False):
        out = integrate_plain(v, d, c, cap_weight=cap_weight)
        v.tsdf.copy_(out.tsdf)
        v.weight.copy_(out.weight)
        return v

    saved = kint.integrate_cuda, kint.pose_grad_cuda
    kint.integrate_cuda, kint.pose_grad_cuda = integrate_twin, integrate_pose_grad
    try:
        loss_t, g_t = fusion_loss_and_grad(vol, depth, cam, target, delta0)
    finally:
        kint.integrate_cuda, kint.pose_grad_cuda = saved
    g_err = float((g_k - g_t).abs().max())
    g_scale = float(g_t.abs().max())
    log(f"config4b: gradient at delta0 through the kernels "
        f"{g_k.cpu().numpy().tolist()}, through the twins "
        f"{g_t.cpu().numpy().tolist()}: max |diff| {g_err:.4g}; loss "
        f"{float(loss_k):.6f} / {float(loss_t):.6f}")
    check(float(loss_k) == float(loss_t), "config4b: kernel and twin losses differ")
    check(g_err <= 1e-5 * g_scale, "config4b: kernel and twin gradients differ")

    def step():
        return fusion_loss_and_grad(vol, depth, cam, target, delta0)

    step_ms = median_ms(step, reps=5)
    parent_step_ms = None
    if PARENT_LIB is not None:
        # the same step with the parent's adjoint, in turns
        with parent_adjoint():
            parent_step_ms = median_ms(step, reps=5)
        step_ms2 = median_ms(step, reps=5)
        with parent_adjoint():
            parent_step_ms2 = median_ms(step, reps=5)
        log(f"config4b value-and-grad step by CUDA events, in turns: kernel "
            f"{step_ms:.4f}, parent's adjoint {parent_step_ms:.4f}, kernel "
            f"{step_ms2:.4f}, parent's adjoint {parent_step_ms2:.4f} ms")
    prof = profile_and_log(
        lambda: fusion_loss_and_grad(vol, depth, cam, target, delta0),
        "config4b value-and-grad")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    best, best_loss, history = descend_through_fusion(
        vol, depth, cam, target, delta0, steps=C4B_STEPS)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    for i, h in enumerate(history):
        log(f"config4b iter {i}: loss {h['loss']:.6f}, |v| {h['v_mm']:.4f} mm, "
            f"|w| {h['w_mrad']:.4f} mrad, {h['seconds'] * 1e3:.3f} ms")
    v0 = float(torch.linalg.vector_norm(delta0[3:]))
    resid = float(torch.linalg.vector_norm(best[3:]))
    host_ms = float(np.median([h["seconds"] for h in history])) * 1e3
    log(f"config4b 512^3: {C4B_STEPS} steps in {seconds:.3f} s; value-and-grad "
        f"step {step_ms:.4f} ms by CUDA events, {host_ms:.4f} ms median on the "
        f"host with its sync; best loss {best_loss:.6f} (start "
        f"{history[0]['loss']:.6f}); translation residual {resid:.4f} mm "
        f"(start {v0:.4f}); peak device memory {peak_gib:.3f} GiB; launches "
        f"integrate {counts['integrate']}, integrate_pose_grad "
        f"{counts['integrate_pose_grad']}")
    check(counts["integrate"] == C4B_STEPS + 1
          and counts["integrate_pose_grad"] == C4B_STEPS + 1,
          "config4b: unexpected launch counts")
    check(best_loss < history[0]["loss"], "config4b: the loss did not fall")
    check(resid < v0, "config4b: the translation residual did not fall")
    parent_resid = None
    if PARENT_LIB is not None:
        # the same descent through the parent's adjoint: the float64 sums
        # change order, not value, so the residual stays where it was
        with parent_adjoint():
            parent_best, _, _ = descend_through_fusion(
                vol, depth, cam, target, delta0, steps=C4B_STEPS)
        parent_resid = float(torch.linalg.vector_norm(parent_best[3:]))
        log(f"config4b: translation residual after {C4B_STEPS} steps "
            f"{resid:.4f} mm, through the parent's adjoint {parent_resid:.4f} mm")
        check(abs(resid - parent_resid) <= C4B_RESIDUAL_MM,
              "config4b: the residual moved away from the parent's")
    return dict(counts=counts, step_ms=step_ms, parent_step_ms=parent_step_ms,
                parent_residual_mm=parent_resid, host_step_ms=host_ms,
                seconds=seconds, best_loss=best_loss,
                start_loss=history[0]["loss"], residual_mm=resid,
                start_mm=v0, peak_gib=peak_gib, grad_err=g_err,
                profile=prof, history=history)


def c4_scene(dev):
    """Config 4's problem at 512^3 / 640x480: (the scene of four spheres
    and a wall, the true camera, the target depth rendered there and its
    hits, the camera at the perturbed pose)."""
    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.ops.raycast_diff import depth_image_diff
    from tsdf_tpu_torch.utils import fixtures
    from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

    scene = fixtures.sphere_tsdf(
        make_volume((SIZE,) * 3, PHYSICAL, offset=POSE_OFFSET, device=dev), 600.0)
    tsdf = scene.tsdf
    for c, r in C4_SPHERES:
        tsdf = torch.minimum(tsdf, fixtures.sphere_tsdf(scene, r, centre=c).tsdf)
    tsdf = torch.minimum(tsdf, fixtures.wall_tsdf(scene, 2500.0).tsdf)
    scene = scene.replace(tsdf=tsdf.contiguous(),
                          weight=torch.ones_like(scene.weight))
    del tsdf
    cam_true = default_camera(dev, *C4_CAMERA)
    with torch.no_grad():
        target, hit = depth_image_diff(scene, cam_true, W, H)
    xi_p = torch.tensor(C4_PERTURB, dtype=torch.float32, device=dev)
    cam0 = cam_true.set_pose(matmul_small(se3_exp(xi_p), cam_true.pose))
    return scene, cam_true, target.detach(), hit, cam0


# float32 operations a linearised ray takes in csrc/lm_linearise.cu, counted
# from its source: the direction 36, the sample and its gradient 120, the
# correction and depth 30, each twist axis's tangent 84, the 29 float64
# sums as 58
LM_OPS_PER_RAY = 36 + 120 + 30 + 6 * 84 + 58
# the twist of the timed linearisation: config 4's second step's size
C4_XI = (-0.004, 0.006, -0.002, -8.0, 9.0, -6.0)


def compare_lm_linearise(dev) -> dict:
    """``csrc/lm_linearise.cu`` at config 4's shapes (512^3, 640x480) on
    the float32 and the bf16 volume: two calls bit-equal, the sums against
    the plain twin on the card (within 1e-5 of their scale: the twin's
    depth is a matrix product and its pose tangents forward mode), its
    time against its bound, the twin's, and the route it replaced (the
    reverse-mode slope, six forward-mode dual passes through
    ``banded_residuals`` and the float32 normal equations)."""
    import torch.autograd.forward_ad as fwAD

    from tsdf_tpu_torch.kernels import lm
    from tsdf_tpu_torch.ops.lm_linearise import linearise, normal_equations
    from tsdf_tpu_torch.ops.raycast_diff import march, slope
    from tsdf_tpu_torch.pipelines.pose_recovery import (
        BAND_MM,
        _twisted,
        banded_residuals,
    )

    scene, _cam_true, target, _hit, cam0 = c4_scene(dev)
    xi = torch.tensor(C4_XI, dtype=torch.float32, device=dev)
    cam = _twisted(cam0, xi)
    out = {}
    for name, vol in (("f32", scene), ("bf16", scene.astype(BF16))):
        t0, hit = march(vol, cam, W, H)

        def kernel():
            return lm.lm_linearise(vol, cam0, cam, xi, t0, hit, target, BAND_MM)

        def twin():
            return linearise(vol, cam0, cam, xi, t0, hit, target, BAND_MM)

        def dual_passes():
            fp = slope(vol, cam, t0, W, H)
            cols = []
            tangents = torch.eye(6, dtype=torch.float32, device=dev)
            with fwAD.dual_level():
                for j in range(6):
                    x = fwAD.make_dual(xi, tangents[j])
                    rj, _m = banded_residuals(vol, _twisted(cam0, x), target, t0,
                                              hit, fp=fp)
                    cols.append(fwAD.unpack_dual(rj).tangent.reshape(-1))
            jac = torch.stack(cols, dim=-1)
            return jac.T @ jac

        sums, again, want = kernel(), kernel(), twin()
        torch.cuda.synchronize()
        check(bits_equal(sums.view(torch.float32), again.view(torch.float32)),
              f"lm_linearise {name}: two calls differ")
        got, ref = normal_equations(sums), normal_equations(want)
        scale = torch.sqrt(torch.diag(ref[0]))
        gap_jtj = float(((got[0] - ref[0]).abs() / (scale[:, None] * scale[None, :])).max())
        gap_jtr = float(((got[1] - ref[1]).abs() / (scale * float(ref[2]) ** 0.5)).max())
        gap_rr = abs(float(got[2] - ref[2])) / float(ref[2])
        inliers, want_inliers = int(got[3]), int(ref[3])
        log(f"lm_linearise {name} 512^3 {W}x{H}: against the twin J^T J "
            f"{gap_jtj:.3e}, J^T r {gap_jtr:.3e}, r^2 {gap_rr:.3e} of their "
            f"scale; inliers {inliers} / {want_inliers}")
        check(max(gap_jtj, gap_jtr, gap_rr) <= 1e-5 and abs(inliers - want_inliers) <= 4,
              f"lm_linearise {name}: the kernel's sums are off the twin's")
        ms = median_ms(kernel, reps=20)
        dual = median_ms(dual_passes, reps=3)
        # each ray's t0, hit and target; the eight taps of each ray the kernel
        # samples (a hit with target depth)
        sampled = int((hit & (target.reshape(-1) > 0)).sum())
        moved = W * H * 9 + sampled * 8 * vol.tsdf.element_size()
        b = bound(moved, sampled * LM_OPS_PER_RAY)
        log(f"lm_linearise {name}: {ms:.4f} ms (bound {b['bound_ms']:.4f} by "
            f"{b['bound_by']}, {sampled} rays sampled); "
            f"the dual-pass route it replaced {dual:.4f} ms")
        out[name] = dict(kernel_ms=ms, dual_pass_ms=dual,
                         gaps=[gap_jtj, gap_jtr, gap_rr], inliers=inliers,
                         sampled_rays=sampled, **b)
        del vol
        torch.cuda.empty_cache()
    return out


def phase_config4(dev) -> dict:
    """tools/run_config4.py on the card: pose recovery through the
    differentiable raycast at 512^3 / 640x480. The scene is four spheres
    and a wall; the target depth is rendered at the true pose; from the
    perturbed pose, Levenberg-Marquardt on the banded depth residuals
    (one raycast-kernel march and one linearisation kernel a step) until
    the translation error is under 1 mm."""
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.pipelines.pose_recovery import lm_step, recover_pose_lm
    from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

    scene, cam_true, target, hit, cam0 = c4_scene(dev)

    def terr(xi):
        pose = matmul_small(se3_exp(xi), cam0.pose)
        return float(torch.linalg.vector_norm((pose - cam_true.pose)[:3, 3]))

    zero = torch.zeros(6, device=dev)
    terr0 = terr(zero)
    log(f"config4: target hits {int(hit.sum())} of {W * H} pixels; initial "
        f"pose offset {terr0:.4f} mm")
    step_ms = median_ms(lambda: lm_step(scene, cam0, target, zero, 1e-2), reps=5)
    prof = profile_and_log(lambda: lm_step(scene, cam0, target, zero, 1e-2),
                           "config4 LM")
    errors = []

    def stop(xi):
        errors.append(terr(xi))
        return errors[-1] < C4_TERR_MM

    reset_launch_counts()
    t0 = time.perf_counter()
    xi, history = recover_pose_lm(scene, cam0, target, iters=C4_ITERS, stop=stop)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    for i, (h, e) in enumerate(zip(history, errors)):
        log(f"config4 iter {i}: rms {h['rms']:.4f} mm, lam {h['lam']:.1e}, "
            f"terr {e:.4f} mm, {h['seconds'] * 1e3:.3f} ms")
    iters = len(history)
    per_step = seconds / iters * 1e3
    log(f"config4 512^3 {W}x{H}: {per_step:.4f} ms a Levenberg-Marquardt step "
        f"(host clock, with its sync), {step_ms:.4f} ms by CUDA events; pose "
        f"recovered to {errors[-1]:.4f} mm in {iters} iterations (start "
        f"{terr0:.4f} mm); launches raycast {counts['raycast']}, lm_linearise "
        f"{counts['lm_linearise']}")
    check(errors[-1] < C4_TERR_MM, "config4: the pose was not recovered to 1 mm")
    check(counts["raycast"] == iters, "config4: one march a step expected")
    check(counts["lm_linearise"] == iters, "config4: one linearisation a step expected")
    return dict(counts=counts, iters=iters, step_ms=step_ms,
                host_step_ms=per_step, start_mm=terr0, final_mm=errors[-1],
                errors=errors, rms=[h["rms"] for h in history], profile=prof)


# -- bfloat16 volume storage ------------------------------------------------------

BF16 = torch.bfloat16
# the bf16 fusion of n frames against the float32 fusion of the same
# frames: weights equal, and tsdf within n / 2 bf16 ulps at its largest
# magnitude: each stored update rounds by at most half an ulp, and the
# running mean carries an earlier rounding forward with a weight below 1
# (for 3 frames about the JAX package's own gate of one ulp,
# tests/test_integrate.py:204)
BF16_ULPS_PER_FRAME = 0.5
# the bf16 and float32 meshes of the same frames: vertex counts this close
BF16_MESH_REL = 0.01


def bits_equal(a, b) -> bool:
    """Equal bit for bit, NaN included: bf16 as 16-bit words, else 32."""
    word = torch.int16 if a.dtype == BF16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(word), b.view(word))


def in_turns(fn16, fn32, reps: int, inner: int = 1):
    """Median ms of the bf16 and the float32 instance, in turns (bf16,
    f32, bf16, f32): (the first bf16 time, the first f32 time, all four)."""
    t = [median_ms(f, reps=reps, inner=inner) for f in (fn16, fn32, fn16, fn32)]
    return t[0], t[1], t


def bf16_integrates(dev, frames, rgbs) -> dict:
    """The brick walk's four bf16 instances at 512^3 against their bf16
    twins over the first two frames (the second blends into weighted,
    coloured voxels): tsdf and weight bit-equal (the dtype kept), colour
    bytes and miss counts equal. Each timed in turns with its float32
    instance on a float32 volume of the same two frames; the bound with
    2-byte storage (8 B of tsdf and weight read and written per updated
    voxel)."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import _build
    from tsdf_tpu_torch.kernels import integrate as k
    from tsdf_tpu_torch.kernels.integrate import (
        instance,
        integrate_color_cuda,
        integrate_cuda,
        integrate_fast_cuda,
    )
    from tsdf_tpu_torch.ops.integrate import integrate, integrate_fast

    BF16_WALKS = {"integrate": k.KERNEL, "integrate_color": k.KERNEL_COLOR,
                  "integrate_fast": k.KERNEL_FAST,
                  "integrate_color_fast": k.KERNEL_COLOR_FAST}
    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames]
    depths = [d for d, _ in frames]

    def kernel(name, vol, i):
        if name == "integrate":
            return integrate_cuda(vol, depths[i], cams[i]), 0
        if name == "integrate_fast":
            return integrate_fast_cuda(vol, depths[i], cams[i])
        mode = "fast" if name == "integrate_color_fast" else "exact"
        return integrate_color_cuda(vol, depths[i], rgbs[i], cams[i], mode=mode)

    def twin(name, vol, i):
        rgb = rgbs[i] if "color" in name else None
        if "fast" in name:
            return integrate_fast(vol, depths[i], cams[i], rgb=rgb)
        return integrate(vol, depths[i], cams[i], rgb=rgb), 0

    results = {}
    for name in ("integrate", "integrate_color", "integrate_fast",
                 "integrate_color_fast"):
        color = "color" in name
        ref, out = (make_volume((SIZE,) * 3, PHYSICAL, with_color=color,
                                dtype=BF16, device=dev) for _ in range(2))
        out32 = make_volume((SIZE,) * 3, PHYSICAL, with_color=color, device=dev)
        for i in range(2):
            before = ref
            ref, want_miss = twin(name, ref, i)
            out, miss = kernel(name, out, i)
            out32, _ = kernel(name, out32, i)
            check(int(miss) == int(want_miss),
                  f"{name} bf16: miss count {int(miss)}, twin {int(want_miss)}")
        torch.cuda.synchronize()
        blended = int(((ref.weight > before.weight) & (before.weight > 0)).sum())
        equal = (out.tsdf.dtype == BF16 and bits_equal(out.tsdf, ref.tsdf)
                 and bits_equal(out.weight, ref.weight)
                 and (not color or torch.equal(out.color, ref.color)))
        err = float((out.tsdf.float() - ref.tsdf.float()).abs().max())
        updated = int((ref.weight > before.weight).sum())
        band = int(((ref.color != before.color).any(-1)).sum()) if color else 0
        log(f"{name} bf16 512^3, two frames: tsdf, weight"
            + (", colour" if color else "") + f" bit-equal with the bf16 "
            f"twin: {equal} (max |tsdf diff| {err:.3g} mm); the second frame "
            f"blended into {blended} voxels of weight > 0; miss {int(miss)}")
        check(blended > 0, f"{name} bf16: nothing was blended into")
        check(equal, f"{name} bf16 differs from its twin")
        ms, f32_ms, turns = in_turns(lambda: kernel(name, out, 1),
                                     lambda: kernel(name, out32, 1), reps=20)
        fast = "fast" in name
        pixels = W * H // 8 if fast else W * H
        moved = 8 * updated + pixels * 4 + (6 * band + pixels * 3) * color
        if fast:
            ops = (FAST_OPS["voxel"] * SIZE**3 + FAST_OPS["column"] * SIZE**2
                   + FAST_OPS["updated"] * updated)
        else:
            ops = (INTEGRATE_OPS["voxel"] * SIZE**3
                   + INTEGRATE_OPS["in_front"] * voxels_in_front(ref, cams[1])
                   + INTEGRATE_OPS["updated"] * updated)
        ops += COLOR_OPS_PER_BAND_VOXEL * band
        least = bound(moved, ops)
        # the two instances' code (of a whole volume, not a slab):
        # registers, SASS instructions, and the longest inner loop's
        # instructions and global loads
        args = f"Lb{int(fast)}ELb{int(color)}ELb0E"
        sass = {d: sass_loop(str(_build.library_path()),
                             str(_build.BUILD_DIR / "build.log"),
                             f"integrate_kernelI{m}{args}")
                for d, m in (("bf16", "13__nv_bfloat16"), ("f32", "f"))}
        log(f"{name} bf16 512^3 one frame: kernel {ms:.4f} ms, float32 "
            f"instance {f32_ms:.4f} ms (in turns: "
            + ", ".join(f"{t:.4f}" for t in turns)
            + f"), bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({updated} voxels updated, 2-byte storage); "
            + "; ".join(f"{d}: {v['registers']} registers, {v['instructions']} "
                        f"SASS instructions, inner loop {v['loop_instructions']} "
                        f"({v['loop_loads']} global loads)"
                        for d, v in sass.items()))
        # with --parent: the parent's bf16 instance in turns with this one
        parent = parent_in_turns(
            [instance(BF16_WALKS[name], out)], lambda: kernel(name, out, 1),
            20, ms, f"{name} bf16 512^3 one frame")
        results[name + "_bf16"] = dict(
            max_abs_err=err, ms=ms, **least,
            library_ms=None, f32_ms=f32_ms, updated=updated, parent_ms=parent)
        del ref, out, out32, before
        torch.cuda.empty_cache()
    return results


def bf16_fuse_paths(dev, frames, rgbs, gt_poses) -> dict:
    """The main paths on a bf16 volume, each with the counts set to 0
    just before and read just after: ``fuse_frames`` of the 20 frames at
    512^3 in depth, colour, fast and colour-fast modes (the bf16 instance
    launched once a frame, no other kernel), each against the same path on
    a float32 volume: weights (and colour bytes) equal, tsdf within
    BF16_ULPS_PER_FRAME ulps a frame at its largest magnitude; the device
    peak of the depth fuse, float32 against bf16 (the volume made in its
    dtype), and ms/frame of both loops; then the tracked loop on a bf16
    volume (the raycast's bf16 instance each frame after the first; ATE
    under one voxel). Returns the fused depth-mode volumes and the launch
    counts of each path."""
    import warnings

    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.pipelines.kinfu import (
        FusionConfig,
        fuse_frames,
        track_and_fuse_frames,
    )
    from tsdf_tpu_torch.utils.trajectory import ate

    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    triples = [(d, p, c) for (d, p), c in zip(frames, rgbs)]
    n = len(frames)
    out = {"counts": {}}
    for mode in ("depth", "colour", "fast", "colour-fast"):
        color = mode.startswith("colour")
        cfg = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                           width=W, height=H,
                           integrate_mode="fast" if "fast" in mode else "exact")
        source = triples if color else frames
        name = {"depth": "integrate", "colour": "integrate_color",
                "fast": "integrate_fast",
                "colour-fast": "integrate_color_fast"}[mode] + "_bf16"
        runs, peaks, seconds = {}, {}, {}
        for dtype in (BF16, torch.float32):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            vol = make_volume((SIZE,) * 3, PHYSICAL, with_color=color,
                              dtype=dtype, device=dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                vol, _ = fuse_frames(vol, cam, source, cfg)
            torch.cuda.synchronize()
            seconds[dtype] = time.perf_counter() - t0
            counts = launch_counts()
            peaks[dtype] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
            check(not [w for w in caught if "skipped" in str(w.message)],
                  f"fuse_frames {mode}: voxels were skipped")
            if dtype == BF16:
                log(f"fuse_frames {mode}, bf16 volume, {n} frames: launches "
                    f"{counts}")
                check_counts(counts, f"fuse_frames {mode} bf16", **{name: n})
                check(vol.tsdf.dtype == vol.weight.dtype == BF16,
                      f"fuse_frames {mode}: the volume left bf16")
                out["counts"][name] = counts[name]
            runs[dtype] = vol
        v16, v32 = runs[BF16], runs[torch.float32]
        same_w = torch.equal(v16.weight.float(), v32.weight)
        same_c = not color or torch.equal(v16.color, v32.color)
        gap = float((v16.tsdf.float() - v32.tsdf).abs().max())
        scale = float(v32.tsdf.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        gate = BF16_ULPS_PER_FRAME * n * ulp
        log(f"fuse_frames {mode}, 512^3, bf16 against float32: weights equal "
            f"{same_w}" + (f", colour bytes equal {same_c}" if color else "")
            + f"; max |tsdf diff| {gap:.4f} mm = {gap / ulp:.2f} ulps of "
            f"{ulp:g} mm at the largest magnitude {scale:.4f} (gate {n} / 2 "
            f"ulps = {gate:.4f} mm); device peak above the frames "
            f"{peaks[BF16]:.3f} GiB bf16, {peaks[torch.float32]:.3f} GiB float32;"
            f" {seconds[BF16]:.3f} s / {seconds[torch.float32]:.3f} s with the "
            "volume's allocation")
        check(same_w and same_c, f"fuse_frames {mode}: bf16 weights or colour "
              "differ from float32's")
        check(gap <= gate,
              f"fuse_frames {mode}: bf16 tsdf beyond bf16 rounding of f32")
        out[mode] = dict(peak_gib_bf16=peaks[BF16],
                         peak_gib_f32=peaks[torch.float32], tsdf_gap_mm=gap,
                         tsdf_gap_ulps=gap / ulp)
        if mode == "depth":
            out["fused"] = runs
            # timed on copies: the fused volumes are rendered and meshed next
            t16, t32 = (v.replace(tsdf=v.tsdf.clone(), weight=v.weight.clone())
                        for v in (v16, v32))
            ms16, ms32, turns = in_turns(
                lambda: fuse_frames(t16, cam, frames, cfg),
                lambda: fuse_frames(t32, cam, frames, cfg), reps=3)
            del t16, t32
            log(f"fuse loop on the device, 512^3, ms/frame, bf16 and float32 "
                f"volumes in turns: " + ", ".join(f"{t / n:.4f}" for t in turns))
            out[mode].update(ms_per_frame_bf16=ms16 / n,
                             ms_per_frame_f32=ms32 / n)
        del runs, v16, v32, vol
        torch.cuda.empty_cache()

    # the tracked loop on a bf16 volume
    cfg = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL,
                       width=W, height=H, use_bilateral_filter=True)
    depths = [d for d, _ in frames]
    reset_launch_counts()
    vol, _cam, poses, stats = track_and_fuse_frames(
        cfg.make_volume(device=dev).astype(BF16), cam.set_pose(frames[0][1]),
        depths, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"track_and_fuse_frames, bf16 volume, {n} frames: launches {counts}")
    check_counts(counts, "tracked bf16", at_least=dict(lane_gather=19 * (n - 1)),
                 integrate_bf16=n, raycast_bf16=n - 1, bilateral=n - 1)
    a = ate([p.cpu().numpy() for p in poses], gt_poses)
    inliers = [int(k) for _, k in stats[1:]]
    log(f"tracked on a bf16 volume: ATE rmse {a['rmse']:.4f} mm (max "
        f"{a['max']:.4f}), inliers {min(inliers)}..{max(inliers)}")
    check(vol.tsdf.dtype == BF16, "the tracked loop's volume left bf16")
    check(a["rmse"] < ATE_MAX_MM, "bf16 tracked ATE is not under one voxel")
    check(min(inliers) > 0.02 * W * H, "bf16 tracked loop lost a frame")
    out["counts"]["raycast_bf16"] = counts["raycast_bf16"]
    out["tracked_ate_mm"] = a["rmse"]
    return out


def bf16_raycast_and_mesh(dev, vols32: dict, pose) -> dict:
    """The raycast's bf16 instance on the analytic 512^3 scene and on the
    volume the 20-frame bf16 fuse leaves, against its bf16 twin: hit masks
    equal, vertices bit-equal where hit; timed in turns with the float32
    instance on the float32 volumes; the bound with 2-byte voxels. Then
    the marching-cubes vertex count of the bf16 fuse beside the float32
    fuse's."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.kernels.raycast import KERNEL_BF16, raycast_vertices_cuda
    from tsdf_tpu_torch.ops.marching_cubes import extract_surface
    from tsdf_tpu_torch.ops.raycast import raycast_vertices

    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(pose)
    rows = {}
    for name, (v16, v32) in vols32.items():
        vk = raycast_vertices_cuda(v16, cam, W, H)
        vp = raycast_vertices(v16, cam, W, H)
        torch.cuda.synchronize()
        hk, hp = torch.isfinite(vk).all(-1), torch.isfinite(vp).all(-1)
        equal = torch.equal(hk, hp) and torch.equal(vk[hk].view(torch.int32),
                                                    vp[hp].view(torch.int32))
        err = float((vk[hk & hp] - vp[hk & hp]).abs().max())
        h32 = torch.isfinite(raycast_vertices_cuda(v32, cam, W, H)).all(-1)
        log(f"raycast bf16 512^3 {W}x{H}, {name} volume: hit masks equal and "
            f"vertices bit-equal with the bf16 twin: {equal} ({int(hk.sum())} "
            f"hits; the float32 volume's render {int(h32.sum())}, hit masks "
            f"agree on {float((hk == h32).float().mean()):.6f})")
        check(equal, f"raycast bf16 on the {name} volume differs from its twin")
        n_samples, n_voxels, _hit, n_uniform = raycast_work(v16, cam)
        ms, f32_ms, turns = in_turns(
            lambda: raycast_vertices_cuda(v16, cam, W, H),
            lambda: raycast_vertices_cuda(v32, cam, W, H), reps=10)
        parent = parent_in_turns(
            [KERNEL_BF16], lambda: raycast_vertices_cuda(v16, cam, W, H), 10,
            ms, f"raycast bf16 512^3, {name} volume")
        least = bound(2 * n_voxels + 12 * W * H,
                      RAYCAST_OPS["ray"] * W * H + RAYCAST_OPS["sample"] * n_samples)
        log(f"raycast bf16 512^3, {name} volume: kernel {ms:.4f} ms, float32 "
            f"instance {f32_ms:.4f} ms (in turns: "
            + ", ".join(f"{t:.4f}" for t in turns)
            + f"), bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']} ({n_samples} samples, {n_voxels} distinct "
            f"voxels of 2 B); {n_uniform / n_samples:.4f} of the samples in "
            "uniform bricks")
        rows[name] = dict(max_abs_err=err, ms=ms, **least,
                          library_ms=None, f32_ms=f32_ms, samples=n_samples,
                          parent_ms=parent)
    v16, v32 = vols32["fused"]
    counts = [int(extract_surface(v, max_cubes=MAX_CUBES,
                                  max_vertices=MAX_VERTICES).n_vertices)
              for v in (v16, v32)]
    log(f"marching cubes of the 20-frame fuse, 512^3: {counts[0]} vertices "
        f"from the bf16 volume, {counts[1]} from the float32 one")
    check(abs(counts[0] - counts[1]) <= BF16_MESH_REL * counts[1],
          "the bf16 mesh's vertex count is far from float32's")
    first, *others = rows
    return {**rows[first], **{k: rows[k] for k in others},
            "mesh_vertices_bf16": counts[0], "mesh_vertices_f32": counts[1]}


def bf16_warped(dev, sf_depth, sf_flows) -> dict:
    """The warped integrate's bf16 instances at 255^3 under the field two
    real deformation updates leave, cast to bf16: two frames, tsdf and
    weight (and colour bytes) bit-equal with the bf16 twin; timed in turns
    with the float32 instances. Then the SceneFusion loop with a bf16
    volume and its float32 field (the warped bf16 instance each frame),
    bit-equal with the same loop through the plain twins, beside the loop
    on float32; and colour frames into a deformed bf16 volume through
    ``fuse_frames``."""
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.integrate import integrate_warped_cuda
    from tsdf_tpu_torch.ops.integrate import integrate as integrate_plain
    from tsdf_tpu_torch.pipelines import scenefusion as sf
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames

    field, _, _ = sf_run(dev, sf_depth, sf_flows, n_frames=3)
    cam = sf_camera(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        (np.arange(W) * 255 // W).astype(np.uint8)[None, :, None], (H, W, 3))
    )).to(dev)
    results = {}
    def copy(vol, dtype, color):
        vol = vol.replace(tsdf=vol.tsdf.to(dtype, copy=True),
                          weight=vol.weight.to(dtype, copy=True))
        return vol.with_color() if color else vol

    for name, color in (("integrate_warped", False),
                        ("integrate_warped_color", True)):
        ref, out, v32 = (copy(field, d, color)
                         for d in (BF16, BF16, torch.float32))
        c = rgb if color else None
        for _ in range(2):
            before = ref
            ref = integrate_plain(ref, sf_depth, cam, rgb=c)
            out = integrate_warped_cuda(out, sf_depth, cam, rgb=c)
            v32 = integrate_warped_cuda(v32, sf_depth, cam, rgb=c)
        torch.cuda.synchronize()
        equal = (bits_equal(out.tsdf, ref.tsdf) and bits_equal(out.weight, ref.weight)
                 and (not color or torch.equal(out.color, ref.color)))
        err = float((out.tsdf.float() - ref.tsdf.float()).abs().max())
        updated = int((ref.weight > before.weight).sum())
        band = int((ref.color.to(torch.int32) > 0).any(-1).sum()) if color else 0
        log(f"{name} bf16 255^3 after two deformation updates, two frames: "
            f"bit-equal with the bf16 twin: {equal} ({updated} voxels updated)")
        check(equal, f"{name} bf16 differs from its twin")
        ms, f32_ms, turns = in_turns(
            lambda: integrate_warped_cuda(out, sf_depth, cam, rgb=c),
            lambda: integrate_warped_cuda(v32, sf_depth, cam, rgb=c), reps=20,
            inner=4)
        least = warped_bound(ref, int((ref.deform[..., 2] > 0).sum()),
                             updated, band, storage_bytes=2)
        log(f"{name} bf16 255^3 one frame: kernel {ms:.4f} ms, float32 instance "
            f"{f32_ms:.4f} ms (in turns: " + ", ".join(f"{t:.4f}" for t in turns)
            + f"), bound {least['bound_ms']:.4f} ms by "
            f"{least['bound_by']}")
        results[name + "_bf16"] = dict(max_abs_err=err, ms=ms,
                                       **least, library_ms=None, f32_ms=f32_ms)
        del ref, out, v32, before
    del field

    # the SceneFusion loop on a bf16 volume through the kernels and through
    # the plain twins (bit-equal), and the same loop on float32
    loops = {}
    for what, dtype, ctx in (("kernels", BF16, contextlib.nullcontext()),
                             ("twins", BF16, plain_twins()),
                             ("float32", torch.float32,
                              contextlib.nullcontext())):
        cfg = sf.SceneFusionConfig()
        vol = cfg.make_volume(device=dev).astype(dtype)
        reset_launch_counts()
        with ctx:
            vol = sf.integrate_warped_cuda(vol, sf_depth, cam)
            for flow in sf_flows:
                vol, _n, _over = sf.scenefusion_step(
                    vol, sf_depth, flow, cam, max_cubes=cfg.max_cubes,
                    threshold_mm=cfg.threshold_mm)
        torch.cuda.synchronize()
        loops[what] = (vol, launch_counts())
    (v16, counts), (t16, _), (v32, _) = (loops[k] for k in
                                         ("kernels", "twins", "float32"))
    log(f"SceneFusion loop, bf16 volume, {SF_FRAMES} frames: launches {counts}")
    check_counts(counts, "SceneFusion bf16", at_least=dict(lane_gather=1),
                 integrate_warped_bf16=SF_FRAMES, row_gather=SF_FRAMES - 1)
    equal = (bits_equal(v16.tsdf, t16.tsdf) and bits_equal(v16.weight, t16.weight)
             and bits_equal(v16.deform, t16.deform))
    # the bf16 surface lies within bf16 rounding of the float32 one, so
    # voxels at the edge of the shell that brackets it can bracket a vertex
    # in one run and not in the other: such a voxel takes a whole flow step
    # more or less, and no voxel more than the flow fed
    moved = int(((v32.deform - v32.voxel_centres()).abs().amax(-1) > 1e-3).sum())
    gap = (v16.deform - v32.deform).abs().amax(-1)
    differ = int((gap > 1e-3).sum())
    same_w = float((v16.weight.float() == v32.weight).float().mean())
    log(f"SceneFusion bf16: tsdf, weight and field bit-equal with the loop "
        f"through the plain twins: {equal}; against float32 the field differs "
        f"by more than 1e-3 mm at {differ} of the {moved} voxels it moved (max "
        f"{float(gap.max()):.4g} mm; {SF_TOTAL_FLOW_MM} mm of flow fed), "
        f"weights equal on {same_w:.6f} of the voxels")
    check(equal, "SceneFusion bf16 differs from its run through the twins")
    check(v16.tsdf.dtype == BF16 and v16.deform.dtype == torch.float32,
          "SceneFusion bf16: the dtypes changed")
    check(moved > 1000 and same_w >= 0.999
          and float(gap.max()) <= SF_TOTAL_FLOW_MM,
          "SceneFusion on bf16 is far from the float32 loop")
    del loops, v16, t16, v32, gap

    # colour frames into a deformed bf16 volume
    vol = sf.SceneFusionConfig().make_volume(device=dev).astype(BF16).with_color()
    white = torch.full((H, W, 3), 200, dtype=torch.uint8, device=dev)
    reset_launch_counts()
    vol, _ = fuse_frames(vol, cam, [(sf_depth, cam.pose, white)] * 3,
                         FusionConfig(width=W, height=H))
    torch.cuda.synchronize()
    wc = launch_counts()
    check_counts(wc, "deformed colour fuse bf16", integrate_warped_color_bf16=3)
    check(float(vol.weight.max()) == 3.0, "deformed colour fuse bf16 weights")
    results["counts"] = {"integrate_warped_bf16": counts["integrate_warped_bf16"],
                         "integrate_warped_color_bf16":
                             wc["integrate_warped_color_bf16"]}
    return results


def bf16_adjoint(dev, frames) -> dict:
    """The pose adjoint's bf16 instance at 512^3 (the second frame over a
    bf16 volume the first fused, bf16 cotangents): dd and dw bit-equal with
    the bf16 twin, dpinv within POSE_GRAD_DPINV_RTOL, a second launch
    bit-equal; timed in turns with the float32 instance; the bound with
    2-byte cotangents and storage. Then one config4b value-and-grad step on
    a bf16 volume through ``fusion_loss_and_grad``, counted, its gradient
    against the float32 step's."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import integrate as kint
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.integrate import integrate_cuda, pose_grad_cuda
    from tsdf_tpu_torch.ops.integrate_diff import integrate_pose_grad, sample_frame
    from tsdf_tpu_torch.pipelines.pose_recovery import fusion_loss_and_grad
    from tsdf_tpu_torch.utils import fixtures

    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(p)
            for _, p in frames]
    v32 = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    integrate_cuda(v32, frames[0][0], cams[0])
    v16 = v32.astype(BF16)
    depth, cam = frames[1][0], cams[1]
    gen = torch.Generator(device=dev).manual_seed(5)
    g32 = [torch.randn(v32.tsdf.shape, generator=gen, device=dev) for _ in range(2)]
    g16 = [g.to(BF16) for g in g32]
    dd, dw, dp = pose_grad_cuda(v16, depth, cam, *g16)
    dd2, dw2, dp2 = pose_grad_cuda(v16, depth, cam, *g16)
    rd, rw, rp = integrate_pose_grad(v16, depth, cam, *g16)
    torch.cuda.synchronize()
    err = float((dp - rp).abs().max())
    scale = float(rp.abs().max())
    equal = bits_equal(dd, rd) and bits_equal(dw, rw)
    again = bits_equal(dd, dd2) and bits_equal(dw, dw2) and bits_equal(dp, dp2)
    log(f"pose adjoint bf16 512^3: dd and dw bit-equal with the bf16 twin: "
        f"{equal}; dpinv max |diff| {err:.4g} (largest entry {scale:.6g}); a "
        f"second launch bit-equal: {again}")
    check(equal and again and err <= POSE_GRAD_DPINV_RTOL * scale and scale > 0,
          "the bf16 pose adjoint differs from its twin")
    del dd2, dw2, rd, rw
    *_, sdf, updated = sample_frame(depth, v16, cam)
    n_upd = int(updated.sum())
    in_band = int((updated & (sdf < v16.truncation_distance)).sum())
    del sdf, updated
    ms, f32_ms, turns = in_turns(lambda: pose_grad_cuda(v16, depth, cam, *g16),
                                 lambda: pose_grad_cuda(v32, depth, cam, *g32),
                                 reps=20)
    o = POSE_GRAD_OPS
    n = v16.tsdf.numel()
    least = bound(8 * n + 4 * n_upd + 3 * 4 * depth.numel(),
                  o["voxel"] * n + o["in_front"] * voxels_in_front(v16, cam)
                  + o["updated"] * n_upd + o["band"] * in_band)
    log(f"pose adjoint bf16 512^3 one frame: kernel {ms:.4f} ms, float32 "
        f"instance {f32_ms:.4f} ms (in turns: "
        + ", ".join(f"{t:.4f}" for t in turns)
        + f"), bound {least['bound_ms']:.4f} ms by "
        f"{least['bound_by']} (2 B cotangents and storage); registers "
        f"{kernel_registers(['pose_grad_walk_kernelI13__nv_bfloat16Lb0EE'])}")
    result = dict(max_abs_err=err, ms=ms, **least,
                  library_ms=None, f32_ms=f32_ms,
                  slab=slab_adjoint(v16, depth, cam, *g16))
    del v16, v32, g16, g32, dd, dw
    torch.cuda.empty_cache()

    # one config4b value-and-grad step on a bf16 volume (tools/run_config4b.py)
    vol = make_volume((SIZE,) * 3, PHYSICAL, offset=POSE_OFFSET, device=dev)
    cam = default_camera(dev, *C4B_CAMERA)
    depth = fixtures.sphere_depth_map(W, H, 150.0, 1000.0, 2500.0)
    depth = torch.from_numpy(depth.astype(np.float32)).to(dev)
    zero = torch.zeros(6, device=dev)
    delta0 = torch.tensor(C4B_DELTA0, dtype=torch.float32, device=dev)
    grads = {}
    for dtype in (BF16, torch.float32):
        v = vol.astype(dtype)
        with torch.no_grad():
            target, _ = kint.integrate_pose(v, depth, cam, zero)
        reset_launch_counts()
        loss, g = fusion_loss_and_grad(v, depth, cam, target, delta0)
        torch.cuda.synchronize()
        counts = launch_counts()
        grads[dtype] = (float(loss), g)
        if dtype == BF16:
            log(f"config4b step, bf16 volume: launches {counts}")
            check_counts(counts, "config4b bf16", integrate_bf16=1,
                         integrate_pose_grad_bf16=1)
            result["launches"] = counts["integrate_pose_grad_bf16"]
            step_ms = median_ms(
                lambda: fusion_loss_and_grad(v, depth, cam, target, delta0), reps=5)
    (l16, g16), (l32, g32) = grads[BF16], grads[torch.float32]
    cos = float((g16 @ g32) / (g16.norm() * g32.norm()))
    log(f"config4b step 512^3: bf16 loss {l16:.6f}, gradient "
        f"{g16.cpu().numpy().tolist()}; float32 loss {l32:.6f}, gradient "
        f"{g32.cpu().numpy().tolist()}; cosine {cos:.6f}; {step_ms:.4f} ms a "
        "bf16 value-and-grad step by CUDA events")
    check(bool(torch.isfinite(g16).all()) and cos > 0.99,
          "config4b on bf16: the gradient is far from float32's")
    result.update(config4b_step_ms=step_ms, config4b_cosine=cos)
    return result


def phase_bf16(dev, frames, rgbs, gt_poses, sf_depth, sf_flows) -> dict:
    """bfloat16 volume storage (``TSDFVolume.astype``) through every kernel
    that reads the volume, its paths and its twins (see each part)."""
    results = bf16_integrates(dev, frames[:2], rgbs[:2])
    paths = bf16_fuse_paths(dev, frames, rgbs, gt_poses)
    fused = paths.pop("fused")
    scene32 = analytic_volume(dev)
    results["raycast_bf16"] = bf16_raycast_and_mesh(
        dev, {"analytic": (scene32.astype(BF16), scene32),
              "fused": (fused[BF16], fused[torch.float32])}, frames[0][1])
    del scene32, fused
    torch.cuda.empty_cache()
    warped = bf16_warped(dev, sf_depth, sf_flows)
    torch.cuda.empty_cache()
    results["integrate_pose_grad_bf16"] = bf16_adjoint(dev, frames)
    counts = {**paths["counts"], **warped.pop("counts")}
    results.update(warped)
    for name, n in counts.items():
        results[name]["launches"] = n
    results["paths"] = paths
    return results


# -- config 3 (--config3): the 500-pose tracked orbit at 256^3 -----------------


# -- the sharded phase: the mesh path (parallel/) ---------------------------

# the mesh shapes of the four ranks that share the one card, in one spawn
SHARDED_MESHES = ((4, 1), (2, 2))
# the tracked loop on the mesh against the single-card loop, per pose (the
# JAX package's gates, tests/test_parallel_icp.py)
SHARDED_POSE_MM, SHARDED_POSE_ROT = 2.0, 3e-3
# the bricked raycast against the single-card render (tests/test_parallel.py)
BRICKED_HIT_AGREE, BRICKED_MEDIAN_MM, BRICKED_P99_MM = 0.999, 0.5, 2.0


def digests(outs: dict) -> dict:
    """The sha256 of each output file of a ``fuse`` run."""
    import hashlib

    found = {}
    for k, path in outs.items():
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
        found[k] = h.hexdigest()
    return found


def vertices_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Hit masks equal and vertices equal bit for bit where hit."""
    ha, hb = torch.isfinite(a).all(-1), torch.isfinite(b).all(-1)
    return bool(torch.equal(ha, hb)) and torch.equal(
        a[ha].view(torch.int32), b[hb].view(torch.int32))


def bricked_agreement(verts: torch.Tensor, ref: torch.Tensor) -> dict:
    """Hit agreement and the vertex distances where both hit."""
    hv, hr = torch.isfinite(verts).all(-1), torch.isfinite(ref).all(-1)
    both = hv & hr
    d = (verts[both] - ref[both]).norm(dim=-1).double()
    return dict(hit_agree=float((hv == hr).double().mean()),
                hits=int(hr.sum()), median_mm=float(d.median()),
                p99_mm=float(d.quantile(0.99)))


def pose_gaps(poses, refs) -> tuple[float, float]:
    """The largest translation (mm) and rotation-entry gap over the poses."""
    poses, refs = np.asarray(poses), np.asarray(refs)
    return (float(np.abs(poses[:, :3, 3] - refs[:, :3, 3]).max()),
            float(np.abs(poses[:, :3, :3] - refs[:, :3, :3]).max()))


# frames of the runs that count host syncs and collectives (the first is
# fused untracked, the rest tracked)
SYNC_FRAMES = 5
# SceneFusion on the mesh: the reference's 10 mm voxels in a volume whose
# z extent divides both meshes' "b" axes (255 divides neither 4 nor 2)
SF_MESH_SIZE = 256
SF_MESH_PHYSICAL = 2560.0
SF_MESH_OFFSET = (-1280.0, -1280.0, 0.0)
# the sharded frame against the single card's (tests/test_parallel_extra.py:146)
SF_MESH_DEFORM_MM, SF_MESH_TSDF_MM = 1e-4, 1e-3
# the sharded pose gradient against the single card's, relative to its norm
SHARDED_GRAD_REL = 1e-6


def syncs_and_collectives(fn) -> tuple[int, int]:
    """The host syncs (torch's sync debug mode) and the mesh collectives
    (calls of ``mesh.py``'s collectives from the ops) of one call of
    ``fn``."""
    import warnings

    from tsdf_tpu_torch.parallel import halo as phalo
    from tsdf_tpu_torch.parallel import ops as pops

    calls, syncs, saved = [0], [0], []
    for mod in (pops, phalo):
        for name in ("all_gather", "all_reduce", "gather"):
            if hasattr(mod, name):
                inner = getattr(mod, name)
                saved.append((mod, name, inner))

                def counted(*args, _inner=inner, **kwargs):
                    calls[0] += 1
                    return _inner(*args, **kwargs)

                setattr(mod, name, counted)

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message) and "prototype" not in str(message):
            syncs[0] += 1

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return syncs[0], calls[0]


def sharded_loop_syncs(dev, mesh, depths, cams) -> dict:
    """Host syncs and collectives of ``SYNC_FRAMES`` frames of the GT-pose
    sharded fuse and of the tracked loop on ``mesh`` (every rank runs it;
    each counts its own)."""
    from tsdf_tpu_torch.parallel import track_and_fuse_frames_sharded
    from tsdf_tpu_torch.parallel.ops import integrate_sharded, make_sharded_volume

    n = SYNC_FRAMES
    vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
    torch.cuda.synchronize()
    fuse = syncs_and_collectives(
        lambda: [integrate_sharded(vol, depths[i], cams[i], mesh)
                 for i in range(n)])
    vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
    torch.cuda.synchronize()
    tracked = syncs_and_collectives(lambda: track_and_fuse_frames_sharded(
        vol, cams[0], depths[:n], mesh, use_bilateral_filter=True, band=32,
        width=W, height=H))
    torch.cuda.synchronize()
    return {"fuse_syncs": fuse[0] / n, "fuse_collectives": fuse[1] / n,
            "tracked_syncs": tracked[0] / (n - 1),
            "tracked_collectives": tracked[1] / (n - 1)}


def nccl_syncs_rank(dev, depths_np, poses_np):
    """One rank, NCCL: the host syncs and collectives of the mesh loops."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, device=dev)
    depths = [torch.from_numpy(d).to(dev) for d in depths_np]
    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(
        torch.from_numpy(p).to(dev)) for p in poses_np]
    return sharded_loop_syncs(dev, mesh, depths, cams)


def sharded_surface(mesh, slab, single) -> dict:
    """The sharded surface of the fused slabs (dense layout, the smoke's
    caps a brick), merged on every rank; the first rank holds it to the
    single-card soup ``single`` (its vertices, in order): the same count,
    the vertices bit-equal in order and as a sorted multiset."""
    import torch.distributed as dist

    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.parallel import extract_surface_sharded, merge_brick_soups

    dist.barrier()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    bricks = extract_surface_sharded(slab, mesh, max_cubes_per_brick=MAX_CUBES,
                                     max_vertices_per_brick=MAX_VERTICES)
    overflowed = bricks[3].tolist()
    verts, _ = merge_brick_soups(bricks)
    seconds = time.perf_counter() - t0
    out = dict(seconds=seconds, vertices=len(verts), overflowed=overflowed,
               counts=launch_counts(), per_brick=bricks[2].tolist())
    del bricks
    torch.cuda.empty_cache()
    if single is not None:
        def multiset(v):
            """The vertices' bit patterns, sorted by x, then y, then z."""
            bits = np.ascontiguousarray(v).view(np.int32)
            return bits[np.lexsort(bits.T[::-1])].tobytes()

        out["single_vertices"] = len(single)
        out["in_order"] = verts.tobytes() == single.tobytes()
        # equal in order, the sorted multisets are equal too
        out["multiset"] = out["in_order"] or multiset(verts) == multiset(single)
    return out


def sharded_sfusion(dev, mesh, sf_depth_np, single: bool) -> dict:
    """Six ``scenefusion_frame_sharded`` frames at 256^3 over 2560 mm (the
    SceneFusion sequence: one depth frame, uniform +x flows of whole
    millimetres), twice. After every frame of the first run the slabs are
    gathered, and with ``single`` (the mesh's first rank) held to six
    ``scenefusion_step``s of one volume: n_corr equal, deform within
    SF_MESH_DEFORM_MM, tsdf within SF_MESH_TSDF_MM, weights equal (and
    whether each is bit-equal). The second run must equal the first on
    every rank bit for bit; it is timed, with the launches of its six
    frames, and one ``update_deformation_sharded`` of its final state."""
    import torch.distributed as dist

    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.parallel import (
        scenefusion_frame_sharded,
        update_deformation_sharded,
    )
    from tsdf_tpu_torch.parallel.ops import make_sharded_volume, unshard_volume
    from tsdf_tpu_torch.pipelines.scenefusion import scenefusion_step

    depth = torch.from_numpy(sf_depth_np).to(dev)
    flows = []
    for mm in SF_FLOW_MM:
        f = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
        f[..., 0] = mm
        flows.append(f)
    cam = sf_camera(dev)
    geometry = dict(offset=SF_MESH_OFFSET, with_deformation=True)

    def fresh():
        vol = make_sharded_volume(mesh, (SF_MESH_SIZE,) * 3, SF_MESH_PHYSICAL,
                                  **geometry)
        return vol.replace(deform_rot=None)  # file-format state only

    ref = None
    if single:
        ref = make_volume((SF_MESH_SIZE,) * 3, SF_MESH_PHYSICAL, device=dev,
                          **geometry).replace(deform_rot=None)
    vol = fresh()
    frames = []
    for flow in flows:
        vol, n_corr = scenefusion_frame_sharded(
            vol, depth, cam, flow, mesh, max_cubes_per_brick=SF_MAX_CUBES)
        whole = unshard_volume(vol, mesh)
        if ref is None:
            continue
        ref, n_ref, _ = scenefusion_step(ref, depth, flow, cam,
                                         max_cubes=SF_MAX_CUBES)
        frames.append(dict(
            n_corr=int(n_corr), n_single=int(n_ref),
            deform_mm=float((whole.deform - ref.deform).abs().max()),
            tsdf_mm=float((whole.tsdf - ref.tsdf).abs().max()),
            weights_equal=torch.equal(whole.weight, ref.weight),
            bit_equal=all(bits_equal(getattr(whole, f), getattr(ref, f))
                          for f in ("tsdf", "weight", "deform"))))
        del whole
    del ref
    first = vol
    vol = fresh()
    dist.barrier()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for flow in flows:
        vol, _ = scenefusion_frame_sharded(
            vol, depth, cam, flow, mesh, max_cubes_per_brick=SF_MAX_CUBES)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(flows)
    counts = launch_counts()
    again = all(bits_equal(getattr(vol, f), getattr(first, f))
                for f in ("tsdf", "weight", "deform"))
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    update_deformation_sharded(vol, depth, cam, flows[-1], mesh,
                               max_cubes_per_brick=SF_MAX_CUBES)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    del vol, first
    torch.cuda.empty_cache()
    return dict(frames=frames, ms_per_frame=ms, update_ms=update_ms,
                again=again, counts=counts)


def slabs_equal(a, b) -> bool:
    """Every field of two volumes or slabs bit for bit (NaN included; None
    where None; a slab's plane numbers equal)."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, torch.Tensor) or not isinstance(y, torch.Tensor):
            if not (x is y or x == y):
                return False
        elif x.dtype == torch.uint8 or x.dtype != y.dtype:
            if not torch.equal(x, y):
                return False
        elif x.shape != y.shape or not bits_equal(x, y):
            return False
    return True


def sharded_sfusion_class(dev, mesh, sf_dirs, sf_depth_np, first: bool,
                          tmp: str) -> dict:
    """``SceneFusion(mesh=)`` at 256^3 over 2560 mm on phase 9's RGB-D +
    PD-Flow files, each rank reading them through its own ``MockKinect``
    and provider; every rank steps the single-card class on the same frames
    beside it and, after every frame, holds its slab to the same planes of
    that volume: n_corr equal, deform and tsdf within SF_MESH_DEFORM_MM /
    SF_MESH_TSDF_MM, weights equal (and whether bit-equal). A rank compares
    its own planes, so no frame gathers the slabs through the host. Then
    ``extract_mesh``'s PLY and one ``dump`` (every rank calls both; the
    first rank writes) byte-equal with the single card's; then the class
    again on the same frames already on the card, timed, its launches
    counted, its slab bit-equal with the run on files."""
    import gc
    import shutil

    import torch.distributed as dist

    from tsdf_tpu_torch.io.mock_kinect import MockKinect
    from tsdf_tpu_torch.io.ply import write_ply
    from tsdf_tpu_torch.io.sceneflow import PDSFMockSceneFlow
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.ops.marching_cubes import soup_to_numpy
    from tsdf_tpu_torch.pipelines.scenefusion import SceneFusion, SceneFusionConfig

    rgbd_dir, flow_dir = sf_dirs
    cfg = SceneFusionConfig(volume_size=(SF_MESH_SIZE,) * 3,
                            physical_size_mm=SF_MESH_PHYSICAL,
                            offset_mm=SF_MESH_OFFSET, max_cubes=SF_MAX_CUBES)
    cam = sf_camera(dev)

    def provider():
        sfa = PDSFMockSceneFlow(flow_dir)
        check(sfa.init(), "no scene-flow files")
        return sfa

    kinect = MockKinect(rgbd_dir)
    kinect.initialise()
    fusion = SceneFusion(provider(), kinect, cfg, camera=cam, mesh=mesh)
    ref = SceneFusion(provider(), CardFrames(None, []), cfg, camera=cam,
                      device=dev)
    z0, planes = fusion.volume.z0, fusion.volume.tsdf.shape[0]
    frames = []

    def step(depth, colour):
        fusion.process_frames(depth, colour)
        ref.process_frames(depth, colour)
        mine, theirs = fusion.correspondence_counts, ref.correspondence_counts
        slab = fusion.volume
        want = {f: getattr(ref.volume, f)[z0:z0 + planes]
                for f in ("tsdf", "weight", "deform")}
        frames.append(dict(
            n_corr=int(mine[-1]) if mine else 0,
            n_single=int(theirs[-1]) if theirs else 0,
            deform_mm=float((slab.deform - want["deform"]).abs().max()),
            tsdf_mm=float((slab.tsdf - want["tsdf"]).abs().max()),
            weights_equal=torch.equal(slab.weight, want["weight"]),
            bit_equal=all(bits_equal(getattr(slab, f), want[f].contiguous())
                          for f in want)))

    kinect.add_observer(step)  # the one observer, in the class's place
    kinect.start()
    out = dict(frames=frames)
    shape = f"{mesh.shape['b']}x{mesh.shape['r']}"
    soup = fusion.extract_mesh()
    dumps = os.path.join(tmp, f"class_{shape}")
    fusion.dump_dir = os.path.join(dumps, "mesh")
    fusion.dump(SF_FRAMES - 1)
    check((soup is None) == (not first), "extract_mesh: a soup off the first rank")
    if first:
        ref.dump_dir = os.path.join(dumps, "single")
        ref.dump(SF_FRAMES - 1)
        plys = []
        for name, s in (("mesh", soup), ("single", ref.extract_mesh())):
            path = os.path.join(dumps, f"{name}.ply")
            write_ply(path, *soup_to_numpy(s))
            plys.append(digests({"ply": path})["ply"])
        out["vertices"] = len(soup_to_numpy(soup)[0])
        out["ply_equal"] = plys[0] == plys[1]
        names = sorted(os.listdir(fusion.dump_dir))
        out["dump_files"] = names
        out["dump_equal"] = len(names) == 3 and names == sorted(
            os.listdir(ref.dump_dir)) and all(
            digests({"f": os.path.join(fusion.dump_dir, n)})
            == digests({"f": os.path.join(ref.dump_dir, n)}) for n in names)
        shutil.rmtree(dumps)
    del ref, soup
    gc.collect()  # a class and its source refer to each other
    torch.cuda.empty_cache()

    # the class timed on the same frames already on the card
    depth = torch.from_numpy(sf_depth_np).to(dev)
    flows = []
    for mm in SF_FLOW_MM[:SF_FRAMES - 1]:
        f = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
        f[..., 0] = mm
        flows.append(f)
    src = CardFrames(depth, flows)
    timed = SceneFusion(src, src, cfg, camera=cam, mesh=mesh)
    dist.barrier()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    src.start()
    torch.cuda.synchronize()
    out["ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / SF_FRAMES
    out["counts"] = launch_counts()
    out["card_equal"] = slabs_equal(timed.volume, fusion.volume)
    del timed, fusion, kinect, src
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rich_slab(mesh):
    """This rank's slab of a bf16 512^3 volume with colour and deformation,
    its content a closed form of the voxel's global index, so that any mesh
    makes the planes it expects of a checkpoint."""
    from tsdf_tpu_torch.parallel.ops import make_sharded_volume

    vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL, dtype=BF16,
                              with_color=True, with_deformation=True)
    vol = vol.replace(deform_rot=None)  # file-format state only
    dev = vol.device
    z = torch.arange(vol.z0, vol.z0 + vol.tsdf.shape[0], device=dev,
                     dtype=torch.float32).view(-1, 1, 1)
    yx = torch.arange(SIZE, device=dev, dtype=torch.float32)
    y, x = yx.view(1, -1, 1), yx.view(1, 1, -1)
    vol.tsdf.copy_(torch.sin(0.37 * z + 0.11 * y + 0.05 * x))
    vol.weight.copy_(torch.remainder(z + y + x, 16.0))
    vol.color.copy_(torch.remainder(3 * z + 5 * y + 7 * x, 256.0)
                    .to(torch.uint8).unsqueeze(-1).expand_as(vol.color))
    vol.deform.add_(torch.stack(torch.broadcast_tensors(
        0.25 * x, -0.5 * y, z / 8.0), dim=-1))
    return vol


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def timed_on_mesh(fn):
    """(result, seconds) of ``fn()``, started together on every rank and
    ended with the card's work."""
    import torch.distributed as dist

    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def sharded_checkpoint_save(dev, mesh, slab32, depths, cams, root: str,
                            first: bool) -> dict:
    """On the first mesh: ``save_sharded`` of the fused float32 slabs and
    of a bf16 slab with deformation and colour (``rich_slab``) into
    ``root``, for the second mesh to restore; and a resume at 512^3: 2
    frames, save, load, 2 more, gathered and held on the first rank to 4
    frames fused straight on one card (bit-equal). Each rank's save and
    load seconds; the bytes on disk."""
    import shutil

    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.kernels.integrate import integrate_cuda
    from tsdf_tpu_torch.parallel.ops import (
        integrate_sharded,
        make_sharded_volume,
        unshard_volume,
    )
    from tsdf_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    out = {}
    _, out["save_f32_s"] = timed_on_mesh(lambda: save_sharded(
        slab32, os.path.join(root, "f32"), mesh=mesh))
    rich = rich_slab(mesh)
    _, out["save_rich_s"] = timed_on_mesh(lambda: save_sharded(
        rich, os.path.join(root, "rich"), mesh=mesh))
    del rich
    vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
    for i in range(2):
        integrate_sharded(vol, depths[i], cams[i], mesh)
    path = os.path.join(root, "resume")
    _, out["save_resume_s"] = timed_on_mesh(
        lambda: save_sharded(vol, path, mesh=mesh))
    del vol
    like = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
    vol, out["load_resume_s"] = timed_on_mesh(
        lambda: load_sharded(path, like, mesh=mesh))
    del like
    for i in range(2, 4):
        integrate_sharded(vol, depths[i], cams[i], mesh)
    whole = unshard_volume(vol, mesh)
    del vol
    if first:
        out["bytes"] = {k: dir_bytes(os.path.join(root, k))
                        for k in ("f32", "rich", "resume")}
        straight = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
        for i in range(4):
            integrate_cuda(straight, depths[i], cams[i])
        out["resume_equal"] = slabs_equal(whole, straight)
        del straight
        shutil.rmtree(path)
    del whole
    torch.cuda.empty_cache()
    return out


def sharded_checkpoint_load(dev, mesh, slab32, root: str, first: bool) -> dict:
    """On the second mesh: the first mesh's checkpoints restored onto this
    mesh's slabs, each rank's held bit for bit to its own slab of the same
    volume (the float32 fusion this mesh made, which the fuse step holds
    to the single volume; ``rich_slab``); each rank's load seconds."""
    import shutil

    from tsdf_tpu_torch.parallel.ops import make_sharded_volume
    from tsdf_tpu_torch.utils.checkpoint import load_sharded

    out = {}
    like = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
    got, out["load_f32_s"] = timed_on_mesh(lambda: load_sharded(
        os.path.join(root, "f32"), like, mesh=mesh))
    out["f32_equal"] = slabs_equal(got, slab32)
    del like, got
    want = rich_slab(mesh)
    like = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL, dtype=BF16,
                               with_color=True, with_deformation=True
                               ).replace(deform_rot=None)
    got, out["load_rich_s"] = timed_on_mesh(lambda: load_sharded(
        os.path.join(root, "rich"), like, mesh=mesh))
    out["rich_equal"] = slabs_equal(got, want)
    del like, got, want
    torch.cuda.empty_cache()
    timed_on_mesh(lambda: None)  # every rank has read before the files go
    if first:
        for k in ("f32", "rich"):
            shutil.rmtree(os.path.join(root, k))
    return out


def sharded_pose(dev, mesh, dtype, single: bool) -> dict:
    """One ``integrate_pose_sharded`` value-and-grad at 512^3 on config4b's
    frame and pose (``C4B_DELTA0``), into the slabs that frame fused at
    the identity, with a seeded cotangent (each rank's loss its slab's
    share); then the slab adjoint alone at the step's pose. The fused slabs
    and the adjoint's dd and dw are gathered, and with ``single`` (the
    mesh's first rank) held to ``integrate_pose`` and ``pose_grad_cuda`` on
    the whole volume: bit for bit, and the gradient within
    SHARDED_GRAD_REL of the single card's, relative to its norm."""
    import torch.distributed as dist

    from tsdf_tpu_torch import make_volume
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.integrate import (
        integrate_cuda,
        integrate_pose,
        pose_grad_cuda,
    )
    from tsdf_tpu_torch.parallel import integrate_pose_sharded
    from tsdf_tpu_torch.parallel.mesh import gather
    from tsdf_tpu_torch.parallel.ops import (
        integrate_sharded,
        make_sharded_volume,
        unshard_volume,
    )
    from tsdf_tpu_torch.utils.se3 import matmul_small, se3_exp

    cam = default_camera(dev, *C4B_CAMERA)
    depth = torch.from_numpy(c4b_depth()).to(dev)
    delta0 = torch.tensor(C4B_DELTA0, dtype=torch.float32, device=dev)
    slab = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL, offset=POSE_OFFSET)
    integrate_sharded(slab, depth, cam, mesh, mode="exact")
    slab = slab.astype(dtype)
    planes = slice(slab.z0, slab.z0 + slab.tsdf.shape[0])
    gen = torch.Generator(device=dev).manual_seed(9)
    gd, gw = (torch.randn((SIZE,) * 3, generator=gen, device=dev)[planes]
              .to(dtype).contiguous() for _ in range(2))
    dist.barrier()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    delta = delta0.clone().requires_grad_(True)
    fused, miss = integrate_pose_sharded(slab, depth, cam, delta, mesh)
    (gd.float() * fused.tsdf.float()).sum().backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    grad = delta.grad.clone()
    at = cam.set_pose(matmul_small(se3_exp(delta0), cam.pose))
    dd, dw, _ = pose_grad_cuda(slab, depth, at, gd, gw)
    fused = fused.replace(tsdf=fused.tsdf.detach(), weight=fused.weight.detach())
    whole = unshard_volume(fused, mesh)
    b_group = mesh.get_group("b")
    dds = gather(dd, mesh.ranks[0], b_group) if mesh.get_coordinate()[1] == 0 else None
    dws = gather(dw, mesh.ranks[0], b_group) if mesh.get_coordinate()[1] == 0 else None
    out = dict(seconds=seconds, counts=counts, miss=int(miss),
               grad=grad.cpu().numpy().tolist())
    del fused, dd, dw, slab
    torch.cuda.empty_cache()
    if single:
        vol = make_volume((SIZE,) * 3, PHYSICAL, offset=POSE_OFFSET, device=dev)
        integrate_cuda(vol, depth, cam)
        vol = vol.astype(dtype)
        gen = torch.Generator(device=dev).manual_seed(9)
        wgd, wgw = (torch.randn((SIZE,) * 3, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
        d1 = delta0.clone().requires_grad_(True)
        ref, _ = integrate_pose(vol, depth, cam, d1)
        (wgd.float() * ref.tsdf.float()).sum().backward()
        rd, rw, _ = pose_grad_cuda(vol, depth, at, wgd, wgw)
        torch.cuda.synchronize()
        g1 = d1.grad
        out.update(
            fused_equal=bits_equal(whole.tsdf, ref.tsdf.detach())
            and bits_equal(whole.weight, ref.weight.detach()),
            adjoint_equal=bits_equal(torch.cat(dds), rd)
            and bits_equal(torch.cat(dws), rw),
            grad_rel=float((grad - g1).norm() / g1.norm()),
            single_grad=g1.cpu().numpy().tolist())
        del vol, ref, rd, rw, wgd, wgw
    del whole, dds, dws
    torch.cuda.empty_cache()
    return out


def sharded_rank(dev, depths_np, poses_np, rgbs_np, sf_depth_np, sf_dirs,
                 root):
    """One of four ranks that share the card (gloo, CUDA tensors staged
    through the host), on each mesh of ``SHARDED_MESHES``: the GT-pose fuse
    of the frames (float32; bf16 and colour on the first mesh), the
    replicated and the bricked raycast from the first pose, the surface of
    the fused float32 slabs, the sharded checkpoint at 512^3 (saved on the
    first mesh, with a resume; restored on the second), the tracked loop,
    six SceneFusion frames at 256^3 (``sharded_sfusion``) and the
    ``SceneFusion(mesh=)`` class on phase 9's files
    (``sharded_sfusion_class``), the pose gradient at 512^3 (float32; bf16
    too on the first mesh, ``sharded_pose``). The mesh's first rank also
    runs the single-card references and holds the results to them; every
    rank returns its times, its peaks, its launch counts and the seconds
    of each step. ``root`` is a directory every rank sees."""
    import torch.distributed as dist

    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tsdf_tpu_torch.kernels.integrate import integrate_color_cuda, integrate_cuda
    from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
    from tsdf_tpu_torch.parallel import (
        make_mesh,
        raycast_sharded,
        raycast_sharded_bricked,
        track_and_fuse_frames_sharded,
    )
    from tsdf_tpu_torch.parallel.ops import (
        integrate_sharded,
        make_sharded_volume,
        unshard_volume,
    )
    from tsdf_tpu_torch.ops.marching_cubes import extract_surface, soup_to_numpy
    from tsdf_tpu_torch.pipelines.kinfu import track_and_fuse_frames
    from tsdf_tpu_torch.utils.trajectory import ate

    entered = time.time()  # the rank's group is up: its start ends here
    torch.backends.cuda.matmul.allow_tf32 = False
    depths = [torch.from_numpy(d).to(dev) for d in depths_np]
    cams = [Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(
        torch.from_numpy(p).to(dev)) for p in poses_np]
    rgbs = [torch.from_numpy(c).to(dev) for c in rgbs_np]
    # the kernels' first launches in this process, outside every timing
    integrate_cuda(make_volume((32,) * 3, PHYSICAL, device=dev), depths[0],
                   cams[0])
    torch.cuda.synchronize()
    first_pose_render = None
    single_poses = None
    single_soup = None
    results = {}
    for nb, nr in SHARDED_MESHES:
        mesh = make_mesh(nb, nr, device=dev)
        first = dist.get_rank() == mesh.ranks[0]
        out = {"fuse_ms": {}, "equal": {}, "counts": {}, "seconds": {}}
        clock = [time.perf_counter()]

        def lap(name):
            now = time.perf_counter()
            out["seconds"][name] = now - clock[0]
            clock[0] = now

        def fuse(dtype, color):
            vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL, dtype=dtype,
                                      with_color=color)
            dist.barrier()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            for i in range(len(depths)):
                integrate_sharded(vol, depths[i], cams[i], mesh,
                                  rgb=rgbs[i] if color else None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(depths)
            return vol, ms, launch_counts()

        def single(dtype, color):
            vol = make_volume((SIZE,) * 3, PHYSICAL, dtype=dtype,
                              with_color=color, device=dev)
            for i in range(len(depths)):
                if color:
                    integrate_color_cuda(vol, depths[i], rgbs[i], cams[i])
                else:
                    integrate_cuda(vol, depths[i], cams[i])
            return vol

        kinds = [("float32", torch.float32, False)]
        if (nb, nr) == SHARDED_MESHES[0]:
            kinds += [("bfloat16", BF16, False), ("color", torch.float32, True)]
        slab32 = None
        for name, dtype, color in kinds:
            torch.cuda.reset_peak_memory_stats(dev)
            vol, ms, counts = fuse(dtype, color)
            out["fuse_ms"][name] = ms
            out["counts"][f"fuse_{name}"] = counts
            if name == "float32":
                out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            whole = unshard_volume(vol, mesh)
            if first:
                ref = single(dtype, color)
                out["equal"][name] = (
                    bits_equal(whole.tsdf, ref.tsdf)
                    and bits_equal(whole.weight, ref.weight)
                    and (not color or torch.equal(whole.color, ref.color)))
                if name == "float32" and first_pose_render is None:
                    first_pose_render = raycast_vertices_cuda(ref, cams[0], W, H)
                    single_soup = soup_to_numpy(extract_surface(
                        ref, max_cubes=MAX_CUBES, max_vertices=MAX_VERTICES))[0]
                del ref
            del whole
            if name == "float32":
                slab32 = vol
            del vol
            torch.cuda.empty_cache()
            lap(f"fuse_{name}")

        # the raycasts from the first pose, on the fused float32 slabs
        reset_launch_counts()
        rep, _ = raycast_sharded(slab32, cams[0], mesh, W, H,
                                 replicate_volume_ok=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        lap("raycast_sharded")
        brk, _ = raycast_sharded_bricked(slab32, cams[0], mesh, W, H)
        torch.cuda.synchronize()
        out["counts"]["raycasts"] = launch_counts()
        if first:
            out["replicated_equal"] = vertices_equal(rep, first_pose_render)
            out["bricked"] = bricked_agreement(brk, first_pose_render)
        del rep, brk
        torch.cuda.empty_cache()
        lap("raycast_sharded_bricked")
        out["surface"] = sharded_surface(mesh, slab32,
                                         single_soup if first else None)
        lap("surface")
        if (nb, nr) == SHARDED_MESHES[0]:
            out["checkpoint"] = sharded_checkpoint_save(
                dev, mesh, slab32, depths, cams, root, first)
        else:
            out["checkpoint"] = sharded_checkpoint_load(dev, mesh, slab32,
                                                        root, first)
        del slab32
        torch.cuda.empty_cache()
        lap("checkpoint")

        # the tracked loop (bilateral filter, the bricked model render, the
        # banded sharded pyramid, the sharded integrate)
        vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
        dist.barrier()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, _, poses, stats = track_and_fuse_frames_sharded(
            vol, cams[0], depths, mesh, use_bilateral_filter=True, band=32,
            width=W, height=H)
        torch.cuda.synchronize()
        out["tracked_ms"] = (time.perf_counter() - t0) * 1e3 / len(depths)
        out["counts"]["tracked"] = launch_counts()
        del vol
        torch.cuda.empty_cache()
        lap("tracked")
        if first:
            if single_poses is None:
                cfg = tracked_config()
                _, _, ref_poses, _ = track_and_fuse_frames(
                    cfg.make_volume(device=dev), cams[0], depths, cfg)
                single_poses = [p.cpu().numpy() for p in ref_poses]
                torch.cuda.empty_cache()
            est = [p.cpu().numpy() for p in poses]
            out["pose_gap"] = pose_gaps(est, single_poses)
            out["ate_mm"] = ate(est, list(poses_np))["rmse"]
            out["ate_single_mm"] = ate(single_poses, list(poses_np))["rmse"]
            out["last_inliers"] = int(stats[-1][1])
            lap("single_tracked")
        if (nb, nr) == SHARDED_MESHES[0]:
            out["syncs"] = sharded_loop_syncs(dev, mesh, depths, cams)
            lap("syncs")
        out["sfusion"] = sharded_sfusion(dev, mesh, sf_depth_np, first)
        lap("sfusion")
        out["sfusion_class"] = sharded_sfusion_class(dev, mesh, sf_dirs,
                                                     sf_depth_np, first, root)
        lap("sfusion_class")
        pose_kinds = [("pose", torch.float32)]
        if (nb, nr) == SHARDED_MESHES[0]:
            pose_kinds.append(("pose_bf16", BF16))
        for key, dtype in pose_kinds:
            out[key] = sharded_pose(dev, mesh, dtype, first)
            lap(key)
        results[f"{nb}x{nr}"] = out
    results["clock"] = (entered, time.time())
    return results


def sharded_tracked_rank(dev, nb, nr, depths_np, poses_np):
    """A rank of a mesh of cards (NCCL): the tracked loop, timed after a
    run of its first two frames (the kernels' first launches and the
    NCCL communicators, which each group makes at its first collective);
    the first rank returns the poses, the ms a frame and the seconds of
    that first run."""
    import torch.distributed as dist

    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.parallel import make_mesh, track_and_fuse_frames_sharded
    from tsdf_tpu_torch.parallel.ops import make_sharded_volume

    mesh = make_mesh(nb, nr, device=dev)
    depths = [torch.from_numpy(d).to(dev) for d in depths_np]
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(
        torch.from_numpy(poses_np[0]).to(dev))

    def run(frames):
        vol = make_sharded_volume(mesh, (SIZE,) * 3, PHYSICAL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, poses, _ = track_and_fuse_frames_sharded(
            vol, cam, frames, mesh, use_bilateral_filter=True, band=32,
            width=W, height=H)
        torch.cuda.synchronize()
        return poses, time.perf_counter() - t0

    _, first_s = run(depths[:2])
    poses, seconds = run(depths)
    if dist.get_rank() != mesh.ranks[0]:
        return None
    return [p.cpu().numpy() for p in poses], seconds * 1e3 / len(depths), first_s


@contextlib.contextmanager
def returned(mod, name: str, results: list):
    """Inside, every call of ``mod.name`` appends what it returns to
    ``results``."""
    fn = getattr(mod, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        results.append(out)
        return out

    setattr(mod, name, wrapper)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def hold_sharded_mesh(shape: str, ranks: list) -> dict:
    """Check one mesh's results from every rank and log them."""
    outs = [r[shape] for r in ranks]
    r0 = outs[0]
    check(all(r0["equal"].values()),
          f"{shape}: gathered slabs differ from the single volume {r0['equal']}")
    check(r0["replicated_equal"],
          f"{shape}: raycast_sharded differs from the single render")
    b = r0["bricked"]
    check(b["hit_agree"] > BRICKED_HIT_AGREE and b["median_mm"] < BRICKED_MEDIAN_MM
          and b["p99_mm"] < BRICKED_P99_MM,
          f"{shape}: the bricked raycast is off the single render {b}")
    dt, dr = r0["pose_gap"]
    check(dt < SHARDED_POSE_MM and dr < SHARDED_POSE_ROT,
          f"{shape}: tracked poses off the single-card loop's ({dt}, {dr})")
    check(r0["ate_mm"] < ATE_MAX_MM, f"{shape}: tracked ATE not under a voxel")
    tracked = N_FRAMES - 1
    instance = {"float32": "integrate", "bfloat16": "integrate_bf16",
                "color": "integrate_color"}
    for r in outs:
        c = r["counts"]
        for name in r["fuse_ms"]:
            check_counts(c[f"fuse_{name}"], f"{shape} {name} fuse",
                         **{instance[name]: N_FRAMES})
        check_counts(c["raycasts"], f"{shape} raycasts", raycast=2)
        check_counts(c["tracked"], f"{shape} tracked",
                     at_least=dict(lane_gather=19 * tracked),
                     bilateral=tracked, raycast=tracked, integrate=N_FRAMES)
    surf = r0["surface"]
    check(surf["vertices"] == surf["single_vertices"] and surf["in_order"]
          and surf["multiset"] and not any(surf["overflowed"]),
          f"{shape}: the sharded surface differs from the single card's "
          f"({surf['vertices']} / {surf['single_vertices']} vertices, in order "
          f"{surf['in_order']}, multiset {surf['multiset']}, overflowed "
          f"{surf['overflowed']})")
    sf = r0["sfusion"]
    for i, f in enumerate(sf["frames"]):
        check(f["n_corr"] == f["n_single"],
              f"{shape}: SceneFusion frame {i}: n_corr {f['n_corr']} against "
              f"the single card's {f['n_single']}")
        check(f["deform_mm"] <= SF_MESH_DEFORM_MM
              and f["tsdf_mm"] <= SF_MESH_TSDF_MM and f["weights_equal"],
              f"{shape}: SceneFusion frame {i} off the single card's {f}")
    check(sf["frames"][-1]["n_corr"] > 0, f"{shape}: SceneFusion found no surface")
    check(all(r["sfusion"]["again"] for r in outs),
          f"{shape}: two sharded SceneFusion runs differ")
    hold_sharded_checkpoint(shape, outs)
    class_ms = hold_sharded_class(shape, outs)
    poses = [k for k in ("pose", "pose_bf16") if k in r0]
    for key in poses:
        p = r0[key]
        check(p["fused_equal"] and p["adjoint_equal"] and p["miss"] == 0
              and p["grad_rel"] <= SHARDED_GRAD_REL,
              f"{shape}: the sharded pose gradient ({key}) is off the single "
              f"card's: fused slabs {p['fused_equal']}, adjoint dd/dw "
              f"{p['adjoint_equal']}, gradient {p['grad_rel']:.3g} of its norm")
    for r in outs:
        check_counts(r["surface"]["counts"], f"{shape} surface",
                     at_least=dict(lane_gather=1))
        check_counts(r["sfusion"]["counts"], f"{shape} sfusion",
                     at_least=dict(lane_gather=SF_FRAMES),
                     integrate_warped=SF_FRAMES, row_gather=SF_FRAMES)
        for key in poses:
            tag = "" if key == "pose" else "_bf16"
            check_counts(r[key]["counts"], f"{shape} {key}",
                         **{f"integrate{tag}": 1,
                            f"integrate_pose_grad_slab{tag}": 1})
    surface_s = max(r["surface"]["seconds"] for r in outs)
    sf_ms = max(r["sfusion"]["ms_per_frame"] for r in outs)
    update_ms = max(r["sfusion"]["update_ms"] for r in outs)
    pose_s = {k: max(r[k]["seconds"] for r in outs) for k in poses}
    log(f"sharded {shape}, four ranks sharing one card over gloo (a "
        f"correctness configuration): the surface of the 20-frame 512^3 "
        f"slabs {surf['vertices']} vertices (bricks {surf['per_brick']}), "
        f"bit-equal with the single card's in order {surf['in_order']} and as "
        f"a sorted multiset {surf['multiset']}, {surface_s:.3f} s (slowest "
        f"rank, extraction, gathers and merge); SceneFusion 256^3 over "
        f"{SF_MESH_PHYSICAL:.0f} mm, {SF_FRAMES} frames: n_corr "
        f"{[f['n_corr'] for f in sf['frames']]} (single card "
        f"{[f['n_single'] for f in sf['frames']]}), deform within "
        f"{max(f['deform_mm'] for f in sf['frames']):.3g} mm, tsdf within "
        f"{max(f['tsdf_mm'] for f in sf['frames']):.3g} mm, bit-equal frames "
        f"{[f['bit_equal'] for f in sf['frames']]}, a second run bit-equal; "
        f"{sf_ms:.4f} ms/frame (slowest rank), one update_deformation_sharded "
        f"{update_ms:.4f} ms; pose value-and-grad at 512^3 "
        + ", ".join(f"{k}: {pose_s[k]:.4f} s (slowest rank), gradient "
                    f"{r0[k]['grad_rel']:.3g} of its norm from the single "
                    f"card's {r0[k]['single_grad']}" for k in poses)
        + "; fused slabs and the slab adjoint's dd/dw bit-equal with the single "
        "card's")
    worst = {k: max(r["fuse_ms"][k] for r in outs) for k in r0["fuse_ms"]}
    tracked_ms = max(r["tracked_ms"] for r in outs)
    log(f"sharded {shape}, four ranks sharing one card over gloo (a "
        f"correctness configuration: these times are not a multi-card "
        f"speed): GT fuse ms/frame (slowest rank) "
        + ", ".join(f"{k} {v:.4f}" for k, v in worst.items())
        + f"; gathered slabs bit-equal with the single volume: {r0['equal']}; "
        f"raycast_sharded rows bit-equal: {r0['replicated_equal']}; bricked "
        f"raycast against the single render: hit agreement "
        f"{b['hit_agree']:.6f} ({b['hits']} hits), median {b['median_mm']:.5f}"
        f" mm, p99 {b['p99_mm']:.5f} mm; tracked loop {tracked_ms:.4f} "
        f"ms/frame, poses within {dt:.5f} mm / {dr:.2e} of the single-card "
        f"loop, ATE {r0['ate_mm']:.4f} mm (single card "
        f"{r0['ate_single_mm']:.4f} mm), last inliers {r0['last_inliers']}; "
        f"per-rank peak of the float32 fuse "
        + ", ".join(f"{r['peak_gib']:.3f}" for r in outs)
        + " GiB; seconds by step (first rank) "
        + ", ".join(f"{k} {v:.1f}" for k, v in r0["seconds"].items()))
    return dict(fuse_ms=worst, tracked_ms=tracked_ms, bricked=b,
                pose_gap=(dt, dr), ate_mm=r0["ate_mm"],
                ate_single_mm=r0["ate_single_mm"],
                peaks_gib=[r["peak_gib"] for r in outs], counts=r0["counts"],
                seconds=r0["seconds"], surface_s=surface_s, sf_ms=sf_ms,
                update_ms=update_ms, pose_s=pose_s, class_ms=class_ms,
                checkpoint=[r["checkpoint"] for r in outs],
                pose_counts={k: r0[k]["counts"] for k in poses})


def hold_sharded_checkpoint(shape: str, outs: list) -> None:
    """The checkpoint step of one mesh, from every rank: checked and
    logged."""
    ck = [r["checkpoint"] for r in outs]

    def by_rank(key):
        return "[" + ", ".join(f"{c[key]:.3f}" for c in ck) + "]"

    if "resume_equal" in ck[0]:
        check(ck[0]["resume_equal"], f"{shape}: the 512^3 fusion resumed from "
              "a sharded checkpoint differs from 4 frames fused straight")
        log(f"sharded {shape}: checkpoint at {SIZE}^3, save_sharded seconds by "
            f"rank: the fused float32 slabs {by_rank('save_f32_s')}, bf16 with "
            f"deformation and colour {by_rank('save_rich_s')}, the resume's "
            f"{by_rank('save_resume_s')}; load_sharded of the resume "
            f"{by_rank('load_resume_s')}; bytes on disk {ck[0]['bytes']}; 2 "
            "frames + save + load + 2 frames bit-equal with 4 fused straight "
            "on one card")
        return
    check(all(c["f32_equal"] and c["rich_equal"] for c in ck),
          f"{shape}: the first mesh's checkpoints restored onto {shape} differ "
          f"(float32 {[c['f32_equal'] for c in ck]}, bf16 with deformation and "
          f"colour {[c['rich_equal'] for c in ck]})")
    log(f"sharded {shape}: the first mesh's {SIZE}^3 checkpoints restored onto "
        f"{shape}, every rank's slab bit-equal (float32, and bf16 with "
        f"deformation and colour); load_sharded seconds by rank: float32 "
        f"{by_rank('load_f32_s')}, bf16 with deformation and colour "
        f"{by_rank('load_rich_s')}")


def hold_sharded_class(shape: str, outs: list) -> float:
    """The ``SceneFusion(mesh=)`` step of one mesh, from every rank: checked
    and logged; returns the slowest rank's ms/frame on the card."""
    cl = [r["sfusion_class"] for r in outs]
    c0 = cl[0]
    for rank, c in enumerate(cl):  # each rank held its own planes
        for i, f in enumerate(c["frames"]):
            check(f["n_corr"] == f["n_single"],
                  f"{shape}: SceneFusion(mesh=) frame {i}: n_corr "
                  f"{f['n_corr']} against the single card's {f['n_single']}")
            check(f["deform_mm"] <= SF_MESH_DEFORM_MM
                  and f["tsdf_mm"] <= SF_MESH_TSDF_MM and f["weights_equal"],
                  f"{shape}: SceneFusion(mesh=) frame {i}, rank {rank}, off "
                  f"the single card's {f}")
        check(len(c["frames"]) == SF_FRAMES and c["frames"][-1]["n_corr"] > 0,
              f"{shape}: SceneFusion(mesh=) ran {len(c['frames'])} frames")
    worst = {k: max(f[k] for c in cl for f in c["frames"])
             for k in ("deform_mm", "tsdf_mm")}
    bit_equal = [all(c["frames"][i]["bit_equal"] for c in cl)
                 for i in range(SF_FRAMES)]
    check(c0["ply_equal"] and c0["dump_equal"],
          f"{shape}: SceneFusion(mesh=) extract_mesh PLY equal {c0['ply_equal']}"
          f", dump {c0['dump_files']} equal {c0['dump_equal']}")
    check(all(c["card_equal"] for c in cl),
          f"{shape}: SceneFusion(mesh=) on frames on the card differs from "
          "the run on files")
    for c in cl:
        check_counts(c["counts"], f"{shape} SceneFusion(mesh=)",
                     at_least=dict(lane_gather=SF_FRAMES - 1),
                     integrate_warped=SF_FRAMES, row_gather=SF_FRAMES - 1)
    ms = max(c["ms_per_frame"] for c in cl)
    log(f"sharded {shape}: SceneFusion(mesh=) at {SF_MESH_SIZE}^3 over "
        f"{SF_MESH_PHYSICAL:.0f} mm on phase 9's files: n_corr "
        f"{[f['n_corr'] for f in c0['frames']]} (single card "
        f"{[f['n_single'] for f in c0['frames']]}), every rank's planes: "
        f"deform within {worst['deform_mm']:.3g} mm, tsdf within "
        f"{worst['tsdf_mm']:.3g} mm, bit-equal frames {bit_equal}; "
        f"extract_mesh PLY "
        f"({c0['vertices']} vertices) and dump {c0['dump_files']} byte-equal "
        f"with the single card's; on frames already on the card {ms:.4f} "
        f"ms/frame (slowest rank; by rank "
        + ", ".join(f"{c['ms_per_frame']:.4f}" for c in cl)
        + "), launches by rank (integrate_warped, row_gather, lane_gather) "
        + ", ".join(str(tuple(c["counts"][k] for k in (
            "integrate_warped", "row_gather", "lane_gather"))) for c in cl))
    return ms


def phase_sharded(dev, tum: str, out_dir: str, frames, rgbs, gt_poses,
                  single: dict, sf_depth, sf_dirs, tmp: str) -> dict:
    """The mesh path (``tsdf_tpu_torch/parallel``) at 512^3 / 640x480 on the
    20 frames.

    Four ranks on this one card over gloo (a correctness configuration:
    ranks that share a card and stage every collective through the host
    time no multi-card speed), as mesh 4x1 and then 2x2 in one spawn: the
    GT-pose sharded integrate gathered bit-equal with the single-volume
    kernel run (float32; bf16 and colour on 4x1), ``raycast_sharded``
    bit-equal with the single-card render, ``raycast_sharded_bricked``
    within the JAX gates of it, the tracked loop's poses within 2 mm / 3e-3
    of the single-card loop's and its ATE under a voxel, each rank's peak
    for the float32 fuse; the sharded checkpoint at 512^3 (saved on 4x1,
    restored onto 2x2, a resume); ``SceneFusion(mesh=)`` on phase 9's
    files (``sf_dirs``) against the single-card class. Then ``fuse
    --devices 1x1`` on NCCL: the GT-pose and colour outputs byte-equal with
    those of the verb without ``--devices`` (``single``: the earlier
    phases' runs and digests), the tracked verb's poses held to the same
    gates; ``sfusion --devices 1x1``, stdout and PLY byte-equal with phase
    12's verb. With four cards, both verbs on 4x1 and 2x2 meshes of cards
    (NCCL) too."""
    from tsdf_tpu_torch.parallel import ops as pops
    from tsdf_tpu_torch.parallel.distributed import launch

    phase_t0 = time.perf_counter()
    depths_np = [d.cpu().numpy() for d, _ in frames]
    poses_np = [p.cpu().numpy() for _, p in frames]
    rgbs_np = [c.cpu().numpy() for c in rgbs]
    torch.cuda.empty_cache()
    t0 = time.time()
    root = os.path.join(tmp, "sharded")
    os.makedirs(root)
    ranks = launch(sharded_rank, 4, (depths_np, poses_np, rgbs_np,
                                     sf_depth.cpu().numpy(), sf_dirs, root),
                   backend="gloo", device="cuda:0")
    t1 = time.time()
    result = {f"{nb}x{nr}": hold_sharded_mesh(f"{nb}x{nr}", ranks)
              for nb, nr in SHARDED_MESHES}
    entered = [r["clock"][0] for r in ranks]
    left = [r["clock"][1] for r in ranks]
    log(f"sharded: the four ranks' run {t1 - t0:.1f} s: their start (spawn, "
        f"imports, CUDA context, group) {min(entered) - t0:.1f}-"
        f"{max(entered) - t0:.1f} s, their bodies "
        f"{max(b - a for a, b in zip(entered, left)):.1f} s (the slowest), "
        f"from the last body's end to the launcher's return "
        f"{t1 - max(left):.1f} s (group teardown, exit)")
    gloo = ranks[0][f"{SHARDED_MESHES[0][0]}x{SHARDED_MESHES[0][1]}"]["syncs"]
    nccl = launch(nccl_syncs_rank, 1, (depths_np[:SYNC_FRAMES],
                                       poses_np[:SYNC_FRAMES]),
                  device="cuda")[0]
    for what, counts in (("4x1 over gloo (first rank)", gloo),
                         ("1x1 over NCCL", nccl)):
        log(f"sharded loops, {what}, over {SYNC_FRAMES} frames: GT fuse "
            f"{counts['fuse_syncs']:.2f} host syncs and "
            f"{counts['fuse_collectives']:.2f} collectives a frame; tracked "
            f"{counts['tracked_syncs']:.2f} host syncs and "
            f"{counts['tracked_collectives']:.2f} collectives a tracked frame")
    result["syncs"] = {"gloo_4x1": gloo, "nccl_1x1": nccl}

    # fuse --devices 1x1 on NCCL, against the verb without --devices
    for tag, extra, color in (("gt", (), False), ("color", ("--fuse-color",), True)):
        d = os.path.join(out_dir, f"sharded_{tag}")
        os.makedirs(d, exist_ok=True)
        run = run_fuse(dev, tum, d, extra + ("--devices", "1x1"), color=color)
        check_counts(run["counts"], f"fuse --devices 1x1 {tag}",
                     at_least=dict(lane_gather=1), raycast=1,
                     **{"integrate_color" if color else "integrate": N_FRAMES})
        same = digests(run["outs"]) == single[tag]["digests"]
        log(f"fuse --devices 1x1 {' '.join(extra)} on NCCL: outputs "
            f"byte-equal with the verb without --devices: {same}; "
            f"{run['seconds']:.2f} s (without {single[tag]['seconds']:.2f} s)")
        check(same, f"fuse --devices 1x1 {tag}: outputs differ")
        for f in run["outs"].values():
            os.remove(f)
    got = []
    d = os.path.join(out_dir, "sharded_tracked")
    os.makedirs(d, exist_ok=True)
    with returned(pops, "track_and_fuse_frames_sharded", got):
        run = run_fuse(dev, tum, d, ("--track", "--filter", "--devices", "1x1"),
                       mesh=False)
    check(len(got) == 1, "track_and_fuse_frames_sharded was not called once")
    check_counts(run["counts"], "fuse --devices 1x1 --track",
                 at_least=dict(lane_gather=19 * (N_FRAMES - 1)),
                 bilateral=N_FRAMES - 1, raycast=N_FRAMES, integrate=N_FRAMES)
    check_tracked_output(run["stdout"], "frames on 1x1 mesh")
    ref_poses = single["tracked"]["poses"]
    dt, dr = pose_gaps([p.cpu().numpy() for p in got[0][2]], ref_poses)
    ates = [next(line for line in r.splitlines() if line.startswith("ATE"))
            for r in (run["stdout"], single["tracked"]["stdout"])]
    log(f"fuse --devices 1x1 --track --filter on NCCL: poses within {dt:.5f} mm"
        f" / {dr:.2e} of the verb without --devices; {ates[0]} (without "
        f"--devices: {ates[1]}); {run['seconds']:.2f} s (without "
        f"{single['tracked']['seconds']:.2f} s)")
    check(dt < SHARDED_POSE_MM and dr < SHARDED_POSE_ROT,
          "fuse --devices 1x1 --track: poses off the single-card verb's")
    result["1x1"] = dict(pose_gap=(dt, dr), counts=run["counts"],
                         tracked_seconds=run["seconds"])
    for f in run["outs"].values():
        os.remove(f)

    # sfusion --devices 1x1 on NCCL, against phase 9's verb without it
    sf_single = single["sfusion"]
    run = run_sfusion_cli(dev, *sf_dirs, sf_single["mesh"], ("--devices", "1x1"))
    check_counts(run["counts"], "sfusion --devices 1x1",
                 at_least=dict(lane_gather=sf_single["counts"]["lane_gather"]),
                 integrate_warped=SF_FRAMES, row_gather=SF_FRAMES - 1)
    same = (run["stdout"] == sf_single["stdout"]
            and run["digest"] == sf_single["digest"])
    log(f"sfusion --devices 1x1 on NCCL: stdout and PLY byte-equal with the "
        f"verb without --devices: {same}; {run['seconds']:.2f} s (without "
        f"{sf_single['seconds']:.2f} s); launches integrate_warped "
        f"{run['counts']['integrate_warped']}, row_gather "
        f"{run['counts']['row_gather']}, lane_gather "
        f"{run['counts']['lane_gather']} (without: "
        f"{sf_single['counts']['lane_gather']})")
    check(same, "sfusion --devices 1x1: stdout or PLY differ")
    result["sfusion_1x1"] = dict(seconds=run["seconds"], counts=run["counts"])

    cards = torch.cuda.device_count()
    if cards < 4:
        log(f"fuse and sfusion --devices 4x1 / 2x2 on four cards: not run "
            f"({cards} card{'s' if cards != 1 else ''} visible)")
        log(f"sharded phase: {time.perf_counter() - phase_t0:.1f} s in all")
        return result
    result["sfusion_cards"] = sfusion_on_cards(dev, sf_dirs, out_dir)
    for nb, nr in SHARDED_MESHES:
        shape = f"{nb}x{nr}"
        for tag, extra, color in (("gt", (), False),
                                  ("color", ("--fuse-color",), True)):
            d = os.path.join(out_dir, f"sharded_{tag}_{shape}")
            os.makedirs(d, exist_ok=True)
            run = run_fuse(dev, tum, d, extra + ("--devices", shape), color=color)
            same = digests(run["outs"]) == single[tag]["digests"]
            log(f"fuse --devices {shape} {' '.join(extra)} on {nb * nr} cards "
                f"(NCCL): outputs byte-equal with one card: {same}; "
                f"{run['seconds']:.2f} s with the ranks' start")
            check(same, f"fuse --devices {shape} {tag}: outputs differ")
            for f in run["outs"].values():
                os.remove(f)
        poses, ms, first_s = launch(sharded_tracked_rank, nb * nr,
                                    (nb, nr, depths_np, poses_np),
                                    device="cuda")[0]
        dt, dr = pose_gaps(poses, ref_poses)
        log(f"tracked loop on {nb * nr} cards, mesh {shape} (NCCL): "
            f"{ms:.4f} ms/frame after a run of the first two frames in "
            f"{first_s:.2f} s (first launches, NCCL communicators), poses "
            f"within {dt:.5f} mm / {dr:.2e} of the single-card verb")
        check(dt < SHARDED_POSE_MM and dr < SHARDED_POSE_ROT,
              f"{shape} on four cards: tracked poses off the single card's")
        result[f"cards_{shape}"] = dict(tracked_ms=ms, first_s=first_s,
                                        pose_gap=(dt, dr))
    log(f"sharded phase: {time.perf_counter() - phase_t0:.1f} s in all")
    return result


# the NCCL all-gather timed between four cards: the 44 floats of one ICP
# iteration's sums, this many times after the communicator's first call
ALLGATHER_CALLS = 200


def nccl_allgather_rank(dev, n_calls):
    """A rank of a 4x1 mesh of cards (NCCL): one all-gather of 44 floats
    over the whole mesh and over "b", each first alone (the group's
    communicator is made at its first collective), then ``n_calls`` times;
    the first rank returns the seconds of the first and the ms of one."""
    import torch.distributed as dist

    from tsdf_tpu_torch.parallel import make_mesh
    from tsdf_tpu_torch.parallel.mesh import AXES, all_gather

    mesh = make_mesh(4, 1, device=dev)
    rank = dist.get_rank()
    x = torch.arange(44, dtype=torch.float32, device=dev) + rank
    out = {}
    for axis in (AXES, "b"):
        group = mesh.get_group(axis)
        t0 = time.perf_counter()
        all_gather(x, group)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            parts = all_gather(x, group)
        torch.cuda.synchronize()
        out["mesh" if axis == AXES else axis] = dict(
            first_s=first, ms=(time.perf_counter() - t0) * 1e3 / n_calls,
            ok=bool(torch.equal(parts[3], x - rank + 3)))
    return out if rank == mesh.ranks[0] else None


def sfusion_on_cards(dev, sf_dirs, out_dir: str) -> dict:
    """``sfusion -s 256`` on one card, then ``--devices 4x1`` and ``2x2`` on
    meshes of four cards (NCCL; 255 divides neither B): stdout and PLY
    byte-equal with the one card's."""
    mesh = os.path.join(out_dir, "sf_mesh_256.ply")
    size = ("-s", str(SF_MESH_SIZE))
    one = run_sfusion_cli(dev, *sf_dirs, mesh, size)
    found = {"1x1_s": one["seconds"]}
    for nb, nr in SHARDED_MESHES:
        shape = f"{nb}x{nr}"
        run = run_sfusion_cli(dev, *sf_dirs, mesh, size + ("--devices", shape))
        same = run["stdout"] == one["stdout"] and run["digest"] == one["digest"]
        log(f"sfusion -s {SF_MESH_SIZE} --devices {shape} on {nb * nr} cards "
            f"(NCCL): stdout and PLY byte-equal with one card: {same}; "
            f"{run['seconds']:.2f} s with the ranks' start (one card "
            f"{one['seconds']:.2f} s)")
        check(same, f"sfusion --devices {shape} on four cards: outputs differ")
        found[f"{shape}_s"] = run["seconds"]
    os.remove(mesh)
    return found


def run_four_cards(dev) -> dict:
    """The smoke's four-card tracked loop alone (``sharded_tracked_rank``
    on meshes 4x1 and 2x2 of cards, NCCL, timed after its two-frame
    warm-up), one NCCL all-gather of 44 floats between the four cards
    (``nccl_allgather_rank``), then ``sfusion --devices`` on those meshes
    against one card (``sfusion_on_cards``). Needs four cards."""
    from tsdf_tpu_torch.parallel.distributed import launch

    cards = torch.cuda.device_count()
    check(cards >= 4, f"--four-cards needs four cards; {cards} visible")
    with tempfile.TemporaryDirectory(prefix="tsdf_smoke_") as tmp:
        tum = os.path.join(tmp, "tum")
        gt = write_tum_dir(tum)
        frames = load_frames(dev, tum)
    depths_np = [d.cpu().numpy() for d, _ in frames]
    poses_np = [p.cpu().numpy() for _, p in frames]
    found = {}
    for nb, nr in SHARDED_MESHES:
        poses, ms, first_s = launch(sharded_tracked_rank, nb * nr,
                                    (nb, nr, depths_np, poses_np),
                                    device="cuda")[0]
        dt, dr = pose_gaps(poses, gt)
        log(f"tracked loop on {nb * nr} cards, mesh {nb}x{nr} (NCCL): "
            f"{ms:.4f} ms/frame after a run of the first two frames in "
            f"{first_s:.2f} s; poses within {dt:.4f} mm / {dr:.2e} of the "
            f"ground truth")
        found[f"{nb}x{nr}"] = dict(ms_per_frame=ms, warmup_s=first_s,
                                   gt_gap=(dt, dr))
    gathers = launch(nccl_allgather_rank, 4, (ALLGATHER_CALLS,),
                     device="cuda")[0]
    check(all(g["ok"] for g in gathers.values()), "the NCCL all-gather is wrong")
    log(f"NCCL all-gather of 44 floats between the four cards: {gathers}")
    found["allgather_44"] = gathers
    with tempfile.TemporaryDirectory(prefix="tsdf_smoke_") as tmp:
        sf_rgbd, sf_flow, _ = write_sfusion_dirs(dev, os.path.join(tmp, "sf"))
        found["sfusion"] = sfusion_on_cards(dev, (sf_rgbd, sf_flow), tmp)
    return found


def run_config3(dev, n_frames: int, noise: bool, eps: float) -> dict:
    """The workload of tools/run_config3.py: a sphere (r = 600 mm, at the
    volume's centre) in front of a wall (z = 2500 mm) seen from a smooth
    orbit; the frames are rendered from the analytic scene volume with the
    raycast kernel, then tracked and fused into an empty 256^3 volume."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
    from tsdf_tpu_torch.ops.raycast import vertices_to_camera_depth
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, track_and_fuse_frames
    from tsdf_tpu_torch.utils import fixtures
    from tsdf_tpu_torch.utils.trajectory import ate, rpe

    grid, offset = 256, (-1500.0, -1500.0, 0.0)
    scene = fixtures.sphere_tsdf(
        make_volume((grid,) * 3, PHYSICAL, offset=offset, device=dev), 600.0)
    wall = fixtures.wall_tsdf(scene, 2500.0)
    scene = scene.replace(tsdf=torch.minimum(scene.tsdf, wall.tsdf).contiguous())

    base = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    cams = []
    for t in np.arange(n_frames) / max(n_frames - 1, 1):
        cams.append(base.move_to([
            120.0 * np.sin(2 * np.pi * t),
            -80.0 * np.sin(4 * np.pi * t),
            -500.0 + 60.0 * np.cos(2 * np.pi * t),
        ]).look_at([0.0, 0.0, 1500.0]))
    gt_poses = [c.pose.cpu().numpy() for c in cams]
    frames = [
        vertices_to_camera_depth(raycast_vertices_cuda(scene, c, W, H), c.pose_inv)
        for c in cams
    ]
    if noise:
        gen = torch.Generator(device=dev).manual_seed(42)
        frames = [fixtures.kinect_noise(f, gen) for f in frames]
    torch.cuda.synchronize()
    log(f"config3: {n_frames} frames rendered"
        f"{' (kinect noise applied)' if noise else ''}")

    cfg = FusionConfig(volume_size=(grid,) * 3, physical_size_mm=PHYSICAL,
                       offset_mm=offset, width=W, height=H,
                       use_bilateral_filter=True, icp_conv_eps=eps)
    track_and_fuse_frames(cfg.make_volume(device=dev), cams[0], frames[:2], cfg)
    vol = cfg.make_volume(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol, _cam, poses, stats = track_and_fuse_frames(vol, cams[0], frames, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    est = [p.cpu().numpy() for p in poses]
    a, r = ate(est, gt_poses), rpe(est, gt_poses, delta=1)
    err, inl = stats[-1]
    fused = int(vol.weight.max())
    log(f"config3: {n_frames} frames @ {grid}^3: {seconds:.3f} s = "
        f"{seconds / n_frames * 1e3:.4f} ms/frame; ATE rmse {a['rmse']:.4f} mm "
        f"(max {a['max']:.4f}); RPE trans rmse {r['trans_rmse']:.4f} mm, rot "
        f"{r['rot_rmse'] * 1e3:.4f} mrad; final ICP residual {float(err):.4f} mm, "
        f"{int(inl)} inliers; most-fused voxel holds {fused} frames")
    return dict(config3_frames=n_frames, config3_grid=grid, config3_noise=noise,
                config3_eps=eps, config3_ms_per_frame=seconds / n_frames * 1e3,
                config3_ate_rmse_mm=a["rmse"], config3_ate_max_mm=a["max"],
                config3_rpe_trans_rmse_mm=r["trans_rmse"],
                config3_rpe_rot_rmse_mrad=r["rot_rmse"] * 1e3,
                config3_last_inliers=int(inl))


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--config3", action="store_true",
        help="instead of the smoke, track and fuse the 500-pose orbit of "
             "tools/run_config3.py at 256^3 and print ms/frame, ATE and RPE",
    )
    parser.add_argument(
        "--parent", metavar="DIR",
        help="also build the kernels of the checkout at DIR (the parent "
             "commit, unpacked) and time its raycast, integrate, "
             "pose-adjoint, bilateral, row-gather, windowed-gather, "
             "guarded-fallback and probe entry points beside this tree's on "
             "the same inputs",
    )
    parser.add_argument(
        "--four-cards", action="store_true",
        help="instead of the smoke, on four cards: the tracked loop on "
             "meshes 4x1 and 2x2 of cards after its warm-up, one NCCL "
             "all-gather of 44 floats between them, and sfusion -s 256 "
             "--devices 4x1 / 2x2 against one card",
    )
    parser.add_argument(
        "--lm", action="store_true",
        help="instead of the smoke, only config 4's Levenberg-Marquardt: the "
             "linearisation kernel against its twin and its bound at 512^3 / "
             "640x480 (float32 and bf16), then the recovery",
    )
    parser.add_argument("--frames", type=int, default=500,
                        help="--config3: number of frames")
    parser.add_argument("--noise", action="store_true",
                        help="--config3: corrupt the frames with kinect_noise")
    parser.add_argument("--eps", action="store_true",
                        help="--config3: ICP early exit at 0.02")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    started = time.perf_counter()
    name, smi = phase_environment()
    phase_build()
    if args.parent:
        global PARENT_LIB, PARENT_DIR
        PARENT_LIB = load_parent(args.parent)
        PARENT_DIR = args.parent
    if args.lm:
        found = {"lm_linearise": compare_lm_linearise(dev)}
        torch.cuda.empty_cache()
        config4 = phase_config4(dev)
        found["config4"] = {k: v for k, v in config4.items() if k != "profile"}
        log(smi)
        print(json.dumps(found))
        return 0
    if args.config3 or args.four_cards:
        found = (run_four_cards(dev) if args.four_cards else run_config3(
            dev, args.frames, args.noise, 0.02 if args.eps else 0.0))
        log(smi)
        print(json.dumps(found))
        return 0

    with tempfile.TemporaryDirectory(prefix="tsdf_smoke_") as tmp:
        tum = os.path.join(tmp, "tum")
        poses = write_tum_dir(tum)
        out_dir = os.path.join(tmp, "out")
        os.makedirs(out_dir)
        frames = load_frames(dev, tum)
        results = {"integrate": compare_integrate(dev, frames[:2])}
        scene_vol = analytic_volume(dev)
        fused = fused_volume(dev, frames)
        results["raycast"] = compare_raycast(
            dev, {"analytic": scene_vol, "fused": fused}, frames[0][1])
        del fused
        results["lane_gather"] = compare_gather(dev, scene_vol, frames[0][0])
        del scene_vol
        results["bilateral"] = compare_bilateral(dev, frames[1][0])
        torch.cuda.empty_cache()
        rgbs = load_rgbs(dev, tum)
        check(len(rgbs) == len(frames) and all(c is not None for c in rgbs),
              "a colour frame is missing")
        results.update(compare_integrate_variants(dev, frames[:2], rgbs[:2]))
        torch.cuda.empty_cache()
        sf_rgbd, sf_flow, sf_depth_u16 = write_sfusion_dirs(
            dev, os.path.join(tmp, "sf"))
        sf_depth, sf_flows = sf_inputs(dev, sf_depth_u16)
        results.update(compare_integrate_warped(
            dev, frames[:2], sf_depth, sf_flows))
        torch.cuda.empty_cache()
        results["row_gather"] = compare_row_gather(dev, sf_depth, sf_flows)
        results["lane_gather"].update(
            compare_gather_masked(dev, sf_depth, sf_flows))
        results.update(compare_windowed(dev))
        torch.cuda.empty_cache()
        results["integrate_pose_grad"] = compare_pose_grad(dev, frames[:2])
        torch.cuda.empty_cache()
        results["gather_probe"] = compare_probe(dev)
        torch.cuda.empty_cache()
        config4b = phase_config4b(dev)
        torch.cuda.empty_cache()
        results["lm_linearise"] = compare_lm_linearise(dev)
        torch.cuda.empty_cache()
        config4 = phase_config4(dev)
        torch.cuda.empty_cache()

        first_pose = poses[0].astype(np.float32)
        gt_path = phase_gt_path(dev, tum, out_dir)
        phase_surface(dev, gt_path["outs"], first_pose)
        icp_counts = phase_icp_verb(dev, gt_path["outs"]["tsdf"], out_dir)
        phase_api(dev, frames, rgbs, gt_path["outs"]["tsdf"], tmp, smi)
        gt_path["digests"] = digests(gt_path["outs"])
        for f in gt_path["outs"].values():
            os.remove(f)

        tracked_path = phase_tracked_path(dev, tum, out_dir)
        phase_surface(dev, tracked_path["outs"], first_pose)
        tracked_path["digests"] = digests(tracked_path["outs"])
        for f in tracked_path["outs"].values():
            os.remove(f)
        torch.cuda.empty_cache()
        phase_tracked_loop(dev, frames, poses)
        torch.cuda.empty_cache()

        color_path = phase_color_path(dev, tum, out_dir, frames, rgbs)
        color_path["digests"] = digests(color_path["outs"])
        for f in color_path["outs"].values():
            os.remove(f)
        torch.cuda.empty_cache()
        color_tracked = phase_color_tracked_path(dev, tum, out_dir, rgbs)
        torch.cuda.empty_cache()
        fast = phase_fast(dev, frames, rgbs, poses)
        torch.cuda.empty_cache()
        sf_cli = phase_sfusion_cli(dev, sf_rgbd, sf_flow, out_dir)
        sharded = phase_sharded(dev, tum, out_dir, frames, rgbs, poses, {
            "gt": gt_path, "color": color_path, "tracked": tracked_path,
            "sfusion": sf_cli}, sf_depth, (sf_rgbd, sf_flow), tmp)
        torch.cuda.empty_cache()
        bf16 = phase_bf16(dev, frames, rgbs, poses, sf_depth, sf_flows)
        del frames, rgbs
        torch.cuda.empty_cache()
        sfusion = phase_sfusion(dev, sf_rgbd, sf_flow, out_dir, sf_depth,
                                sf_flows, sf_cli)
        warped_color = phase_warped_color(dev, sf_depth)

    # the adjoint's slab instances get lines of their own (below)
    slab_timed = (results["integrate_pose_grad"].pop("slab"),
                  bf16["integrate_pose_grad_bf16"].pop("slab"))
    meta = {
        "integrate": ("tsdf_tpu_torch/csrc/integrate.cu",
                      "tsdf_tpu/kernels/integrate.py:289"),
        "raycast": ("tsdf_tpu_torch/csrc/raycast.cu",
                    "tsdf_tpu/kernels/raycast.py:518"),
        "lane_gather": ("tsdf_tpu_torch/csrc/gather.cu",
                        "tsdf_tpu/kernels/gather.py:76"),
        "bilateral": ("tsdf_tpu_torch/csrc/bilateral.cu",
                      "tsdf_tpu/kernels/bilateral.py:38"),
    }
    # launches: on the tracked path, which runs these four kernels; beside
    # it the counts on the GT-pose path and in the icp verb
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": tracked_path["counts"][k],
         "launches_on": "fuse --track --filter",
         "launches_gt_path": gt_path["counts"][k],
         "launches_icp_verb": icp_counts[k], **results[k]}
        for k, (src, rep) in meta.items()
    ]
    # the mesh path runs the same four on every rank: their launches on
    # one rank of the 4x1 tracked loop (four ranks sharing the card)
    for entry in kernels:
        entry["launches_sharded_rank"] = (
            sharded["4x1"]["counts"]["tracked"][entry["name"]])
    # the differentiable paths reuse two of them
    kernels[0]["launches_config4b"] = config4b["counts"]["integrate"]
    kernels[1]["launches_config4"] = config4["counts"]["raycast"]
    # the kernels of colour fusion and of the fast mode, each with the
    # launches of the path that runs it
    color_src = "tsdf_tpu_torch/csrc/integrate_color.cu"
    for k, src, rep, counts, path, more in (
        ("integrate_color", color_src, "tsdf_tpu/kernels/integrate.py:1087",
         color_path["counts"], "fuse --fuse-color",
         {"launches_tracked_color_path": color_tracked["counts"]["integrate_color"]}),
        ("integrate_fast", "tsdf_tpu_torch/csrc/integrate_fast.cu",
         "tsdf_tpu/kernels/integrate.py:371", fast["fuse"],
         "fuse_frames(integrate_mode='fast')",
         {"launches_tracked_fast": fast["tracked"]["integrate_fast"]}),
        ("integrate_color_fast", color_src, "tsdf_tpu/kernels/integrate.py:1087",
         fast["color"], "fuse_frames(integrate_mode='fast'), colour frames", {}),
    ):
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[k],
                        "launches_on": path, **more, **results[k]})
    # the kernels of the SceneFusion path, with the launches of the
    # ``sfusion`` verb; the lane gather's count there stands beside its
    # others. The windowed lane gather and its guarded fallback are public
    # functions that no path of either package calls: their counters, read
    # after the verb like the others, stand at 0; they are compared with
    # their twins in the gather phase above.
    kernels[2]["launches_sfusion"] = sfusion["counts"]["lane_gather"]
    warped_src = "tsdf_tpu_torch/csrc/integrate_warped.cu"
    no_path = "no path of either package calls it"
    probe = "no path: a probe of the card's gather rate"
    for k, src, rep, launches, path in (
        ("integrate_warped", warped_src, "tsdf_tpu/kernels/integrate.py:473",
         sfusion["counts"]["integrate_warped"], "sfusion"),
        ("integrate_warped_color", warped_src, "tsdf_tpu/kernels/integrate.py:473",
         warped_color["integrate_warped_color"],
         "fuse_frames, colour frames into a deformed volume"),
        ("row_gather", "tsdf_tpu_torch/csrc/gather_rows.cu",
         "tsdf_tpu/kernels/gather.py:270", sfusion["counts"]["row_gather"],
         "sfusion"),
        ("lane_gather_windowed", "tsdf_tpu_torch/csrc/gather_windowed.cu",
         "tsdf_tpu/kernels/gather.py:132",
         sfusion["counts"]["lane_gather_windowed"], no_path),
        ("lane_gather_checked", "tsdf_tpu_torch/csrc/gather.cu",
         "tsdf_tpu/kernels/gather.py:245",
         sfusion["counts"]["lane_gather_if_missed"], no_path),
    ):
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches,
                        "launches_on": path, **results[k]})
    # the pose adjoint, with its launches on the config4b descent; the
    # probe, with its counter read after that run (0)
    for k, src, rep, path in (
        ("integrate_pose_grad", "tsdf_tpu_torch/csrc/integrate_pose_grad.cu",
         "tsdf_tpu/kernels/integrate.py:1378",
         "config4b: descent through integrate_pose"),
        ("gather_probe", "tsdf_tpu_torch/csrc/probe_gather.cu",
         "tools/probe_gather_roofline.py:36", probe),
    ):
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": config4b["counts"][k],
                        "launches_on": path, **results[k]})
    # the bf16-storage instances, each with the launches of the path on a
    # bf16 volume that runs it (the counts set to 0 just before it)
    integ = "tsdf_tpu/kernels/integrate.py"
    for k, src, rep, path in (
        ("integrate_bf16", "integrate.cu", f"{integ}:289",
         "fuse_frames, bf16 volume"),
        ("integrate_color_bf16", "integrate_color.cu", f"{integ}:1087",
         "fuse_frames, colour frames, bf16 volume"),
        ("integrate_fast_bf16", "integrate_fast.cu", f"{integ}:371",
         "fuse_frames(integrate_mode='fast'), bf16 volume"),
        ("integrate_color_fast_bf16", "integrate_color.cu", f"{integ}:1087",
         "fuse_frames(integrate_mode='fast'), colour frames, bf16 volume"),
        ("raycast_bf16", "raycast.cu", "tsdf_tpu/kernels/raycast.py:518",
         "track_and_fuse_frames, bf16 volume"),
        ("integrate_warped_bf16", "integrate_warped.cu", f"{integ}:473",
         "SceneFusion loop, bf16 volume"),
        ("integrate_warped_color_bf16", "integrate_warped.cu", f"{integ}:473",
         "fuse_frames, colour frames into a deformed bf16 volume"),
        ("integrate_pose_grad_bf16", "integrate_pose_grad.cu", f"{integ}:1378",
         "config4b: a value-and-grad step on a bf16 volume"),
    ):
        kernels.append({"name": k, "route": "cuda",
                        "source": f"tsdf_tpu_torch/csrc/{src}", "replaces": rep,
                        "launches_on": path, **bf16[k]})
    # the adjoint's slab instances, with their launches on one rank of the
    # sharded value-and-grad on the 4x1 mesh (four ranks sharing the card)
    pose_counts = sharded["4x1"]["pose_counts"]
    for k, counts, timed in (
        ("integrate_pose_grad_slab", pose_counts["pose"], slab_timed[0]),
        ("integrate_pose_grad_slab_bf16", pose_counts["pose_bf16"],
         slab_timed[1]),
    ):
        kernels.append({"name": k, "route": "cuda",
                        "source": "tsdf_tpu_torch/csrc/integrate_pose_grad.cu",
                        "replaces": f"{integ}:1378", "launches": counts[k],
                        "launches_on": "integrate_pose_sharded value-and-grad, "
                        "4x1 mesh (one rank's count)", **timed})
    # the Levenberg-Marquardt linearisation, with its launches on config 4's
    # recovery; its bf16 instance timed on the bf16 copy of the scene
    for k, part in (("lm_linearise", "f32"), ("lm_linearise_bf16", "bf16")):
        kernels.append({"name": k, "route": "cuda",
                        "source": "tsdf_tpu_torch/csrc/lm_linearise.cu",
                        "replaces": "none: jax.jacfwd through the Newton correction",
                        "launches": config4["counts"][k] if part == "f32" else None,
                        "launches_on": "config4: recover_pose_lm",
                        **results["lm_linearise"][part]})
    for entry in kernels:
        if entry["launches"] is None:
            continue
        check(entry["launches"] > 0 or entry["launches_on"] in (no_path, probe),
              f"{entry['name']} was never launched")
    log(f"config4b: {config4b['host_step_ms']:.4f} ms a value-and-grad step "
        f"on the host, {config4b['step_ms']:.4f} by CUDA events (with the "
        f"parent's adjoint {ms_text(config4b['parent_step_ms'])}), "
        f"translation residual {config4b['start_mm']:.4f} -> "
        f"{config4b['residual_mm']:.4f} mm; config4: "
        f"{config4['host_step_ms']:.4f} ms a Levenberg-Marquardt step, "
        f"{config4['final_mm']:.4f} mm in {config4['iters']} iterations")
    log(f"bf16 storage: 512^3 depth fuse peak {bf16['paths']['depth']['peak_gib_bf16']:.3f}"
        f" GiB (float32 {bf16['paths']['depth']['peak_gib_f32']:.3f})")
    log(f"SceneFusion: {sfusion['ms_per_frame']:.4f} ms/frame on the device, "
        f"{sfusion['syncs_per_frame']:.3f} host syncs per frame, the sfusion "
        f"verb {sfusion['cli_seconds']:.2f} s for {SF_FRAMES} frames")
    log(f"smoke: {time.perf_counter() - started:.1f} s in all, the build "
        "included")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
