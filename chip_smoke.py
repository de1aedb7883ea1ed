"""Chip smoke of the PyTorch/CUDA port: the GT-pose fuse -> render -> mesh
path on one NVIDIA card, at the repository's 512^3 / 640x480 size.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught):

  1. environment: torch/CUDA versions, the card, its power limit;
  2. build: compile csrc/*.cu with nvcc into the package's build dir;
  3. each kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it, with CUDA-event median times
     (integrate over two frames, so the second blends into voxels that
     already hold weight);
  4. the main path: a fabricated 20-frame TUM directory (a wall and two
     spheres, intersected in closed form) through
     ``tsdf_tpu_torch.cli.main(["fuse", ...])``, with launch counts,
     output checks and the raycast hits' distance from the analytic
     surface;
  5. the per-frame fuse time of the device loop alone.

The next-to-last line of output is one JSON object naming each kernel,
the last is {"ok": true, "device": {...}}. Needs one card; imports no
JAX.

    python3 chip_smoke.py --probe

runs, in place of phases 3-5, the measurements PERF.md's findings rest
on and prints them as one JSON object on the last line.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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

# agreement gates between each kernel and its plain twin
INTEGRATE_MIN_WEIGHT_AGREE = 0.9999
INTEGRATE_TSDF_ATOL = 5e-3  # mm, where the weights agree
RAYCAST_MIN_HIT_AGREE = 0.999
RAYCAST_MEDIAN_MM = 0.5
SURFACE_MEDIAN_MM = PHYSICAL / SIZE  # one voxel


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
    lines = []
    poses = frame_poses()
    for i, pose in enumerate(poses):
        stamp = f"{i}.000000"
        z = analytic_depth(pose)
        save_png(
            os.path.join(root, "depth", f"{stamp}.png"),
            np.clip(np.round(z * 5.0), 0, 65535).astype(np.uint16),
        )
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
    from tsdf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path()})")


def compare_integrate(dev, frames) -> dict:
    """Fuse the first two frames into one 512^3 volume with the kernel
    and into another with the plain twin, and compare after the second:
    the second frame blends into voxels that already hold weight, as 19
    of the main path's 20 frames do."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import integrate_cuda
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
    same_w = out.weight == ref.weight
    agree = float(same_w.float().mean())
    err = float((out.tsdf - ref.tsdf)[same_w].abs().max())
    log(f"integrate 512^3, two frames: weights equal on {agree:.8f} of "
        f"voxels, max |tsdf diff| where equal {err:.3g} mm; the second "
        f"frame blended into {blended} voxels of weight > 0")
    check(blended > 0, "the second frame blended into no voxel")
    check(agree >= INTEGRATE_MIN_WEIGHT_AGREE, "integrate weights disagree")
    check(err <= INTEGRATE_TSDF_ATOL, "integrate tsdf disagrees")
    depth, cam = frames[1][0], cams[1]
    ms = median_ms(lambda: integrate_cuda(out, depth, cam), reps=20)
    plain_ms = median_ms(lambda: integrate_plain(before, depth, cam), reps=5)
    log(f"integrate 512^3 one frame: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def compare_raycast(dev, vol, pose) -> dict:
    """The kernel's vertices against the twin's; normals, plain in both,
    are outside the comparison and the times."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.kernels.raycast import raycast_vertices_cuda
    from tsdf_tpu_torch.ops.raycast import raycast_vertices

    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(pose)
    vk = raycast_vertices_cuda(vol, cam, W, H)
    vp = raycast_vertices(vol, cam, W, H)
    torch.cuda.synchronize()
    hk = torch.isfinite(vk).all(-1)
    hp = torch.isfinite(vp).all(-1)
    agree = float((hk == hp).float().mean())
    both = hk & hp
    diff = (vk[both] - vp[both]).norm(dim=-1)
    med = float(diff.median())
    err = float((vk[both] - vp[both]).abs().max())
    log(f"raycast 512^3 {W}x{H}: hit masks agree on {agree:.6f}, "
        f"{int(both.sum())} hits, median |vertex diff| {med:.3g} mm, "
        f"max abs {err:.3g} mm")
    check(agree >= RAYCAST_MIN_HIT_AGREE, "raycast hit masks disagree")
    check(med < RAYCAST_MEDIAN_MM, "raycast vertices disagree")
    ms = median_ms(lambda: raycast_vertices_cuda(vol, cam, W, H), reps=10)
    plain_ms = median_ms(lambda: raycast_vertices(vol, cam, W, H), reps=3)
    log(f"raycast 512^3 {W}x{H} vertices: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def compare_gather(dev, vol) -> dict:
    """The four lane-gather calls of one extraction of ``vol``, at its
    shapes: vertex counts (n_occ x 1 from a 256-word broadcast table),
    triangle table (max_cubes x 15 from 3840 words), slot vertices
    (max_cubes x 45 from 36-word rows), slot voxels (max_cubes x 30
    from 24-word int rows)."""
    from tsdf_tpu_torch.kernels.gather import lane_gather_op, take_or_zero
    from tsdf_tpu_torch.ops.mc_tables import CORNER_OFFSETS, TRI_TABLE, VERT_COUNTS

    d = vol.tsdf
    cz, cy, cx = (s - 1 for s in d.shape)
    inside = (d < 0).to(torch.uint8)
    types = torch.zeros((cz, cy, cx), dtype=torch.uint8, device=dev)
    for k in range(8):
        dx, dy, dz = (int(v) for v in CORNER_OFFSETS[k])
        types |= inside[dz:dz + cz, dy:dy + cy, dx:dx + cx] << k
    types = types.reshape(-1)
    occ = types[(types != 0) & (types != 255)].to(torch.int32)
    n_occ = occ.numel()
    check(0 < n_occ <= MAX_CUBES, f"{n_occ} occupied cubes")
    cube_types = torch.zeros(MAX_CUBES, dtype=torch.int32, device=dev)
    cube_types[:n_occ] = occ

    gen = torch.Generator(device=dev).manual_seed(0)
    slot = torch.arange(15, dtype=torch.int32, device=dev)
    tri = torch.as_tensor(TRI_TABLE.reshape(-1), dtype=torch.int32, device=dev)
    counts = torch.as_tensor(VERT_COUNTS, dtype=torch.int32, device=dev)
    calls = [
        (counts[None, :].expand(n_occ, 256), occ[:, None].contiguous()),
        (tri[None, :].expand(MAX_CUBES, tri.numel()),
         (cube_types[:, None] * 15 + slot).contiguous()),
        (torch.randn(MAX_CUBES, 36, generator=gen, device=dev),
         torch.randint(-2, 38, (MAX_CUBES, 45), generator=gen, device=dev,
                       dtype=torch.int32)),
        (torch.randint(0, 1 << 27, (MAX_CUBES, 24), generator=gen,
                       device=dev, dtype=torch.int32),
         torch.randint(-2, 26, (MAX_CUBES, 30), generator=gen, device=dev,
                       dtype=torch.int32)),
    ]
    err = 0.0
    for table, idx in calls:
        got = lane_gather_op(table, idx)
        want = take_or_zero(table, idx)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"lane gather differs at table {tuple(table.shape)}")
        err = max(err, float((got.double() - want.double()).abs().max()))
    ms = sum(median_ms(lambda t=t, i=i: lane_gather_op(t, i), reps=20)
             for t, i in calls)
    plain_ms = sum(median_ms(lambda t=t, i=i: take_or_zero(t, i), reps=20)
                   for t, i in calls)
    log(f"lane gather, one extraction's four calls ({n_occ} occupied cubes, "
        f"max_cubes {MAX_CUBES}): bit-equal, max |diff| {err:.3g}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def fuse_argv(dev, tum: str, out_dir: str) -> tuple[list[str], dict]:
    """The main path's ``fuse`` command line and its output files."""
    outs = {k: os.path.join(out_dir, f) for k, f in (
        ("tsdf", "out.tsdf"), ("scene", "scene.png"),
        ("normals", "normals.png"), ("mesh", "mesh.ply"))}
    argv = [
        "fuse", "-d", tum, "-m", str(N_FRAMES), "-s", str(SIZE),
        "--physical", str(PHYSICAL), "--device", dev.type,
        "-o", outs["tsdf"], "--scene", outs["scene"],
        "--normals", outs["normals"], "--mesh", outs["mesh"],
        "--max-cubes", str(MAX_CUBES), "--max-vertices", str(MAX_VERTICES),
    ]
    return argv, outs


def phase_main_path(dev, tum: str, out_dir: str) -> dict:
    from tsdf_tpu_torch import cli
    from tsdf_tpu_torch.kernels import launch_counts, reset_launch_counts

    argv, outs = fuse_argv(dev, tum, out_dir)
    err = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    sys.stderr.write(err.getvalue())
    log(f"main path: rc {rc} in {seconds:.2f} s; launches {counts}")
    check(rc == 0, f"fuse returned {rc}")
    for k, path in outs.items():
        check(os.path.getsize(path) > 0, f"missing output {k}")
    check("overflowed" not in err.getvalue(), "mesh buffers overflowed")
    check(counts["integrate"] == N_FRAMES, "integrate launches")
    check(counts["raycast"] >= 1, "raycast launches")
    check(counts["lane_gather"] >= 1, "lane gather launches")
    with open(outs["mesh"]) as f:
        header = [next(f) for _ in range(9)]
    n_vert = int(header[2].split()[-1])
    n_face = int(header[6].split()[-1])
    log(f"mesh: {n_vert} vertices, {n_face} triangles")
    check(n_vert > 0 and n_vert == 3 * n_face, "mesh is empty or torn")
    return dict(outs=outs, counts=counts)


def phase_surface(dev, outs: dict, first_pose: np.ndarray) -> float:
    """Raycast the saved volume from the first pose, as the CLI's render
    did, and measure the hits against the analytic scene."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.io.png import load_png
    from tsdf_tpu_torch.io.tsdf_file import load_tsdf
    from tsdf_tpu_torch.kernels.raycast import raycast_cuda

    vol = load_tsdf(outs["tsdf"], device=dev)
    check(tuple(vol.tsdf.shape) == (SIZE,) * 3, "saved volume shape")
    check(bool(torch.isfinite(vol.tsdf).all()), "non-finite tsdf")
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev).set_pose(
        torch.as_tensor(first_pose, dtype=torch.float32))
    verts, _ = raycast_cuda(vol, cam, W, H)
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


def phase_fuse_time(dev, frames) -> float:
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames

    cfg = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL)
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    vol = cfg.make_volume(device=dev)
    ms = median_ms(lambda: fuse_frames(vol, cam, frames, cfg), reps=3)
    ms /= len(frames)
    log(f"fuse loop on the device, 512^3: {ms:.4f} ms/frame "
        f"(median of 3 runs of {len(frames)} frames already on the card)")
    return ms


# -- the probe (--probe): the measurements behind PERF.md's findings --------


def probe_main_path(dev, tum: str, out_dir: str) -> dict:
    """The main path alone under cProfile: its host time per step and its
    own peak of device memory (nothing else is allocated yet)."""
    import cProfile
    import pstats

    from tsdf_tpu_torch import cli

    argv, outs = fuse_argv(dev, tum, out_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    prof.disable()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check(rc == 0, f"fuse returned {rc}")
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(
        r"write_ply|save_tsdf|fuse_frames|extract_surface|_render_outputs")
    log(text.getvalue())
    log(f"probe main path: {seconds:.3f} s, own peak device memory "
        f"{peak / 2**30:.3f} GiB")
    for f in outs.values():
        os.remove(f)
    return dict(main_path_s=seconds, main_path_peak_gib=peak / 2**30)


def probe_integrate(dev, frames) -> dict:
    """The integrate kernel at 512^3 on frames that move different bytes
    and skip different work, beside a 1 GiB device copy (2 GiB of
    traffic: what a frame that updates every voxel must move)."""
    from tsdf_tpu_torch import Camera, make_volume
    from tsdf_tpu_torch.kernels.integrate import integrate_cuda

    depth0, pose0 = frames[0]
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    pos = pose0[:3, 3].cpu().numpy()
    away = look_at_pose(pos, pos - np.array([0.0, 0.0, 1000.0]))
    cases = {
        "real frame": (depth0, cam.set_pose(pose0)),
        "zero depth": (torch.zeros_like(depth0), cam.set_pose(pose0)),
        "facing away": (depth0, cam.set_pose(
            torch.as_tensor(away, dtype=torch.float32, device=dev))),
        # the back face of the volume (z = 3000 mm) seen from z ~ -400:
        # every voxel in view is in front of the surface
        "far wall": (torch.full_like(depth0, PHYSICAL + 400.0),
                     cam.set_pose(pose0)),
    }
    vol = make_volume((SIZE,) * 3, PHYSICAL, device=dev)
    out = {}
    for name, (depth, c) in cases.items():
        vol.tsdf.fill_(float(vol.truncation_distance))
        vol.weight.zero_()
        integrate_cuda(vol, depth, c)
        updated = int((vol.weight > 0).sum())
        ms = median_ms(lambda: integrate_cuda(vol, depth, c), reps=20)
        log(f"probe integrate 512^3, {name}: {ms:.4f} ms, {updated} voxels "
            f"updated ({updated * 16 / 1e9:.3f} GB of tsdf+weight traffic)")
        out[f"integrate {name} ms"] = ms
        out[f"integrate {name} voxels"] = updated
    del vol
    src = torch.empty(2 * SIZE**3, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = median_ms(lambda: dst.copy_(src), reps=20)
    log(f"probe 1 GiB device copy: {ms:.4f} ms "
        f"({2 * src.numel() * 4 / ms / 1e9:.3f} TB/s)")
    out["copy 1 GiB ms"] = ms
    return out


def probe_fuse_loop(dev, frames) -> dict:
    """One 20-frame ``fuse_frames`` run under torch.profiler: device busy
    time (the sum of the card's kernel times), wall time, idle share,
    and the host syncs the loop makes."""
    from torch.profiler import ProfilerActivity, profile

    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames

    cfg = FusionConfig(volume_size=(SIZE,) * 3, physical_size_mm=PHYSICAL)
    cam = Camera.from_intrinsics(FX, FY, CX, CY, device=dev)
    vol = cfg.make_volume(device=dev)
    fuse_frames(vol, cam, frames, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fuse_frames(vol, cam, frames, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    syncs = sum(e.count for e in events
                if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                             "cudaDeviceSynchronize"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"probe fuse loop kernel {e.key[:60]}: {e.count} launches, "
            f"{e.self_device_time_total / 1e3:.4f} ms")
    idle = 1.0 - busy_ms / wall_ms
    log(f"probe fuse loop, {len(frames)} frames: wall {wall_ms:.3f} ms under "
        f"the profiler, device busy {busy_ms:.3f} ms, idle share {idle:.3f}, "
        f"{syncs} host syncs")
    return dict(fuse_wall_ms=wall_ms, fuse_busy_ms=busy_ms, fuse_idle=idle,
                fuse_host_syncs=syncs)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--probe", action="store_true",
        help="instead of the smoke, measure what PERF.md's findings rest "
             "on: the main path's host time per step and device peak, the "
             "integrate kernel on frames of different traffic, the fuse "
             "loop's idle share",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 1
    import tsdf_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_environment()
    phase_build()

    with tempfile.TemporaryDirectory(prefix="tsdf_smoke_") as tmp:
        tum = os.path.join(tmp, "tum")
        poses = write_tum_dir(tum)
        out_dir = os.path.join(tmp, "out")
        os.makedirs(out_dir)
        if args.probe:
            found = probe_main_path(dev, tum, out_dir)
            frames = load_frames(dev, tum)
            found.update(probe_integrate(dev, frames))
            found.update(probe_fuse_loop(dev, frames))
            log(smi)
            print(json.dumps(found))
            return 0

        frames = load_frames(dev, tum)
        results = {"integrate": compare_integrate(dev, frames[:2])}
        scene_vol = analytic_volume(dev)
        results["raycast"] = compare_raycast(dev, scene_vol, frames[0][1])
        results["lane_gather"] = compare_gather(dev, scene_vol)
        del scene_vol
        torch.cuda.empty_cache()

        main_path = phase_main_path(dev, tum, out_dir)
        phase_surface(dev, main_path["outs"], poses[0].astype(np.float32))
        for f in main_path["outs"].values():
            os.remove(f)
        phase_fuse_time(dev, frames)

    meta = {
        "integrate": ("tsdf_tpu_torch/csrc/integrate.cu",
                      "tsdf_tpu/kernels/integrate.py:289"),
        "raycast": ("tsdf_tpu_torch/csrc/raycast.cu",
                    "tsdf_tpu/kernels/raycast.py:518"),
        "lane_gather": ("tsdf_tpu_torch/csrc/gather.cu",
                        "tsdf_tpu/kernels/gather.py:76"),
    }
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_path["counts"][k], **results[k]}
        for k, (src, rep) in meta.items()
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
