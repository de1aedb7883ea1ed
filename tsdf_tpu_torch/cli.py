"""Command-line tools of the PyTorch/CUDA port.

Verbs:

  fuse     kinfu -m N -d dir: fuse TUM frames with their ground-truth
           poses, or with --track by ICP against the raycast model
           (--filter: bilateral prefilter; --fuse-color: fuse the
           rgb/<stamp>.png frames into per-voxel colour), write
           scene.png/normals.png/mesh.ply, with --color a colour render
           and, with -o, a .tsdf file
  render   load a .tsdf, raycast it to scene/normals (and --color) PNGs
  mesh     marching cubes a .tsdf to PLY (--color: per-vertex RGB)
  view     per-slice heat-maps of a .tsdf's distance field, tiled into
           top.png, right.png and front.png
  icp      raycast a .tsdf to depth, ICP against a depth PNG, print the
           incremental pose + lastError/lastInliers
  sfusion  non-rigid fusion (SceneFusion) from an RGBD dir
           (depth_NNNNN.png / colour_NNNNN.png) and a scene-flow dir
           (PD-Flow text or SRSF XML), write mesh.ply
  convert  format converters: freenect2png, pgm2png, fl2uchar (host
           code, no device)

``fuse --devices BxR`` and ``sfusion --devices BxR`` run on a mesh of
B x R ranks (``parallel/``): B z-slabs of the volume, R row tiles of the
image. Run as one command, a verb starts the ranks itself, rank r on card
r over NCCL (with ``--device cpu`` on the CPU over gloo); under
``torchrun`` it joins the group it is given. The mesh's first rank gathers
the slabs and writes the outputs, byte-equal with the verb's without
``--devices``.

Every verb but ``convert`` takes ``--device`` (default ``cuda``). On a
CUDA device every integration (depth, or depth + colour with
--fuse-color), raycast, bilateral filter and lane gather a verb makes is
the CUDA kernel (``icp`` launches the raycast kernel alone: its exact
association makes no lane gather; ``sfusion`` launches, per frame after
the first, the lane gather four times in the masked surface extraction,
the row gather once for the correspondences and the warped integrate
once, and the lane gather four more times for the final mesh); the
colour render, the per-vertex colours and ``view``'s heat maps are plain
PyTorch on the volume's device, as they are plain XLA or numpy in the
JAX package; ``--device cpu`` runs the kernels' plain PyTorch twins.
``--device cuda`` without a card raises.

``fuse --profile DIR`` and ``sfusion --profile DIR`` (one device) write a
``torch.profiler`` trace of the run into DIR, with the program's spans
(``utils.profiling.trace``) over its kernels, and the program's counters
into ``DIR/counters.json``.

Run as ``python -m tsdf_tpu_torch <verb> ...``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import math
import os
import sys
import time

import numpy as np
import torch

def resolve_device(name: str) -> torch.device:
    """The torch device for ``--device``; a CUDA device without a card
    raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: torch.cuda.is_available() is False"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"--device {name}: only cpu and cuda are supported")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _make_camera(args, device):
    from .camera import Camera

    return Camera.from_intrinsics(
        args.fx, args.fy, args.cx, args.cy, device=device
    )


def _add_camera_args(p):
    p.add_argument("--fx", type=float, default=591.1)
    p.add_argument("--fy", type=float, default=590.1)
    p.add_argument("--cx", type=float, default=331.0)
    p.add_argument("--cy", type=float, default=234.6)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)


def _add_device_arg(p):
    p.add_argument(
        "--device", default="cuda",
        help="cuda (the kernels) or cpu (their plain twins)",
    )


def _add_profile_arg(p):
    p.add_argument(
        "--profile", metavar="DIR",
        help="write a torch.profiler trace of the run (the program's spans "
        "and, on a card, its kernels; open it in Perfetto) and the "
        "program's counters, counters.json, into DIR; one device only",
    )


def _profiled(args, run) -> int:
    """``run()``; with ``--profile DIR`` under ``profile_to(DIR)`` with
    the program's counters open, their totals then written to
    ``DIR/counters.json``."""
    if not args.profile:
        return run()
    from .utils import profiling

    with profiling.counting() as counts:
        with profiling.profile_to(args.profile):
            rc = run()
    with open(os.path.join(args.profile, "counters.json"), "w") as f:
        json.dump(counts.totals(), f, indent=1)
        f.write("\n")
    print(f"wrote a trace and counters.json into {args.profile}")
    return rc


def _check_profile(args) -> bool:
    """False, with the reason on stderr, for ``--profile`` on a mesh."""
    if args.profile and args.devices:
        print("--profile traces one device; drop --devices", file=sys.stderr)
        return False
    return True


def _add_pallas_arg(p):
    p.add_argument(
        "--pallas", action="store_true",
        help="no effect: accepted for the JAX CLI's command lines, where it "
        "selects the TPU kernels; here the device picks kernel or twin",
    )


def _render_outputs(vol, camera, args):
    from .api import raycast
    from .io.png import save_png
    from .ops.shading import color_image, normals_image, scene_image

    verts, normals = raycast(vol, camera, width=args.width, height=args.height)
    if args.scene:
        img = scene_image(verts, normals, camera.position)
        save_png(args.scene, img.cpu().numpy())
        print(f"wrote {args.scene}")
    if args.normals:
        save_png(args.normals, normals_image(normals).cpu().numpy())
        print(f"wrote {args.normals}")
    if args.color:
        save_png(args.color, color_image(vol, verts).cpu().numpy())
        print(f"wrote {args.color}")


def _write_mesh(vol, path, max_cubes, max_vertices, color=False):
    from .io.ply import write_ply
    from .ops.marching_cubes import (
        extract_surface,
        sample_color_at,
        soup_to_numpy,
    )

    soup = extract_surface(vol, max_cubes=max_cubes, max_vertices=max_vertices)
    if bool(soup.overflowed):
        print(
            "warning: mesh buffers overflowed; rerun with larger "
            "--max-cubes/--max-vertices",
            file=sys.stderr,
        )
    verts, tris = soup_to_numpy(soup)
    colors = None
    if color:
        if vol.color is None:
            print(
                "warning: --color requested but the volume has no "
                "colour field (fuse with --fuse-color); writing "
                "position-only PLY",
                file=sys.stderr,
            )
        else:
            colors = sample_color_at(vol, verts)
    write_ply(path, verts, tris, colors=colors)
    print(f"wrote {path} ({len(verts)} vertices, {len(tris)} triangles)")


def cmd_fuse(args):
    if args.fuse_color and args.track and args.devices:
        print(
            "--fuse-color --track --devices is not supported "
            "(tracked colour runs single-device); drop --devices",
            file=sys.stderr,
        )
        return 1
    if not _check_profile(args):
        return 1
    if args.devices:
        shape = _mesh_shape(args)
        return 1 if shape is None else _on_mesh(args, _fuse, shape)
    device = resolve_device(args.device)
    return _profiled(args, lambda: _fuse(args, device))


def _mesh_shape(args):
    """(B, R) of ``--devices BxR``; None, with the reason on stderr, when
    it is malformed or B does not divide ``--size``."""
    b, _, r = args.devices.partition("x")
    try:
        nb, nr = int(b), int(r or 1)
    except ValueError:
        nb = nr = 0
    if nb < 1 or nr < 1:
        print(f"--devices must be BxR with B, R >= 1 (got {args.devices!r})",
              file=sys.stderr)
        return None
    if args.size % nb:
        print(f"--size {args.size} must be divisible by the brick axis ({nb})",
              file=sys.stderr)
        return None
    return nb, nr


def _on_mesh(args, verb, shape):
    """A verb on a mesh of B x R ranks (``--devices BxR``): join the group
    ``torchrun`` describes, or start B x R local ranks, one a card over
    NCCL (the kernels built first, once), or on the CPU over gloo with
    ``--device cpu``. Each rank runs ``verb(args, device, mesh)``; what the
    mesh's first rank prints is printed, and its exit code returned."""
    from .parallel.distributed import initialize, launch

    nb, nr = shape
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize(backend="nccl" if device.type == "cuda" else "gloo")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device.type == "cuda" else device)
        rc, text = _mesh_rank(dev, verb, args, nb, nr)
        print(text, end="")
        return rc
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if nb * nr > cards:
            print(
                f"--devices {args.devices} needs {nb * nr} cards; "
                f"{cards} visible (ranks are not stacked on one card)",
                file=sys.stderr,
            )
            return 1
        from .kernels._build import library

        library()
    rc, text = launch(_mesh_rank, nb * nr, (verb, args, nb, nr),
                      device="cuda" if device.type == "cuda" else "cpu")[0]
    print(text, end="")
    return rc


def _mesh_rank(device, verb, args, nb, nr):
    """One rank of a verb on the mesh: (exit code, what the mesh's first
    rank printed; every other rank prints nothing)."""
    import torch.distributed as dist

    from .parallel import make_mesh

    mesh = make_mesh(nb, nr, device=device)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = verb(args, device, mesh)
    return rc, (text.getvalue() if dist.get_rank() == mesh.ranks[0] else "")


def _fuse(args, device, mesh=None):
    """The fuse verb on ``device``, on one card or, with ``mesh``, on
    this rank's slab of the mesh."""
    from .io.tum import TUMDataLoader
    from .pipelines.kinfu import (
        FusionConfig,
        fuse_frames,
        track_and_fuse_frames,
    )

    cfg = FusionConfig(
        volume_size=(args.size,) * 3,
        physical_size_mm=args.physical,
        use_bilateral_filter=args.filter,
        width=args.width,
        height=args.height,
        icp_conv_eps=args.icp_eps,
    )
    if mesh is None:
        vol = cfg.make_volume(device=device)
    else:
        from .parallel.ops import make_sharded_volume

        vol = make_sharded_volume(mesh, cfg.volume_size, cfg.physical_size_mm,
                                  offset=cfg.offset_mm)
    if args.fuse_color:
        vol = vol.with_color()
    camera = _make_camera(args, device)

    loader = TUMDataLoader(args.dir)
    n = args.frames if args.frames > 0 else len(loader)
    if n <= 0 or len(loader) == 0:
        print(
            f"no frames found in {args.dir} (check ground_truth.txt and "
            "depth/<stamp>.png files)",
            file=sys.stderr,
        )
        return 1
    first_pose = torch.as_tensor(loader.entries[0][1], device=device)
    where = device if mesh is None else f"a {args.devices} mesh"
    print(f"fusing {n} frames at {args.size}^3 on {where} ...")

    gt_poses = []

    def stream(with_pose):
        # with --fuse-color every frame carries its rgb image, or None
        # where rgb/<stamp>.png is missing: a GT-pose frame without one
        # fuses depth only, the tracked loop wants all or none
        source = loader.iter_with_rgb() if args.fuse_color else loader
        for depth_img, pose, *rgb in itertools.islice(source, n):
            gt_poses.append(pose)
            # u16 mm, as loaded: a filter on the fused depth rounds back
            # to u16; both pipelines convert to float32 on the device
            frame = [torch.from_numpy(depth_img.data).to(device)]
            if with_pose:
                frame.append(torch.as_tensor(pose, device=device))
            if args.fuse_color:
                (rgb,) = rgb
                frame.append(
                    None if rgb is None else torch.from_numpy(rgb).to(device)
                )
            yield tuple(frame) if len(frame) > 1 else frame[0]

    _sync(device)
    t0 = time.perf_counter()
    if args.track:
        camera = camera.set_pose(first_pose)
        if mesh is None:
            vol, camera, poses, stats = track_and_fuse_frames(
                vol, camera, stream(False), cfg
            )
        else:
            from .parallel.ops import track_and_fuse_frames_sharded

            vol, camera, poses, stats = track_and_fuse_frames_sharded(
                vol, camera, stream(False), mesh,
                use_bilateral_filter=cfg.use_bilateral_filter,
                band=cfg.icp_band or None, width=cfg.width, height=cfg.height,
                conv_eps=cfg.icp_conv_eps,
            )
    else:
        # on the mesh, each rank fuses its slab: no collective
        vol, camera = fuse_frames(vol, camera, stream(True), cfg)
    _sync(device)
    seconds = time.perf_counter() - t0
    if mesh is not None:
        from .parallel.ops import unshard_volume

        vol = unshard_volume(vol, mesh)
        if vol is None:  # the mesh's first rank writes the outputs
            return 0
    on_mesh = "" if mesh is None else f" on {args.devices} mesh"
    if args.track:
        err, inl = stats[-1]
        print(
            f"tracked {len(poses)}{' colour' if args.fuse_color else ''} "
            f"frames{on_mesh}; lastError={float(err):.2f}mm "
            f"lastInliers={int(inl)}"
        )
        # trajectory error against the dataset's ground truth
        if len(gt_poses) == len(poses) and len(poses) >= 2:
            from .utils.trajectory import ate, rpe

            est = [p.cpu().numpy() for p in poses]
            a = ate(est, gt_poses)
            r = rpe(est, gt_poses)
            print(
                f"ATE rmse={a['rmse']:.2f}mm median={a['median']:.2f}mm "
                f"max={a['max']:.2f}mm; RPE trans={r['trans_rmse']:.2f}mm"
                f"/frame rot={r['rot_rmse']*1e3:.2f}mrad/frame"
            )
    elif args.fuse_color:
        print(f"fused {len(gt_poses)} frames with colour{on_mesh}")
    elif mesh is not None:
        print(f"fused {len(gt_poses)} frames{on_mesh}")
    print(
        f"{'tracked and fused' if args.track else 'fused'} {n} frames in "
        f"{seconds:.3f} s ({1000.0 * seconds / n:.2f} ms/frame, PNG decode "
        "included)"
    )

    if args.out:
        from .io.tsdf_file import save_tsdf

        save_tsdf(vol, args.out)
        print(f"wrote {args.out}")

    # render from the first frame's pose
    camera = camera.set_pose(first_pose)
    _render_outputs(vol, camera, args)
    if args.mesh:
        _write_mesh(
            vol, args.mesh, args.max_cubes, args.max_vertices,
            color=args.fuse_color,
        )
    return 0


def cmd_render(args):
    from .io.tsdf_file import load_tsdf

    device = resolve_device(args.device)
    vol = load_tsdf(args.file, device=device)
    camera = _make_camera(args, device)
    if args.look_from:
        camera = camera.move_to([float(v) for v in args.look_from.split(",")])
    if args.look_at:
        camera = camera.look_at([float(v) for v in args.look_at.split(",")])
    _render_outputs(vol, camera, args)
    return 0


def cmd_icp(args):
    from .api import render_to_depth_image
    from .io.png import load_png
    from .io.tsdf_file import load_tsdf
    from .tracking.icp import get_incremental_transformation
    from .utils.se3 import euler_to_matrix

    device = resolve_device(args.device)
    vol = load_tsdf(args.volume, device=device)
    depth = load_png(args.depth).astype(np.float32)
    if args.depth_scale != 1.0:
        depth = depth * args.depth_scale

    camera = _make_camera(args, device)
    # the camera pose is the inverse of the volume's global rotation and
    # translation
    pose = torch.eye(4, dtype=torch.float32, device=device)
    pose[0:3, 0:3] = euler_to_matrix(vol.global_rotation)
    pose[0:3, 3] = vol.global_translation
    camera = camera.set_pose(torch.linalg.inv_ex(pose).inverse)

    model_depth = render_to_depth_image(
        vol, camera, width=args.width, height=args.height
    )
    res = get_incremental_transformation(
        torch.from_numpy(depth).to(device), model_depth,
        args.fx, args.fy, args.cx, args.cy,
    )
    np.set_printoptions(suppress=True, precision=5)
    print("incremental transformation (T_prev_curr):")
    print(res.pose.cpu().numpy())
    print(
        f"lastError={float(res.error):.3f}mm "
        f"lastInliers={int(res.inliers)}"
    )
    return 0


def _flow_provider(args):
    """The scene-flow provider of ``sfusion``'s arguments, initialised;
    None, with the reason on stderr, when the directory holds no files."""
    from .io.sceneflow import PDSFMockSceneFlow, SRSFMockSceneFlow

    sfa_cls = (
        SRSFMockSceneFlow if args.flow_format == "srsf" else PDSFMockSceneFlow
    )
    sfa = sfa_cls(args.flow_dir)
    if not sfa.init():
        print(f"no scene-flow files found in {args.flow_dir}", file=sys.stderr)
        return None
    return sfa


def cmd_sfusion(args):
    if not _check_profile(args):
        return 1
    shape = None
    if args.devices:
        shape = _mesh_shape(args)
        if shape is None:
            return 1
    if _flow_provider(args) is None:
        return 1
    if shape is not None:
        return _on_mesh(args, _sfusion, shape)
    device = resolve_device(args.device)
    return _profiled(args, lambda: _sfusion(args, device))


def _sfusion(args, device, mesh=None):
    """The sfusion verb on ``device``, on one card or, with ``mesh``,
    brick-parallel on this rank's slab (each rank reads the files itself;
    the mesh's first rank writes the mesh)."""
    from .io.mock_kinect import MockKinect
    from .io.ply import write_ply
    from .ops.marching_cubes import soup_to_numpy
    from .pipelines.scenefusion import SceneFusion, SceneFusionConfig

    sfa = _flow_provider(args)
    rgbd = MockKinect(args.rgbd_dir)
    rgbd.initialise()
    cfg = SceneFusionConfig(
        volume_size=(args.size,) * 3,
        physical_size_mm=args.physical,
        offset_mm=(-args.physical / 2, -args.physical / 2, 0.0),
        max_cubes=args.max_cubes,
    )
    sf = SceneFusion(
        sfa, rgbd, cfg, camera=_make_camera(args, device), mesh=mesh,
        device=device,
    )
    rgbd.start()
    print(f"processed {sf.frame_index} frames")
    if args.mesh:
        soup = sf.extract_mesh()  # on a mesh, None but on its first rank
        if soup is not None:
            verts, tris = soup_to_numpy(soup)
            write_ply(args.mesh, verts, tris)
            print(f"wrote {args.mesh} ({len(verts)} vertices)")
    return 0


def heat_map(tsdf: torch.Tensor, trunc: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 heat map of distances: blue (negative) -> white (zero)
    -> red (positive), in float32 throughout. ``trunc`` is a 0-d float32
    tensor: dividing by a tensor keeps the division IEEE on the card,
    where a Python scalar divisor becomes a multiplication by its
    reciprocal."""
    t = torch.clamp(tsdf / trunc, -1.0, 1.0)
    chans = (
        (1 + torch.clamp(t, max=0.0)) * 255,
        (1 - t.abs()) * 255,
        (1 - torch.clamp(t, min=0.0)) * 255,
    )
    return torch.stack(
        [torch.clamp(c, 0, 255).to(torch.uint8) for c in chans], dim=-1
    )


def view_tiles(vol) -> list[tuple[str, torch.Tensor]]:
    """The ``view`` verb's three tiles on the volume's device: the heat
    maps of the slices along y ("top"), x ("right") and z ("front"), laid
    out row by row in a grid of ceil(sqrt(n)) columns, unused cells
    black."""
    heat = heat_map(vol.tsdf, vol.truncation_distance.to(torch.float32))
    tiles = []
    for name, axis in (("top", 1), ("right", 2), ("front", 0)):
        slices = heat.movedim(axis, 0)  # (n, h, w, 3)
        n, h, w, _ = slices.shape
        cols = int(math.ceil(math.sqrt(n)))
        rows = int(math.ceil(n / cols))
        grid = torch.zeros(
            (rows * cols, h, w, 3), dtype=torch.uint8, device=heat.device
        )
        grid[:n] = slices
        tiles.append((
            name,
            grid.reshape(rows, cols, h, w, 3).permute(0, 2, 1, 3, 4)
            .reshape(rows * h, cols * w, 3),
        ))
        del grid
    return tiles


def cmd_view(args):
    """Heat-map tiles of a .tsdf's distance field, computed on the device;
    each tile is copied to the host once and written as a PNG."""
    from .io.png import save_png
    from .io.tsdf_file import load_tsdf

    device = resolve_device(args.device)
    vol = load_tsdf(args.file, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, tile in view_tiles(vol):
        path = os.path.join(args.out_dir, f"{name}.png")
        save_png(path, tile.cpu().numpy())
        print(f"wrote {path}")
    return 0


def cmd_convert(args):
    from .io.convert import fl_2_uchar, freenect2png, pgm2png

    if args.kind == "freenect2png":
        freenect2png(args.input, args.output)
    elif args.kind == "fl2uchar":
        lo, hi = fl_2_uchar(args.input, args.output)
        print(f"Min: {lo:f}, Max : {hi:f}")
    else:
        pgm2png(args.input, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_mesh(args):
    from .io.tsdf_file import load_tsdf

    device = resolve_device(args.device)
    vol = load_tsdf(args.file, device=device)
    _write_mesh(
        vol, args.out, args.max_cubes, args.max_vertices, color=args.color
    )
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="tsdf_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fuse", help="fuse TUM depth frames into a volume")
    p.add_argument("-d", "--dir", required=True, help="TUM dataset dir")
    p.add_argument("-m", "--frames", type=int, default=0, help="frame count")
    p.add_argument("-s", "--size", type=int, default=200)
    p.add_argument("--physical", type=float, default=3000.0)
    p.add_argument("--track", action="store_true", help="ICP tracking")
    p.add_argument(
        "--filter", action="store_true",
        help="bilateral prefilter (the tracker's input with --track, the "
        "fused depth without)",
    )
    _add_pallas_arg(p)
    p.add_argument(
        "--icp-eps", type=float, default=0.0,
        help="ICP early-exit threshold on the per-iteration update "
        "(|v| mm + 1000*|w| rad); 0 = the full 10/5/4 schedule",
    )
    p.add_argument(
        "--fuse-color", action="store_true",
        help="fuse rgb/<stamp>.png frames into per-voxel colour (with the "
        "ground-truth poses, or with --track at the tracked poses)",
    )
    p.add_argument(
        "--devices",
        help="BxR: fuse on a mesh of B z-slabs x R row tiles, one rank "
        "(card) each",
    )
    p.add_argument("-o", "--out", help="output .tsdf")
    p.add_argument("--scene", default="scene.png")
    p.add_argument("--normals", default="normals.png")
    p.add_argument("--color", help="colour render PNG (needs a colour volume)")
    p.add_argument("--mesh", default="mesh.ply")
    p.add_argument("--max-cubes", type=int, default=1 << 18)
    p.add_argument("--max-vertices", type=int, default=1 << 20)
    _add_profile_arg(p)
    _add_device_arg(p)
    _add_camera_args(p)
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("render", help="raycast a .tsdf to images")
    p.add_argument("-f", "--file", required=True)
    p.add_argument("--scene", default="scene.png")
    p.add_argument("--normals", default="normals.png")
    p.add_argument("--color", help="colour render PNG (needs a colour volume)")
    p.add_argument("--look-from", help="x,y,z mm")
    p.add_argument("--look-at", help="x,y,z mm")
    _add_pallas_arg(p)
    _add_device_arg(p)
    _add_camera_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("mesh", help="marching cubes a .tsdf to PLY")
    p.add_argument("-f", "--file", required=True)
    p.add_argument("-o", "--out", default="mesh.ply")
    p.add_argument("--max-cubes", type=int, default=1 << 18)
    p.add_argument("--max-vertices", type=int, default=1 << 20)
    p.add_argument(
        "--color", action="store_true",
        help="per-vertex RGB sampled from the fused colour volume",
    )
    _add_device_arg(p)
    p.set_defaults(fn=cmd_mesh)

    p = sub.add_parser("view", help="slice heat-maps of a .tsdf")
    p.add_argument("-f", "--file", required=True)
    p.add_argument("-o", "--out-dir", default="tsdf_view")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("icp", help="pose of a depth frame vs a .tsdf")
    p.add_argument("-v", "--volume", required=True)
    p.add_argument("-d", "--depth", required=True)
    p.add_argument("--depth-scale", type=float, default=1.0)
    _add_device_arg(p)
    _add_camera_args(p)
    p.set_defaults(fn=cmd_icp)

    p = sub.add_parser("sfusion", help="non-rigid fusion (SceneFusion)")
    p.add_argument("rgbd_dir")
    p.add_argument("flow_dir")
    p.add_argument("--flow-format", choices=("pdflow", "srsf"),
                   default="pdflow")
    p.add_argument("-s", "--size", type=int, default=255)
    p.add_argument("--physical", type=float, default=2550.0)
    p.add_argument("--mesh", default="mesh.ply")
    # surface-cube capacity: scale down with --size for small volumes
    p.add_argument("--max-cubes", type=int, default=1 << 18)
    p.add_argument(
        "--devices",
        help="BxR: brick-parallel on a mesh of B z-slabs x R row tiles, one "
        "rank (card) each; B must divide --size (the default 255: B of 1, 3, "
        "5, 15, 17, ...)",
    )
    _add_profile_arg(p)
    _add_device_arg(p)
    _add_camera_args(p)
    p.set_defaults(fn=cmd_sfusion)

    p = sub.add_parser("convert", help="format converters")
    p.add_argument("kind", choices=("freenect2png", "pgm2png", "fl2uchar"))
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_convert)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
