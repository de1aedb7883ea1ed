"""The port's GT-pose slice end to end vs the JAX CLI, and the port's
independence from JAX.

The synthetic TUM directory is the one tests/test_cli.py builds: three
160x120 depth frames raycast from a wall-and-sphere volume. Both CLIs
fuse it (``tsdf_tpu.cli`` on the lax path, ``tsdf_tpu_torch.cli`` with
``--device cpu``, i.e. the plain twins) and the outputs are compared:

  * .tsdf: weights equal on >= 99.9% of voxels, tsdf within 5e-3 mm
    where they agree (the integrate gate);
  * scene.png / normals.png: tests/test_golden.py's tolerance;
  * mesh vertex count: within 1% (a voxel whose weight differs at a
    half-pixel sliver can change a cube's triangulation);
  * render/mesh verbs on one .tsdf: images at the golden tolerance, PLY
    vertices within 1e-4 mm or two float32 ulps, faces equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from tsdf_tpu import Camera as JaxCamera, make_volume as jax_make_volume
from tsdf_tpu.cli import main as jax_main
from tsdf_tpu.io.png import load_png, save_png
from tsdf_tpu.io.tsdf_file import load_tsdf
from tsdf_tpu.ops.raycast import render_to_depth_image
from tsdf_tpu.utils import fixtures as jax_fixtures
from tsdf_tpu_torch.cli import main as torch_main

W, H = 160, 120
CAM_ARGS = [
    "--fx", "147.775", "--fy", "147.525",
    "--cx", "82.75", "--cy", "58.65",
    "--width", str(W), "--height", str(H),
]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    (d / "depth").mkdir()
    vol = jax_make_volume((48, 48, 48), 2000.0, offset=(-1000.0, -1000.0, 0.0))
    wall = jax_fixtures.wall_tsdf(vol, 1500.0)
    s1 = jax_fixtures.sphere_tsdf(vol, 380.0, centre=(150.0, -100.0, 900.0))
    scene = vol.replace(tsdf=jnp.minimum(wall.tsdf, s1.tsdf),
                        weight=jnp.ones_like(vol.weight))
    lines = []
    for i in range(3):
        t = i / 2.0
        cam = (JaxCamera.from_intrinsics(147.775, 147.525, 82.75, 58.65)
               .move_to([30.0 * t, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]))
        depth_mm = np.asarray(render_to_depth_image(scene, cam, width=W,
                                                    height=H))
        save_png(d / "depth" / f"{i}.0.png", (depth_mm * 5).astype(np.uint16))
        pose = np.asarray(cam.pose)
        tx, ty, tz = pose[:3, 3] / 1000.0
        r = pose[:3, :3]
        qw = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
        qx = (r[2, 1] - r[1, 2]) / (4 * qw)
        qy = (r[0, 2] - r[2, 0]) / (4 * qw)
        qz = (r[1, 0] - r[0, 1]) / (4 * qw)
        lines.append(f"{i}.0 {tx} {ty} {tz} {qx} {qy} {qz} {qw}")
    (d / "ground_truth.txt").write_text("\n".join(lines) + "\n")
    return d


def _fuse(main, tum_dir, out, extra=()):
    os.makedirs(out, exist_ok=True)
    paths = {k: os.path.join(out, f) for k, f in (
        ("tsdf", "out.tsdf"), ("scene", "scene.png"),
        ("normals", "normals.png"), ("mesh", "mesh.ply"))}
    rc = main(
        ["fuse", "-d", str(tum_dir), "-m", "3", "-s", "48",
         "--physical", "2000", "-o", paths["tsdf"],
         "--scene", paths["scene"], "--normals", paths["normals"],
         "--mesh", paths["mesh"],
         "--max-cubes", str(1 << 14), "--max-vertices", str(1 << 16)]
        + CAM_ARGS + list(extra)
    )
    assert rc == 0
    return paths


def _ply_vertex_count(path):
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise AssertionError("no vertex element")


def _ply_arrays(path):
    """(vertices (N, 3), faces (M, 3)) of an ASCII PLY."""
    with open(path) as f:
        lines = f.read().splitlines()
    n_v = _ply_vertex_count(path)
    start = lines.index("end_header") + 1
    verts = np.array([l.split() for l in lines[start:start + n_v]], float)
    faces = np.array([l.split()[1:] for l in lines[start + n_v:]], int)
    return verts.reshape(-1, 3), faces.reshape(-1, 3)


def test_slice_matches_jax_cli(tum_dir, tmp_path):
    j = _fuse(jax_main, tum_dir, str(tmp_path / "jax"))
    t = _fuse(torch_main, tum_dir, str(tmp_path / "torch"),
              ["--device", "cpu"])

    vj, vt = load_tsdf(j["tsdf"]), load_tsdf(t["tsdf"])
    wj, wt = np.asarray(vj.weight), np.asarray(vt.weight)
    assert wj.sum() > 0
    same = wj == wt
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(np.asarray(vt.tsdf)[same],
                               np.asarray(vj.tsdf)[same], rtol=0, atol=5e-3)
    for attr in ("physical_size", "offset", "truncation_distance",
                 "max_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(vt, attr)),
                                      np.asarray(getattr(vj, attr)))

    for key in ("scene", "normals"):
        a, b = load_png(j[key]), load_png(t[key])
        assert a.shape == b.shape and a.dtype == b.dtype
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.mean() < 0.5 and (d > 8).mean() < 0.001, (key, d.mean())
    assert load_png(t["scene"]).max() > 50

    nj, nt = _ply_vertex_count(j["mesh"]), _ply_vertex_count(t["mesh"])
    assert nj > 1000
    assert abs(nj - nt) <= 0.01 * nj, (nj, nt)


def test_render_and_mesh_verbs_match_jax(tum_dir, tmp_path):
    t = _fuse(torch_main, tum_dir, str(tmp_path / "fuse"), ["--device", "cpu"])
    for main, tag in ((jax_main, "jax"), (torch_main, "torch")):
        dev = [] if tag == "jax" else ["--device", "cpu"]
        assert main(["render", "-f", t["tsdf"],
                     "--scene", str(tmp_path / f"{tag}_s.png"),
                     "--normals", str(tmp_path / f"{tag}_n.png"),
                     "--look-from", "0,0,-400", "--look-at", "0,0,1000"]
                    + CAM_ARGS + dev) == 0
        assert main(["mesh", "-f", t["tsdf"],
                     "-o", str(tmp_path / f"{tag}.ply"),
                     "--max-cubes", str(1 << 14),
                     "--max-vertices", str(1 << 16)] + dev) == 0
    for name in ("s.png", "n.png"):
        a = load_png(tmp_path / f"jax_{name}")
        b = load_png(tmp_path / f"torch_{name}")
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.mean() < 0.5 and (d > 8).mean() < 0.001, (name, d.mean())
    vj, fj = _ply_arrays(tmp_path / "jax.ply")
    vt, ft = _ply_arrays(tmp_path / "torch.ply")
    assert len(vj) > 1000 and vj.shape == vt.shape
    # same order; within 1e-4 mm or two float32 ulps (the voxel centres
    # are formed by separate ops here, possibly fused in XLA)
    np.testing.assert_allclose(vt, vj, rtol=2.5e-7, atol=1e-4)
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("verb", ["fuse", "render"])
def test_pallas_flag_writes_the_same_bytes(tum_dir, tmp_path, verb):
    """``--pallas``, which selects the TPU kernels in the JAX CLI, is
    accepted by ``fuse`` and ``render`` and changes nothing: a JAX command
    line with it writes the same bytes as without it."""
    src = _fuse(torch_main, tum_dir, str(tmp_path / "src"), ["--device", "cpu"])
    outs = {}
    for tag, extra in (("without", []), ("with", ["--pallas"])):
        d = tmp_path / tag
        if verb == "fuse":
            _fuse(torch_main, tum_dir, str(d), ["--device", "cpu"] + extra)
        else:
            d.mkdir()
            assert torch_main(["render", "-f", src["tsdf"],
                               "--scene", str(d / "scene.png"),
                               "--normals", str(d / "normals.png"),
                               "--look-from", "0,0,-400", "--look-at",
                               "0,0,1000", "--device", "cpu"]
                              + CAM_ARGS + extra) == 0
        outs[tag] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert len(outs["with"]) == (4 if verb == "fuse" else 2)
    assert outs["with"] == outs["without"]


@pytest.mark.parametrize("flag", [["--fuse-color"], []])
def test_fuse_devices_writes_the_single_device_bytes(tum_dir, tmp_path, flag):
    """``fuse --devices 2x1`` (two gloo ranks on the CPU, each fusing its
    z-slab), with or without ``--fuse-color``, writes the same .tsdf, PNG
    and PLY bytes as the verb without ``--devices``: the slabs are the
    single volume's planes bit for bit. The colour run fuses rgb/ frames
    of a gradient added to a copy of the directory."""
    import shutil

    from tsdf_tpu_torch.utils import fixtures

    src = tmp_path / "tum"
    shutil.copytree(tum_dir, src)
    (src / "rgb").mkdir()
    for i in range(3):
        save_png(src / "rgb" / f"{i}.0.png",
                 np.roll(fixtures.gradient_rgb(W, H), 9 * i, axis=1))
    outs = {}
    for tag, devices in (("one", []), ("mesh", ["--devices", "2x1"])):
        d = tmp_path / tag
        d.mkdir()
        argv = ["fuse", "-d", str(src), "-s", "32", "--device", "cpu",
                "-o", str(d / "v.tsdf"), "--scene", str(d / "s.png"),
                "--normals", str(d / "n.png"), "--mesh", str(d / "m.ply"),
                "--max-cubes", str(1 << 14), "--max-vertices", str(1 << 16),
                ] + CAM_ARGS + flag + devices
        if flag:
            argv += ["--color", str(d / "c.png")]
        assert torch_main(argv) == 0
        outs[tag] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert len(outs["one"]) == (5 if flag else 4)
    assert outs["mesh"] == outs["one"]
    if flag:  # the colour was fused
        assert load_png(tmp_path / "one" / "c.png").max() > 0


def test_fuse_devices_tracked_follows_the_single_device_verb(tum_dir, tmp_path,
                                                             capsys):
    """``fuse --devices 2x1 --track --filter`` (the sharded tracked loop on
    two gloo ranks) tracks every frame and prints an ATE within 2 mm of the
    verb's without ``--devices``, the tracked loop's pose gate."""
    base = ["fuse", "-d", str(tum_dir), "-s", "32", "--device", "cpu",
            "--track", "--filter", "--scene", str(tmp_path / "s.png"),
            "--normals", str(tmp_path / "n.png"), "--mesh", ""] + CAM_ARGS
    ates = []
    for devices in ([], ["--devices", "2x1"]):
        capsys.readouterr()
        assert torch_main(base + devices) == 0
        out = capsys.readouterr().out
        assert "tracked 3 frames" in out
        (line,) = [ln for ln in out.splitlines() if ln.startswith("ATE")]
        ates.append(float(line.split("rmse=")[1].split("mm")[0]))
    assert "on 2x1 mesh" in out
    assert abs(ates[1] - ates[0]) < 2.0


def test_fuse_devices_refusals(tum_dir, capsys):
    """A malformed or indivisible ``--devices`` exits 1, for ``fuse`` and
    for ``sfusion``, before any rank starts."""
    base = ["fuse", "-d", str(tum_dir), "--device", "cpu", "-s", "30"]
    assert torch_main(base + ["--devices", "4x1"]) == 1
    assert "divisible" in capsys.readouterr().err
    assert torch_main(base + ["--devices", "twox1"]) == 1
    assert "BxR" in capsys.readouterr().err
    sfusion = ["sfusion", str(tum_dir), str(tum_dir), "--device", "cpu"]
    assert torch_main(sfusion + ["--devices", "twox1"]) == 1
    assert "BxR" in capsys.readouterr().err
    assert torch_main(sfusion + ["--devices", "2x1"]) == 1  # -s 255
    assert "divisible" in capsys.readouterr().err


def test_fuse_frames_integrate_modes():
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.pipelines.kinfu import FusionConfig, fuse_frames
    from tsdf_tpu_torch.utils import fixtures

    cpu = torch.device("cpu")
    cam = Camera.from_intrinsics(147.775, 147.525, 82.75, 58.65, device=cpu)
    pose = cam.move_to([0.0, 0.0, -400.0]).look_at([0.0, 0.0, 1000.0]).pose
    depth = torch.from_numpy(
        fixtures.sphere_depth_map(W, H, 40.0, 800.0, 1600.0).astype(np.float32))
    frames = [(depth, pose)] * 2
    vols = {}
    for mode in ("exact", "line"):
        cfg = FusionConfig(volume_size=(24,) * 3, physical_size_mm=2000.0,
                           offset_mm=(-1000.0, -1000.0, 0.0),
                           integrate_mode=mode)
        vols[mode], last = fuse_frames(cfg.make_volume(device=cpu), cam,
                                       frames, cfg)
        assert torch.equal(last.pose, pose)
    assert float(vols["line"].weight.sum()) > 0
    assert torch.equal(vols["exact"].tsdf, vols["line"].tsdf)
    assert torch.equal(vols["exact"].weight, vols["line"].weight)
    # "fast" runs: the decimated line convention, close to the exact modes
    # but not equal to them
    cfg = FusionConfig(volume_size=(24,) * 3, physical_size_mm=2000.0,
                       offset_mm=(-1000.0, -1000.0, 0.0),
                       integrate_mode="fast")
    vols["fast"], _ = fuse_frames(cfg.make_volume(device=cpu), cam, frames, cfg)
    same = (vols["fast"].weight == vols["exact"].weight).float().mean()
    assert float(vols["fast"].weight.max()) == 2.0 and float(same) > 0.99
    assert not torch.equal(vols["fast"].tsdf, vols["exact"].tsdf)
    cfg = FusionConfig(volume_size=(8,) * 3, integrate_mode="nearest")
    with pytest.raises(ValueError):
        fuse_frames(cfg.make_volume(device=cpu), cam, frames, cfg)


def test_device_cuda_without_card_raises(tum_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["fuse", "-d", str(tum_dir), "-m", "1", "-s", "8",
                    "--scene", str(tmp_path / "s.png"), "--device", "cuda"])
    assert not (tmp_path / "s.png").exists()


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tsdf_tpu'] = None\n"
        "import tsdf_tpu_torch\n"
        "for m in pkgutil.walk_packages(tsdf_tpu_torch.__path__,"
        " 'tsdf_tpu_torch.'):\n"
        "    if m.name != 'tsdf_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "sys.argv = ['tsdf_tpu_torch', 'fuse', '--help']\n"
        "runpy.run_module('tsdf_tpu_torch', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
