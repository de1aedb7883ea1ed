"""The port's brick-parallel SceneFusion class (``SceneFusion(mesh=)``)
and ``sfusion --devices BxR`` on gloo ranks on the CPU, against the JAX
package's ``SceneFusion(..., mesh=make_mesh(4, 2))`` and ``sfusion
--devices 4x2`` on the virtual 8-device mesh of tests/conftest.py, and
against the port's single-volume class and verb.

The scene is the fixture of tests/test_cli.py:336 (a 48^3 / 1500 mm sphere
rendered from (0, 0, -200) at 160x120, whole-millimetre PD-Flow files of
+5 mm in x), here three frames long so that two deformation updates run.
The class runs on four spawned ranks as mesh 4x1 and then 2x2 in one
spawn; the verb spawns its own ranks (2x1 and 4x1). Rank bodies import no
JAX.

Gates:
  * the gathered volume against JAX's sharded class: deform within
    1e-4 mm, tsdf within 1e-3 mm, weights within 1e-5 (the SceneFusion
    frame's tolerances in tests/test_torch_parallel_nonrigid.py);
  * against the port's single-volume class: tsdf, weight and deform bit
    for bit, the correspondence counts equal (whole-millimetre flows make
    every sum of the update exact), the ``extract_mesh`` soup and the
    three ``dump`` files byte-equal;
  * the verb: stdout and PLY byte-equal with ``sfusion --device cpu``;
    against JAX's ``--devices 4x2``: rc 0, vertex count within 1 %, mean
    vertex within 0.5 mm (tests/test_torch_scenefusion.py:540-552).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tsdf_tpu_torch.cli import main as torch_main
from tsdf_tpu_torch.parallel.distributed import launch

W, H = 160, 120
FX, FY, CX, CY = 591.1 / 4, 590.1 / 4, 331.0 / 4, 234.6 / 4
N_FRAMES = 3
MAX_CUBES = 1 << 12
ARGS = ["-s", "48", "--physical", "1500", "--max-cubes", str(MAX_CUBES),
        "--fx", str(FX), "--fy", str(FY), "--cx", str(CX), "--cy", str(CY),
        "--width", str(W), "--height", str(H)]
MESHES = ((4, 1), (2, 2))
DUMPS = ["frame_000.tsdf", "frame_002.tsdf", "mesh_canonical_000.ply",
         "mesh_canonical_002.ply", "mesh_warped_000.ply", "mesh_warped_002.ply"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_cli.py:336's RGB-D + PD-Flow directory, three frames."""
    from tsdf_tpu import Camera, make_volume
    from tsdf_tpu.io.png import save_png
    from tsdf_tpu.ops.raycast import render_to_depth_image
    from tsdf_tpu.utils import fixtures

    root = tmp_path_factory.mktemp("sf_data")
    vol = make_volume((48,) * 3, 1500.0, offset=(-750.0, -750.0, 0.0),
                      with_deformation=True)
    vol = fixtures.sphere_tsdf(vol, 300.0, centre=(0.0, 0.0, 750.0))
    cam = (Camera.from_intrinsics(FX, FY, CX, CY)
           .move_to([0.0, 0.0, -200.0]).look_at([0.0, 0.0, 750.0]))
    depth = np.asarray(
        render_to_depth_image(vol, cam, width=W, height=H)).astype(np.uint16)
    rows = "\n".join(f"{y} {x} 0.0 0.005 0.0"
                     for y in range(H) for x in range(W)) + "\n"
    for i in range(N_FRAMES):
        save_png(root / f"depth_{i:05d}.png", depth)
        (root / f"sflow_{i:05d}_results01.txt").write_text(rows)
    return str(root)


def _config():
    from tsdf_tpu_torch.pipelines.scenefusion import SceneFusionConfig

    return SceneFusionConfig(volume_size=(48,) * 3, physical_size_mm=1500.0,
                             offset_mm=(-750.0, -750.0, 0.0),
                             max_cubes=MAX_CUBES, max_vertices=1 << 16)


def _run_class(data, dump_dir, device, mesh=None):
    """The port's class on ``data`` with a dump every second frame: the
    class, its soup (None off the mesh's first rank)."""
    from tsdf_tpu_torch import Camera
    from tsdf_tpu_torch.io.mock_kinect import MockKinect
    from tsdf_tpu_torch.io.sceneflow import PDSFMockSceneFlow
    from tsdf_tpu_torch.pipelines.scenefusion import SceneFusion

    sfa = PDSFMockSceneFlow(data)
    assert sfa.init()
    rgbd = MockKinect(data)
    rgbd.initialise()
    sf = SceneFusion(sfa, rgbd, _config(), dump_every=2, dump_dir=dump_dir,
                     mesh=mesh, device=device,
                     camera=Camera.from_intrinsics(FX, FY, CX, CY,
                                                   device=device))
    rgbd.start()
    return sf, sf.extract_mesh()


def _summary(sf, vol, soup) -> dict:
    from tsdf_tpu_torch.ops.marching_cubes import soup_to_numpy

    verts, tris = soup_to_numpy(soup)
    return {"tsdf": vol.tsdf.numpy(), "weight": vol.weight.numpy(),
            "deform": vol.deform.numpy(), "verts": verts, "tris": tris,
            "n_corr": [int(n) for n in sf.correspondence_counts]}


def _rank_body(dev, data, out_dir):
    """Four ranks: the class on each mesh of MESHES; the mesh's first rank
    returns the gathered volume and the soup, every other rank whether its
    ``extract_mesh`` gave None."""
    import torch.distributed as dist

    from tsdf_tpu_torch.parallel import make_mesh
    from tsdf_tpu_torch.parallel.ops import unshard_volume

    torch.set_num_threads(1)
    out = {}
    for nb, nr in MESHES:
        mesh = make_mesh(nb, nr, device=dev)
        shape = f"{nb}x{nr}"
        sf, soup = _run_class(data, os.path.join(out_dir, shape), dev, mesh)
        whole = unshard_volume(sf.volume, mesh)
        if dist.get_rank() == mesh.ranks[0]:
            out[shape] = _summary(sf, whole, soup)
            out[shape]["slab"] = type(sf.volume).__name__
        else:
            out[shape] = soup is None and whole is None
    return out


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("sf_mesh_dumps"))
    got = launch(_rank_body, 4, (data, out_dir), backend="gloo", device="cpu")
    return got, out_dir


@pytest.fixture(scope="module")
def single(data, tmp_path_factory):
    """The port's single-volume class on the same files, and its dumps."""
    dump_dir = str(tmp_path_factory.mktemp("sf_single_dumps"))
    sf, soup = _run_class(data, dump_dir, torch.device("cpu"))
    return _summary(sf, sf.volume, soup), dump_dir


@pytest.fixture(scope="module")
def jax_sharded(data):
    """JAX's SceneFusion on its 4x2 mesh of the 8 CPU devices."""
    import jax

    from tsdf_tpu import Camera
    from tsdf_tpu.io.mock_kinect import MockKinect
    from tsdf_tpu.io.sceneflow import PDSFMockSceneFlow
    from tsdf_tpu.parallel import make_mesh
    from tsdf_tpu.pipelines.scenefusion import SceneFusion, SceneFusionConfig

    sfa = PDSFMockSceneFlow(data)
    assert sfa.init()
    device = MockKinect(data)
    device.initialise()
    cfg = SceneFusionConfig(volume_size=(48,) * 3, physical_size_mm=1500.0,
                            offset_mm=(-750.0, -750.0, 0.0),
                            max_cubes=MAX_CUBES)
    mesh = make_mesh(n_bricks=4, n_rays=2, devices=jax.devices()[:8])
    sf = SceneFusion(sfa, device, cfg,
                     camera=Camera.from_intrinsics(FX, FY, CX, CY), mesh=mesh)
    device.start()
    assert sf.frame_index == N_FRAMES
    return {f: np.asarray(getattr(sf.volume, f))
            for f in ("tsdf", "weight", "deform")}


# -- the class -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [f"{nb}x{nr}" for nb, nr in MESHES])
def test_mesh_class_matches_the_jax_sharded_class(ranks, jax_sharded, shape):
    got = ranks[0][0][shape]
    assert got["slab"] == "SlabVolume"
    np.testing.assert_allclose(got["deform"], jax_sharded["deform"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["tsdf"], jax_sharded["tsdf"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["weight"], jax_sharded["weight"], rtol=0,
                               atol=1e-5)
    assert got["weight"].max() == N_FRAMES
    moved = got["deform"][..., 0] - jax_sharded["deform"][..., 0]
    assert np.abs(moved).max() <= 1e-4


@pytest.mark.parametrize("shape", [f"{nb}x{nr}" for nb, nr in MESHES])
def test_mesh_class_is_the_single_class_bit_for_bit(ranks, single, shape):
    got = ranks[0][0][shape]
    want, _ = single
    for f in ("tsdf", "weight", "deform"):
        assert got[f].tobytes() == want[f].tobytes(), f
    assert got["n_corr"] == want["n_corr"] and min(want["n_corr"]) > 100
    # the front cap moved by the two 5 mm flows
    centres = _single_centres()
    assert abs((got["deform"][..., 0] - centres).max() - 10.0) < 1e-3
    # every other rank: extract_mesh and the gather give None
    assert all(r[shape] is True for r in ranks[0][1:])


def _single_centres():
    vol = _config().make_volume(device=torch.device("cpu"))
    return vol.voxel_centres()[..., 0].numpy()


@pytest.mark.parametrize("shape", [f"{nb}x{nr}" for nb, nr in MESHES])
def test_mesh_class_mesh_and_dumps_equal_the_single_class(ranks, single, shape):
    got = ranks[0][0][shape]
    want, single_dumps = single
    assert got["verts"].tobytes() == want["verts"].tobytes()
    assert np.array_equal(got["tris"], want["tris"]) and len(got["verts"]) > 300
    mesh_dumps = os.path.join(ranks[1], shape)
    assert sorted(os.listdir(mesh_dumps)) == sorted(
        os.listdir(single_dumps)) == DUMPS
    for name in DUMPS:
        with open(os.path.join(mesh_dumps, name), "rb") as a, open(
                os.path.join(single_dumps, name), "rb") as b:
            assert a.read() == b.read(), name


# -- the verb --------------------------------------------------------------------


def _verb(data, out, extra=()):
    """(exit code, stdout, PLY bytes) of the port's verb writing ``out``."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = torch_main(["sfusion", data, data, *ARGS, "--mesh", out,
                         "--device", "cpu", *extra])
    with open(out, "rb") as f:
        ply = f.read()
    os.remove(out)
    return rc, text.getvalue(), ply


@pytest.fixture(scope="module")
def single_verb(data, tmp_path_factory):
    """The verb without --devices, and the path every run writes."""
    out = str(tmp_path_factory.mktemp("sf_verb") / "mesh.ply")
    rc, text, ply = _verb(data, out)
    assert rc == 0
    return out, text, ply


@pytest.mark.parametrize("devices", ["2x1", "4x1"])
def test_sfusion_devices_is_byte_equal_with_the_single_verb(
        data, single_verb, tmp_path, devices):
    out, want_text, want_ply = single_verb
    rc, text, ply = _verb(data, out, ["--devices", devices])
    assert rc == 0
    assert text == want_text
    assert text.splitlines()[0] == f"processed {N_FRAMES} frames"
    assert ply == want_ply
    if devices == "4x1":
        with open(tmp_path / "port.ply", "wb") as f:
            f.write(ply)
        _against_the_jax_verb(data, str(tmp_path / "port.ply"), tmp_path)


def _ply_vertices(path):
    """The (n, 3) vertices of an ASCII PLY."""
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines.index("end_header")
    (n,) = [int(ln.split()[2]) for ln in lines[:head]
            if ln.startswith("element vertex")]
    return np.array([ln.split()[:3] for ln in lines[head + 1:head + 1 + n]],
                    np.float64).reshape(-1, 3)


def _against_the_jax_verb(data, ply, tmp_path):
    """The port's --devices 4x1 against JAX's --devices 4x2 on the same
    files: the meshes are of volumes equal under the frame's gate."""
    from tsdf_tpu.cli import main as jax_main

    jout = str(tmp_path / "jax.ply")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = jax_main(["sfusion", data, data, *ARGS, "--devices", "4x2",
                       "--mesh", jout])
    assert rc in (0, None)
    verts, jverts = _ply_vertices(ply), _ply_vertices(jout)
    assert abs(len(jverts) - len(verts)) <= 0.01 * len(verts)
    np.testing.assert_allclose(verts.mean(0), jverts.mean(0), atol=0.5)
