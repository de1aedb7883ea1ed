"""The port's Camera transforms vs the JAX package's, on the CPU.

The cases of tests/test_camera.py on the port's camera, then each of the
nine transforms against JAX's on the same camera and the same seeded
inputs.

Tolerance: rounded pixels and the depth-map vertices are equal. A point
or a direction is a float32 product of a 4x4 or 3x3 matrix with the
input, summed in another order by XLA and by PyTorch: each component is
within 2 ulps of the largest magnitude among the point's components (a
component that cancels to near zero cannot be held to its own ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
from tsdf_tpu_torch import Camera

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cam():
    return Camera.default_depth_camera(device=CPU)


def _np(t):
    return t.detach().cpu().numpy()


# -- the cases of tests/test_camera.py ----------------------------------------


def test_default_intrinsics(cam):
    k = _np(cam.k)
    assert k[0, 0] == pytest.approx(591.1)
    assert k[1, 1] == pytest.approx(590.1)
    assert k[0, 2] == pytest.approx(331.0)
    assert k[1, 2] == pytest.approx(234.6)
    assert np.allclose(_np(cam.k_inv) @ k, np.eye(3), atol=1e-5)


def test_identity_pose_position(cam):
    assert np.allclose(_np(cam.position), 0.0)


def test_pixel_to_camera_z_equals_depth(cam):
    pix = torch.tensor([[100.0, 200.0], [331.0, 234.6]])
    depth = torch.tensor([1500.0, 2000.0])
    pts = cam.pixel_to_camera(pix, depth)
    assert torch.equal(pts[:, 2], depth)


def test_principal_point_projects_to_centre(cam):
    pix = cam.world_to_pixel(torch.tensor([0.0, 0.0, 1000.0]))
    assert _np(pix).tolist() == [331.0, 235.0]


def test_pixel_camera_round_trip(cam):
    pix = torch.tensor([[0.0, 0.0], [639.0, 479.0], [320.0, 240.0], [17.0, 400.0]])
    depth = torch.tensor([800.0, 1200.0, 3000.0, 555.0])
    back = cam.camera_to_pixel(cam.pixel_to_camera(pix, depth))
    assert np.allclose(_np(back), _np(pix), atol=1.0)


def _turned_pose():
    pose = np.eye(4, dtype=np.float32)
    pose[0:3, 3] = [100.0, -50.0, 250.0]
    pose[0:3, 0:3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]  # 90 deg about y
    return pose


def test_world_camera_round_trip():
    cam = Camera.default_depth_camera(_turned_pose(), device=CPU)
    pts = torch.tensor([[10.0, 20.0, 30.0], [-500.0, 0.0, 1234.0]])
    rt = cam.camera_to_world(cam.world_to_camera(pts))
    assert np.allclose(_np(rt), _np(pts), atol=1e-2)


def test_move_to(cam):
    cam2 = cam.move_to([1.0, 2.0, 3.0])
    assert np.allclose(_np(cam2.position), [1.0, 2.0, 3.0])
    assert np.allclose(_np(cam2.rotation), _np(cam.rotation))


def test_look_at_straight_ahead(cam):
    cam2 = cam.move_to([0.0, 0.0, -100.0]).look_at([0.0, 0.0, 0.0])
    assert np.allclose(_np(cam2.pose)[0:3, 2], [0.0, 0.0, 1.0], atol=1e-6)


def test_look_at_straight_down(cam):
    # forward is -y: up becomes +z
    cam2 = cam.move_to([0.0, 100.0, 0.0]).look_at([0.0, 0.0, 0.0])
    pose = _np(cam2.pose)
    assert np.allclose(pose[0:3, 2], [0.0, -1.0, 0.0], atol=1e-6)
    assert np.allclose(pose[0:3, 1], [0.0, 0.0, 1.0], atol=1e-6)


def test_look_at_preserves_orthonormality(cam):
    cam2 = cam.move_to([123.0, 45.0, -600.0]).look_at([10.0, -20.0, 400.0])
    r = _np(cam2.rotation)
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_world_to_camera_normal():
    pose = np.eye(4, dtype=np.float32)
    pose[0:3, 0:3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    cam = Camera.default_depth_camera(pose, device=CPU)
    n = cam.world_to_camera_normal(torch.tensor([0.0, 0.0, 1.0]))
    assert np.linalg.norm(_np(n)) == pytest.approx(1.0, abs=1e-6)


def test_depth_map_to_vertices(cam):
    depth = np.zeros((6, 8), np.uint16)
    depth[3, 4] = 1000
    verts, mask = cam.depth_map_to_vertices(depth)
    assert int(mask.sum()) == 1 and mask.dtype == torch.bool
    assert float(verts[3, 4, 2]) == 1000.0
    assert torch.equal(verts[0, 0], torch.zeros(3))


# -- each transform against JAX's ---------------------------------------------


def _cameras():
    """The same camera in both packages: a turned pose aimed off-axis, the
    port's built from the JAX camera's four matrices."""
    j = tsdf_tpu.Camera.default_depth_camera(_turned_pose()).look_at(
        jnp.array([10.0, -20.0, 400.0]))
    t = Camera.from_numpy(
        **{k: np.asarray(getattr(j, k)) for k in ("k", "k_inv", "pose", "pose_inv")},
        device=CPU)
    return j, t


def _inputs():
    rng = np.random.default_rng(1313)
    pixels = rng.uniform(-20.0, 660.0, size=(7, 9, 2)).astype(np.float32)
    depth = rng.uniform(300.0, 6000.0, size=(7, 9)).astype(np.float32)
    points = rng.uniform(-1500.0, 1500.0, size=(7, 9, 3)).astype(np.float32)
    points[..., 2] += 2500.0
    plane = rng.uniform(-0.6, 0.6, size=(7, 9, 2)).astype(np.float32)
    normals = rng.normal(size=(7, 9, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return dict(pixels=pixels, depth=depth, points=points, plane=plane,
                normals=normals)


# transform -> (its arguments, exact: True for rounded pixels)
TRANSFORMS = {
    "pixel_to_image_plane": (("pixels",), False),
    "image_plane_to_pixel": (("plane",), True),
    "camera_to_world": (("points",), False),
    "world_to_camera": (("points",), False),
    "world_to_camera_normal": (("normals",), False),
    "world_to_pixel": (("points",), True),
    "camera_to_pixel": (("points",), True),
    "pixel_to_camera": (("pixels", "depth"), False),
    "pixel_to_world": (("pixels", "depth"), False),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    j, t = _cameras()
    args, exact = TRANSFORMS[name]
    data = _inputs()
    want = np.asarray(getattr(j, name)(*(jnp.asarray(data[a]) for a in args)))
    got = _np(getattr(t, name)(*(data[a] for a in args)))
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.spacing(np.abs(want).max(axis=-1, keepdims=True))
        assert (np.abs(got - want) <= 2 * scale).all(), name


def test_transforms_take_tensors_and_arrays():
    _, t = _cameras()
    pts = _inputs()["points"]
    assert torch.equal(t.world_to_camera(pts), t.world_to_camera(torch.from_numpy(pts)))


def test_depth_map_to_vertices_matches_jax():
    j, t = _cameras()
    rng = np.random.default_rng(7)
    depth = rng.integers(0, 4000, size=(24, 32)).astype(np.uint16)
    depth[depth < 900] = 0
    jv, jm = j.depth_map_to_vertices(depth)
    tv, tm = t.depth_map_to_vertices(depth)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert (_np(tv)[~_np(tm)] == 0).all()
    np.testing.assert_array_equal(_np(tv)[..., 2], np.where(depth > 0, depth, 0))
