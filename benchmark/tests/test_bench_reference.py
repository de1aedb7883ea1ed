"""The plain reference at small sizes against hand-worked values."""

import math

import pytest
import torch

import bench_tiny  # noqa: F401
from reference import fusion, posegrad, scenefusion, tracking


def _camera(w=4, h=4, f=2.0):
    return {"width": w, "height": h, "fx": f, "fy": f, "cx": w / 2 - 0.5, "cy": h / 2 - 0.5}


def test_integrate_is_the_running_mean_of_clamped_distances():
    # 4^3 voxels of 10 mm over [-20, 20] x [-20, 20] x [0, 40]; the camera at
    # z = -100 looks along +z at a wall 25 mm into the grid
    grid = fusion.make_grid(4, 40.0, device="cpu")
    assert float(grid.voxel_size[0]) == 10.0
    trunc = float(grid.trunc)
    assert trunc == pytest.approx(1.1 * math.sqrt(300.0), rel=1e-6)
    cam = _camera(64, 64, 200.0)
    k = fusion.intrinsics(cam, "cpu")
    pose = torch.eye(4)
    pose[2, 3] = -100.0
    depth = torch.full((64, 64), 125.0)
    fusion.integrate(grid, depth, fusion.inverse(pose), k)
    # plane centres at z = 5, 15, 25, 35: camera depth 105 ... 135
    sdf = torch.tensor([20.0, 10.0, 0.0, -10.0])
    want = torch.minimum(sdf, torch.tensor(trunc))
    assert torch.allclose(grid.tsdf[:, 1, 1], want)
    assert torch.equal(grid.weight[:, 1, 1], torch.ones(4))
    # a second frame 5 mm nearer: the mean of the two
    fusion.integrate(grid, depth - 5.0, fusion.inverse(pose), k)
    want2 = (want + torch.minimum(sdf - 5.0, torch.tensor(trunc))) / 2
    assert torch.allclose(grid.tsdf[:, 1, 1], want2)
    assert torch.equal(grid.weight[:, 1, 1], torch.full((4,), 2.0))
    # behind the surface by more than trunc: no update
    grid2 = fusion.make_grid(4, 40.0, device="cpu")
    fusion.integrate(grid2, torch.full((64, 64), 105.0 - trunc - 1.0),
                     fusion.inverse(pose), k)
    assert float(grid2.weight.sum()) == 0.0


def test_bilateral_keeps_a_flat_frame_and_its_holes():
    d = torch.full((9, 9), 1000.0)
    d[4, 4] = 0.0
    out = tracking.bilateral(d, 20.0, 3.0)
    assert out[4, 4] == 0.0
    assert torch.allclose(out[d > 0], torch.full_like(out[d > 0], 1000.0))


def test_se3_exp_and_pose_gap():
    assert torch.equal(tracking.se3_exp(torch.zeros(6)), torch.eye(4))
    t = tracking.se3_exp(torch.tensor([0.0, 0.0, math.pi / 2, 1.0, 2.0, 3.0]))
    r = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    assert torch.allclose(t[:3, :3], r, atol=1e-6)
    a = torch.eye(4)
    b = tracking.se3_exp(torch.tensor([0.0, 0.001, 0.0, 3.0, 4.0, 0.0]))
    mm, mrad = tracking.pose_gap(a, b)
    assert mrad == pytest.approx(1.0, rel=1e-4)
    assert mm == pytest.approx(float(b[:3, 3].norm()))


def test_trilinear_is_exact_on_a_linear_field():
    z, y, x = torch.meshgrid(torch.arange(4.0), torch.arange(4.0), torch.arange(4.0),
                             indexing="ij")
    field = 2.0 * x - y + 0.5 * z
    vs = torch.ones(3)
    p = torch.tensor([[1.2, 2.3, 1.7], [0.5, 0.5, 0.5]])  # centres at +0.5
    got = tracking.trilinear(field, p, vs)
    want = 2.0 * (p[:, 0] - 0.5) - (p[:, 1] - 0.5) + 0.5 * (p[:, 2] - 0.5)
    assert torch.allclose(got, want, atol=1e-6)


def test_render_of_a_wall_volume_finds_the_wall():
    grid = fusion.make_grid(32, 320.0, device="cpu")
    zc, _yc, _xc = grid.axis_centres()
    grid.tsdf = torch.clamp(200.0 - zc, -grid.trunc, grid.trunc)[:, None, None].expand(
        32, 32, 32).contiguous()
    grid.weight = torch.ones_like(grid.tsdf)
    cam = _camera(8, 8, 8.0)
    k = fusion.intrinsics(cam, "cpu")
    pose = torch.eye(4)
    pose[2, 3] = -50.0
    d = tracking.render_depth(grid, pose, fusion.inverse(pose), k, 8, 8)
    assert torch.allclose(d, torch.full((8, 8), 250.0), atol=0.05)


def test_icp_finds_a_shift_of_a_tilted_plane():
    h, w, f = 60, 80, 70.0
    v, u = torch.meshgrid(torch.arange(float(h)), torch.arange(float(w)), indexing="ij")
    xn, yn = (u - (w / 2 - 0.5)) / f, (v - (h / 2 - 0.5)) / f

    def plane(shift):  # z = 1000 + 0.3 x + 0.2 y + shift, seen along rays
        return (1000.0 + shift) / (1.0 - 0.3 * xn - 0.2 * yn)

    fx = fy = torch.tensor(f)
    cx, cy = torch.tensor(w / 2 - 0.5), torch.tensor(h / 2 - 0.5)
    pose, inl = tracking.icp(plane(4.0), plane(0.0), fx, fy, cx, cy, (10, 5, 4), None)
    assert float(inl) > 0.5 * h * w
    # the residual along the plane's normal goes to zero: n . t = -4 n_z-ish
    normal = torch.tensor([-0.3, -0.2, 1.0]) / math.sqrt(1.13)
    assert float(normal @ pose[:3, 3]) == pytest.approx(-4.0 / math.sqrt(1.13), abs=0.05)


def test_surface_of_one_crossing_cube():
    grid = fusion.make_grid(2, 20.0, offset_mm=[0.0, 0.0, 0.0], device="cpu")
    tsdf = torch.tensor([[[-1.0, -1.0], [-1.0, -1.0]], [[3.0, 3.0], [3.0, 3.0]]])
    vert, vox, live, over = scenefusion.surface(tsdf, grid, 4)
    assert not over
    # one cube, cut by the plane between its z layers: two triangles
    assert int(live.sum()) == 6
    z = vert[live][:, 2]
    # the crossing is a quarter of the way from z = 5 to z = 15
    assert torch.allclose(z, torch.full_like(z, 7.5))
    pairs = {tuple(sorted(p)) for p in vox[live].tolist()}
    assert all(a < 4 <= b for a, b in pairs)


def test_image_gradients_are_central_differences():
    d = torch.arange(20.0).reshape(4, 5) + 1.0
    gx, gy = posegrad.image_gradients(d)
    assert torch.equal(gx[1:-1, 1:-1], torch.ones(2, 3))
    assert torch.equal(gy[1:-1, 1:-1], torch.full((2, 3), 5.0))
    assert gx[0, 0] == 0.0 and gy[0, 0] == 0.0
