"""The generators make the same inputs from the same seed, and every seed
the same set of frames in another order."""

import json

import torch

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
from bench_tiny import BENCH, resize
from harness import flowscene, scene


def _config(name):
    cfg = json.load(open(BENCH / "configs" / f"{name}.json"))
    resize(cfg, {})
    return cfg


def test_trajectory_is_a_closed_cycle_that_every_seed_replays():
    cfg = _config("kinfu512")
    traj = cfg["trajectory"]
    period = traj["period"]
    a = scene.trajectory(traj, period, 5, "cpu")
    b = scene.trajectory(traj, period, 5, "cpu")
    c = scene.trajectory(traj, period, 5 + period + 7, "cpu")  # other start, reversed
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    key = lambda p: tuple(round(float(v), 6) for v in p[:3, 3])  # noqa: E731
    assert sorted(map(key, a)) == sorted(map(key, c))
    # closed: the frame after the last is the first
    d = scene.trajectory(traj, period + 1, 5, "cpu")
    assert torch.allclose(d[period], d[0], atol=1e-9)


def test_depth_stream_is_the_same_for_the_same_seed():
    cfg = _config("kinfu512")
    poses = scene.trajectory(cfg["trajectory"], 6, 123, "cpu")
    a = scene.depth_stream(cfg, poses, 123, batch=4)
    b = scene.depth_stream(cfg, poses, 123, batch=4)
    c = scene.depth_stream(cfg, poses, 124, batch=4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    cam = cfg["camera"]
    assert a.shape == (6, cam["height"], cam["width"]) and a.dtype == torch.float32
    valid = a[a > 0]
    assert 0.9 < valid.numel() / a.numel() <= 1.0
    # the TUM quantisation: whole multiples of 0.2 mm
    assert torch.allclose(valid * 5.0, torch.round(valid * 5.0), atol=1e-3)


def test_analytic_depth_of_a_wall_facing_the_camera():
    cam = {"width": 8, "height": 6, "fx": 5.0, "fy": 5.0, "cx": 4.0, "cy": 3.0}
    pose = torch.eye(4, dtype=torch.float64)[None]
    d = scene.analytic_depth(pose, {"planes": [["z", 1000.0]]}, cam)
    assert torch.equal(d, torch.full((1, 6, 8), 1000.0))
    d = scene.analytic_depth(pose, {"planes": [["z", 1000.0]],
                                    "spheres": [[0.0, 0.0, 500.0, 100.0]]}, cam)
    # the ray through the principal point meets the sphere at z = 400
    assert float(d[0, 3, 4]) == 400.0


def test_flow_cycle_is_the_same_for_the_same_seed_and_zero_on_the_wall():
    cfg = _config("sfusion255")
    d1, f1 = flowscene.make_cycle(cfg, 9, "cpu")
    d2, f2 = flowscene.make_cycle(cfg, 9, "cpu")
    d3, _ = flowscene.make_cycle(cfg, 10, "cpu")
    assert torch.equal(d1, d2) and torch.equal(f1, f2)
    assert not torch.equal(d1, d3)
    wall = (d1 - cfg["scene"]["wall_z"]).abs() < 40.0
    assert bool((f1[wall] == 0).all())
    moving = f1.norm(dim=-1)
    assert float(moving.max()) < 10.0  # under the correspondence threshold
    assert float(moving.max()) > 1.0
