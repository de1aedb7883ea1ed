"""The metric arithmetic: a rate over the whole window, a p95 over every
frame, idle as a union of intervals, a roofline share."""

import math

import pytest
import torch

import bench_tiny  # noqa: F401
from harness import bounds
from harness.common import Ctx, FrameWindow
from harness.trace import TraceSummary, idle_gaps, kernel_base_name, union_s
from run import load_module, reader_path


def _reader(name):
    return load_module(reader_path(name), "m_" + name.replace(".", "_"))


def _summary(**kw):
    base = dict(window_s=1.0, units=4, kernels=[], mem_ops=[], syncs=0, gaps=[],
                port_kernels=frozenset({"integrate_kernel", "brick_cull_kernel",
                                        "depth_max_kernel", "pose_grad_copy_kernel",
                                        "pose_grad_walk_kernel"}),
                extras={})
    base.update(kw)
    return TraceSummary(**base)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union_s(iv) == 3.0
    assert idle_gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert idle_gaps(iv, -1.0, 4.0) == [(-1.0, 0.0), (2.0, 3.0)]


def test_idle_share_is_the_union_not_the_sum():
    t = _summary(kernels=[("a", 0.0, 0.5), ("b", 0.25, 0.5)],
                 mem_ops=[("Memcpy HtoD", 0.5, 0.6)])
    assert t.busy_s() == pytest.approx(0.6)
    assert _reader("device_idle_share").read(t) == pytest.approx(40.0)
    assert _reader("device_idle_share.step").read(t) == pytest.approx(40.0)


def test_counts_a_frame():
    t = _summary(kernels=[("void at::native::foo<float>(float*)", 0.0, 0.1),
                          ("void (anonymous namespace)::integrate_kernel<float, true>(float*)", 0.1, 0.4),
                          ("void cub::Sort(int)", 0.4, 0.5)],
                 syncs=6)
    assert _reader("launches_per_frame").read(t) == 0.75
    assert _reader("launches_per_step").read(t) == 0.75
    assert _reader("syncs_per_frame").read(t) == 1.5
    assert _reader("syncs_per_step").read(t) == 1.5
    # the library kernels: at::native and cub, 0.2 s over 4 frames
    assert _reader("library_ms_per_frame").read(t) == pytest.approx(50.0)
    assert _reader("launches_per_frame").read(None) is None
    assert _reader("syncs_per_step").read(_summary(units=0)) is None


def test_kernel_names():
    assert kernel_base_name("void (anonymous namespace)::walk<float, true>(float*, int)") == "walk"
    assert kernel_base_name("void at::native::vectorized_elementwise_kernel<4>(int)") == \
        "vectorized_elementwise_kernel"
    assert kernel_base_name("pose_grad_walk_kernel") == "pose_grad_walk_kernel"


def test_roofline_shares():
    # the adjoint: its own kernels and half of the pre-passes, which the
    # forward integrate launches as often as the adjoint
    t = _summary(kernels=[("pose_grad_copy_kernel<float>(x)", 0.0, 0.1),
                          ("pose_grad_walk_kernel<float>(x)", 0.1, 0.3),
                          ("integrate_kernel<float>(x)", 0.3, 0.4),
                          ("depth_max_kernel(x)", 0.4, 0.5),
                          ("brick_cull_kernel(x)", 0.5, 0.6)],
                 extras={"pose_grad_bound_s": 0.2})
    assert _reader("pose_grad_roofline").read(t) == pytest.approx(50.0)


def test_bounds_from_the_published_peaks():
    # bytes bind: 16 B an updated voxel and 4 B a pixel
    s = bounds.integrate_bound_s(0, 0, 10**9, 0)
    assert s == pytest.approx(max(16e9 / 3.35e12, 8e9 / 67e12))
    # operations bind: 27 a voxel
    s = bounds.integrate_bound_s(10**12, 0, 0, 0)
    assert s == pytest.approx(27e12 / 67e12)
    s = bounds.pose_grad_bound_s(10, 0, 0, 0, 0)
    assert s == pytest.approx(max(160 / 3.35e12, 270 / 67e12))
    pi = torch.eye(4)
    axes = (torch.tensor([-1.0, 1.0]), torch.tensor([0.0]), torch.tensor([0.0, 2.0, 3.0]))
    assert bounds.voxels_in_front(axes, pi) == 3


def test_window_rate_and_p95_over_every_frame():
    ctx = Ctx("w", {}, {}, {}, 0, 0.05, False, torch.device("cpu"))
    win = FrameWindow(ctx, warmup=2, one_in_flight=True)
    got = list(win.frames(lambda i: i))
    win.close()
    assert got[:2] == [0, 1] and win.window_frames == len(got) - 2
    assert win.rate() == pytest.approx(win.window_frames / win.seconds)
    win.latencies = [float(v) for v in range(1, 101)]
    assert win.p95_ms() == pytest.approx(95.05e3)
    assert math.isfinite(win.p95_ms())
