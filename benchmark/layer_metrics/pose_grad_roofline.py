"""The pose adjoint's share of its roofline: the least time the traced
steps' adjoints could take (``harness.bounds``, from the voxels each
step's pose must touch) over the device time of the adjoint's kernels
(``csrc/integrate_pose_grad.cu``'s copy and walk, and its share of the
depth-maximum and brick-cull pre-passes, which the forward integrate
launches too: split by the two walks' launch counts), in percent."""

OWN = {"pose_grad_copy_kernel", "pose_grad_walk_kernel"}
PREPASS = {"depth_max_kernel", "brick_cull_kernel"}


def read(t):
    bound = None if t is None else t.extras.get("pose_grad_bound_s")
    if not bound:
        return None
    own, _ = t.kernel_time_s(OWN)
    _walk, adjoints = t.kernel_time_s({"pose_grad_walk_kernel"})
    _fwd, forwards = t.kernel_time_s({"integrate_kernel"})
    pre, _ = t.kernel_time_s(PREPASS)
    if not adjoints:
        return None
    seconds = own + pre * adjoints / (adjoints + forwards)
    return 100.0 * bound / seconds
