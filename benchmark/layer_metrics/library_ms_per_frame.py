"""Device milliseconds a frame of the kernels that are not the port's
own: ATen's, cuBLAS', cuSOLVER's and cub's, such as the tracker's sums and
solves and the deformation update's scatter and sorts. A kernel is the
port's when its name, stripped of namespaces, template arguments and
parameters, is a ``__global__`` function of ``tsdf_tpu_torch/csrc``."""


def read(t):
    if t is None:
        return None
    ms = sum(e - s for name, s, e in t.kernels if not t.is_port_kernel(name))
    return t.per_unit(ms * 1e3)
