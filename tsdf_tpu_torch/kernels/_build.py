"""Build ``csrc/*.cu`` into one shared library and bind it with ctypes.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``), one process
per source and all at once, and linked into
``csrc/build/libtsdf_kernels.so`` on first use, and again whenever a
source is newer than the library. Each C entry point launches one kernel
on the stream it is given and returns ``cudaGetLastError()``; the
:class:`Kernel` wrapper raises on a non-zero code and counts launches.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..volume import STORAGE_DTYPES

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
LIB_NAME = "libtsdf_kernels.so"

# --fmad=false: no mul+add contraction, so every kernel rounds exactly as
# its plain PyTorch twin (one IEEE op at a time). -Xptxas=-v writes each
# kernel's registers and spills into the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas=-v",
]

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    return BUILD_DIR / LIB_NAME


def build(force: bool = False) -> Path:
    """Compile the kernels if the library is missing or stale; returns
    its path. Raises RuntimeError with nvcc's output on failure."""
    lib = library_path()
    srcs = _sources()
    # a header (*.cuh) shared by several sources makes the library stale too
    newest = max(s.stat().st_mtime for s in [*srcs, *CSRC.glob("*.cuh")])
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    objects = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    t0 = time.perf_counter()
    compiles = []
    for src, obj in zip(srcs, objects):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + f"\n# exit {proc.returncode}\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out = proc.stdout + proc.stderr
        log.append(" ".join(cmd) + f"\n# exit {proc.returncode}\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text(
        "\n".join(log) + f"# {seconds:.1f} s in all\n"
    )
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernels library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tsdf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tsdf_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Kernel:
    """One C entry point of the library and the count of its launches.

    ``launches`` goes up by one each time the kernel is launched without
    a launch error, and nowhere else.
    """

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().tsdf_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(name, t, dtype, ndim=None, shape=None) -> None:
    """Raise unless ``t`` has the dtype, rank/shape and a contiguous
    layout a kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim}-D")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def storage_dtype(tsdf, weight=None) -> torch.dtype:
    """The storage dtype of a volume's tsdf (and weight, which must match
    it): float32 or bfloat16, the two the kernels have instances for. Any
    other raises TypeError; nothing is cast."""
    for name, t in (("tsdf", tsdf), ("weight", weight)):
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if tsdf.dtype not in STORAGE_DTYPES:
        raise TypeError(
            f"tsdf: dtype {tsdf.dtype}; the kernels store float32 or bfloat16")
    if weight is not None and weight.dtype != tsdf.dtype:
        raise TypeError(
            f"weight: dtype {weight.dtype}, expected tsdf's {tsdf.dtype}")
    return tsdf.dtype


def check_same_device(device: torch.device, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` and ``device`` is the
    CPU or a CUDA card: the kernels never move data between devices."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
