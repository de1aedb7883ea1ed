"""Native frame loading: a host C++ library for the PNG row filters, and
decode-ahead over a thread pool.

Port of ``tsdf_tpu/native/__init__.py`` (its names and behaviour) without
libpng: ``csrc/png_unfilter.cpp`` has a plain C interface and includes no
library. A frame is read and inflated in Python (``io.png.read_png``:
the file read and ``zlib.decompress`` release the GIL), its row filters are
undone by the library (ctypes releases the GIL around the call), so the
threads of ``load_png16_batch`` and ``PNGPrefetcher`` decode in parallel.

The library is built at first use with the host compiler (g++) into
``csrc/build/libtsdf_png.so``: into a temporary file first, renamed into
place atomically, under an inter-process ``fcntl`` lock, so processes that
build at once (test workers) each load a whole library. If it cannot be
built, ``available()`` is False, ``build_error()`` says why, and
``io.png.load_png`` undoes the filters in Python (its plain twin).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

from ..io.png import read_png, save_png, unfiltered

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "png_unfilter.cpp"
BUILD_DIR = SOURCE.parent / "build"
LIB_NAME = "libtsdf_png.so"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

# frames a PNGPrefetcher decodes ahead of the one its consumer waits for
# (tsdf_tpu/native/tsdf_io.cpp:kPrefetchWindow)
PREFETCH_WINDOW = 16

# libpng's default rgb_to_gray coefficients (png_set_rgb_to_gray_fixed with
# negative weights), in 1/32768: blue is what red and green leave
_RGB_TO_GRAY = (6968, 23434, 32768 - 6968 - 23434)

_lib = None
_lock = threading.Lock()
_build_error: str | None = None


def build(directory=None, force: bool = False) -> Path:
    """Compile the library into ``directory`` (default ``BUILD_DIR``) if it
    is missing, older than its source, or ``force``; returns its path.
    Raises RuntimeError with the compiler's output on failure."""
    directory = Path(directory) if directory is not None else BUILD_DIR
    directory.mkdir(parents=True, exist_ok=True)
    lib = directory / LIB_NAME
    with open(directory / (LIB_NAME + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if (not force and lib.exists()
                and lib.stat().st_mtime >= SOURCE.stat().st_mtime):
            return lib
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native library cannot be built")
        tmp = directory / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    "g++ failed:\n" + " ".join(cmd) + "\n" + proc.stderr[-4000:])
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


def _load():
    """The loaded library, built first if need be; None if that failed."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _build_error = str(e)
                return None
            fn = lib.tsdf_png_unfilter
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    return _build_error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native io unavailable: {_build_error}")
    return lib


def unfilter(raw: bytes, height: int, stride: int, bpp: int,
             swap16: bool = False) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` (height rows of a filter byte
    and ``stride`` bytes): (height, stride) u8, each byte pair swapped to
    the host's order with ``swap16`` (16-bit samples). The native form of
    ``io.png._unfilter``."""
    lib = _require()
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    out = np.empty((height, stride), np.uint8)
    bad = lib.tsdf_png_unfilter(raw, out.ctypes.data, height, stride, bpp,
                                int(bool(swap16)))
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    return out


def _to_gray16(image: np.ndarray) -> np.ndarray:
    """A decoded image as (H, W) u16 grey, as libpng's transforms of
    tsdf_tpu/native/tsdf_io.cpp:60-95 give it: 16-bit grey as is, 8-bit
    samples expanded by 257, RGB reduced first by the fixed-point
    rgb_to_gray (truncated; a pixel with r == g == b keeps r)."""
    if image.dtype == np.uint16:
        return image
    if image.ndim == 3:
        r, g, b = (image[..., c].astype(np.uint32) for c in range(3))
        kr, kg, kb = _RGB_TO_GRAY
        mixed = (kr * r + kg * g + kb * b) >> 15
        image = np.where((r == g) & (r == b), r, mixed).astype(np.uint8)
    return image.astype(np.uint16) * np.uint16(257)


def _decode(path: str, strict: bool) -> np.ndarray:
    """Decode one file to (H, W) u16; with ``strict`` only 16-bit grey.
    Any fault of the file raises IOError."""
    _require()
    try:
        data = read_png(path)
        if strict and (data.depth != 16 or data.channels != 1):
            raise ValueError("not a 16-bit greyscale PNG")
        return _to_gray16(unfiltered(data))
    except (OSError, ValueError, struct.error, zlib.error) as e:
        raise IOError(f"decode failed: {path}: {e}") from e


def load_png16(path: str) -> np.ndarray:
    """(H, W) u16 depth image via the native decoder. 8-bit grey is
    expanded by 257 and 8-bit RGB reduced to grey first, as the JAX
    package's libpng chain does; a format the port's codec does not read
    raises IOError."""
    return _decode(str(path), strict=False)


def save_png16(path: str, image: np.ndarray) -> None:
    _require()
    image = np.ascontiguousarray(image, np.uint16)
    if image.ndim != 2:
        raise ValueError("16-bit PNGs are greyscale: (H, W) only")
    try:
        save_png(path, image)
    except OSError as e:
        raise IOError(f"encode failed: {path}: {e}") from e


def load_png16_batch(paths: list[str], threads: int = 8) -> np.ndarray:
    """(N, H, W) u16: all images decoded in parallel threads. Every image
    must have the first one's size."""
    _require()
    if not paths:
        return np.empty((0, 0, 0), np.uint16)
    with concurrent.futures.ThreadPoolExecutor(max(threads, 1)) as pool:
        frames = list(pool.map(load_png16, [str(p) for p in paths]))
    shape = frames[0].shape
    ok = sum(f.shape == shape for f in frames)
    if ok != len(frames):
        raise IOError(f"decoded {ok}/{len(paths)} images of {shape}")
    return np.stack(frames)


class PNGPrefetcher:
    """Background-thread decode-ahead over an ordered path list.

    Iterating yields (H, W) u16 frames; decode overlaps consumer compute
    (the TUM fuse loop feeds the card from this). Strict: a file that is
    not 16-bit greyscale raises IOError for that frame, so that the
    caller loads it another way and both paths agree bit for bit. A frame
    can be taken once; a second ``get`` of it raises IOError. At most
    ``PREFETCH_WINDOW`` frames from the one the consumer last asked for
    are decoded or in flight.
    """

    def __init__(self, paths: list[str], threads: int = 4):
        _require()
        self._paths = [str(p) for p in paths]
        self._n = len(self._paths)
        self._frames: list = [None] * self._n
        self._state = [0] * self._n  # 0 pending, 1 busy, 2 done, 3 taken
        self._next = 0  # the next frame a worker takes
        self._consumed = 0  # the frame the consumer last asked for
        self._stop = False
        self._cv = threading.Condition()
        self._workers = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(threads if threads > 0 else 4)
        ]
        for t in self._workers:
            t.start()

    def _work(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._stop or (
                    self._next < self._n
                    and self._next < self._consumed + PREFETCH_WINDOW))
                if self._stop or self._next >= self._n:
                    return
                i = self._next
                self._next += 1
                self._state[i] = 1
            try:
                frame = _decode(self._paths[i], strict=True)
            except IOError as e:
                frame = e
            with self._cv:
                self._frames[i] = frame
                self._state[i] = 2
                self._cv.notify_all()

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        for i in range(self._n):
            yield self.get(i)

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < self._n:
            raise IOError(f"frame {i} failed to decode: no such frame")
        with self._cv:
            if self._state[i] == 3:
                raise IOError(f"frame {i} failed to decode: already taken")
            if i >= self._consumed:
                self._consumed = i  # opens the window for the workers
                self._cv.notify_all()
            self._cv.wait_for(lambda: self._state[i] >= 2 or self._stop)
            if self._state[i] < 2:
                raise IOError(f"frame {i} failed to decode: prefetcher closed")
            frame, self._frames[i] = self._frames[i], None
            self._state[i] = 3
        if isinstance(frame, Exception):
            raise IOError(f"frame {i} failed to decode") from frame
        return frame

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join()
        self._workers = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
