"""Format converters: port of ``tsdf_tpu/io/convert.py``, the
reference's small conversion tools as functions (numpy only)."""

from __future__ import annotations

import numpy as np

from .pgm import load_pgm
from .png import save_png


def freenect_raw11_to_mm(raw: np.ndarray) -> np.ndarray:
    """Kinect raw11 disparity -> u16 mm depth:
    1000 / (raw * -0.0030711016 + 3.3309495161); raw >= 2047 (and a
    non-positive depth) is invalid and maps to 0."""
    raw = np.asarray(raw, np.float32)
    depth = 1000.0 / (raw * -0.0030711016 + 3.3309495161)
    depth = np.where((raw >= 2047) | (depth <= 0), 0.0, depth)
    return np.clip(np.round(depth), 0, 65535).astype(np.uint16)


def freenect2png(pgm_path: str, png_path: str) -> None:
    """Freenect PGM (raw11, least significant byte first) -> mm depth PNG."""
    raw = load_pgm(pgm_path)
    if raw.dtype == np.uint16:
        raw = raw.byteswap()
    save_png(png_path, freenect_raw11_to_mm(raw))


def pgm2png(pgm_path: str, png_path: str) -> None:
    """Plain PGM -> PNG."""
    save_png(png_path, load_pgm(pgm_path))


def fl_2_uchar(in_path: str, out_path: str) -> tuple[float, float]:
    """Raw float volume -> raw u8 volume, min-max normalised to 0..255.

    The input is a header of 3 x uint32 size and 3 x float32 physical
    size, then size.x * size.y * size.z float32 values; the output is as
    many raw bytes, with no header. The reference multiplies by a bare 255
    where it computed 255 / (max - min), which overflows for any range
    wider than 1; the intended normalisation is kept here.

    Returns the input's (min, max).
    """
    with open(in_path, "rb") as f:
        size = np.fromfile(f, np.uint32, 3)
        np.fromfile(f, np.float32, 3)  # the physical size: unused
        n = int(size[0]) * int(size[1]) * int(size[2])
        data = np.fromfile(f, np.float32, n)
    if data.size != n:
        raise ValueError(
            f"{in_path}: expected {n} floats, found {data.size}"
        )
    lo, hi = float(data.min()), float(data.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    out = np.clip((data - lo) * scale, 0.0, 255.0).astype(np.uint8)
    out.tofile(out_path)
    return lo, hi
