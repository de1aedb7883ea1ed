"""PNG I/O on the standard library's zlib and numpy.

Port of ``tsdf_tpu/io/png.py`` without Pillow. Reads and writes the three
kinds of image the system uses: 8-bit and 16-bit greyscale and 8-bit RGB,
non-interlaced. Reading undoes all five PNG row filters; writing uses
filter 0 (None) on every row. Decoded arrays are identical to Pillow's:
u16 (H, W) for 16-bit grey, u8 (H, W) for 8-bit grey, u8 (H, W, 3) for RGB.

The row filters are undone by the host library of ``tsdf_tpu_torch.native``
(``csrc/png_unfilter.cpp``) where it built; ``_unfilter`` is its plain
twin in numpy and Python, which runs where it did not, and is slow on the
Average and Paeth filters: they are a loop over bytes (PERF.md section 5).
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> channels, for the types this module reads
_CHANNELS = {0: 1, 2: 3}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter_sequential(ftype, line, prior, bpp):
    """Average (3) and Paeth (4): each byte depends on the byte ``bpp``
    to its left after reconstruction, so these run byte by byte."""
    out = bytearray(line)
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
        return out
    for i in range(n):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte lane of the pixel
            cur = np.empty(stride, np.uint8)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint64) & 0xFF
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):
            cur = np.frombuffer(
                bytes(
                    _unfilter_sequential(
                        ftype, line.tobytes(), prior.tobytes(), bpp
                    )
                ),
                np.uint8,
            )
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


class PNGData(NamedTuple):
    """A PNG's header and its inflated image data (still filtered)."""

    width: int
    height: int
    depth: int  # bits a sample: 8 or 16
    channels: int  # 1 grey, 3 RGB
    raw: bytes  # height rows of (filter byte + width * bpp bytes)

    @property
    def bpp(self) -> int:
        return self.channels * self.depth // 8


def read_png(path) -> PNGData:
    """Read a PNG's chunks, check them, and inflate its image data."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or (
        ctype == 2 and depth != 8
    ):
        raise ValueError(
            f"{path}: colour type {ctype} at {depth} bits is not supported "
            "(8/16-bit grey and 8-bit RGB only)"
        )
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    return PNGData(width, height, depth, _CHANNELS[ctype],
                   zlib.decompress(b"".join(idat)))


def unfiltered(data: PNGData) -> np.ndarray:
    """The image of ``data``: u16 (H, W), u8 (H, W) or u8 (H, W, 3). The
    row filters are undone by the native library when it is available,
    else by the plain twin ``_unfilter``."""
    from .. import native

    h, w, bpp = data.height, data.width, data.bpp
    if native.available():
        pixels = native.unfilter(data.raw, h, w * bpp, bpp,
                                 swap16=data.depth == 16)
        if data.depth == 16:
            return pixels.view(np.uint16).reshape(h, w)
    else:
        pixels = _unfilter(data.raw, h, w * bpp, bpp)
        if data.depth == 16:
            return pixels.view(">u2").astype(np.uint16).reshape(h, w)
    if data.channels == 1:
        return pixels.reshape(h, w)
    return pixels.reshape(h, w, data.channels)


def load_png(path) -> np.ndarray:
    """Load a PNG: 16-bit grey as u16 (H, W), 8-bit grey as u8 (H, W),
    8-bit RGB as u8 (H, W, 3)."""
    return unfiltered(read_png(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def save_png(path, array) -> None:
    """Save u16 grey (H, W), u8 grey (H, W) or u8 RGB (H, W, 3)."""
    array = np.asarray(array)
    if array.dtype == np.uint16:
        if array.ndim != 2:
            raise ValueError("16-bit PNGs are greyscale: (H, W) only")
        depth, ctype = 16, 0
        pixels = array.astype(">u2")
    elif array.ndim == 2:
        depth, ctype = 8, 0
        pixels = array.astype(np.uint8)
    elif array.ndim == 3 and array.shape[2] == 3:
        depth, ctype = 8, 2
        pixels = array.astype(np.uint8)
    else:
        raise ValueError(f"cannot save an array of shape {array.shape}")
    height, width = array.shape[:2]
    rows = np.ascontiguousarray(pixels).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
