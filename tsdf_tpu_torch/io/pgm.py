"""PGM (P5) reading and writing, with NYU's byte-swapped u16 variant.

Port of ``tsdf_tpu/io/pgm.py`` (numpy only). P5 is binary greyscale,
most significant byte first; NYU's depth PGMs are stored least
significant byte first and are swapped back after the read.
"""

from __future__ import annotations

import numpy as np


def load_pgm(path: str) -> np.ndarray:
    """Load a binary P5 PGM: (H, W) u8, or u16 read big-endian."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path}: not a binary P5 PGM")
    # width, height and maxval, separated by whitespace, with '#'
    # comments between them
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # the single whitespace after maxval
    width, height, maxval = fields
    if maxval < 256:
        arr = np.frombuffer(data, np.uint8, width * height, pos)
    else:
        arr = np.frombuffer(data, ">u2", width * height, pos).astype(
            np.uint16
        )
    return arr.reshape(height, width)


def save_pgm(path: str, image: np.ndarray) -> None:
    """Save (H, W) u8 (maxval 255) or any other integer type as u16
    (maxval 65535, big-endian)."""
    image = np.asarray(image)
    maxval = 255 if image.dtype == np.uint8 else 65535
    with open(path, "wb") as f:
        f.write(
            f"P5\n{image.shape[1]} {image.shape[0]}\n{maxval}\n".encode()
        )
        if image.dtype == np.uint8:
            f.write(image.tobytes())
        else:
            f.write(image.astype(">u2").tobytes())


def read_nyu_depth_map(path: str) -> np.ndarray:
    """NYU depth PGM: little-endian on disk despite the P5 spec, so the
    spec-conformant read is byte-swapped back."""
    depth = load_pgm(path)
    if depth.dtype == np.uint16:
        depth = depth.byteswap()
    return depth


def read_tum_depth_map(path: str) -> np.ndarray:
    """TUM depth PNG in 0.2 mm units -> u16 mm (integer division by 5)."""
    from .png import load_png

    return (load_png(path) // 5).astype(np.uint16)
