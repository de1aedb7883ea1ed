"""Native frame loading in tsdf_tpu_torch vs the JAX package.

PNGs are encoded here in numpy with each row filter of the PNG
specification (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) and with the five
mixed row by row, in 16-bit grey, 8-bit grey and 8-bit RGB. The port's
native decode (``csrc/png_unfilter.cpp`` through ``io.png.load_png``), its
plain twin (``io.png._unfilter``) and the JAX package's loader
(``tsdf_tpu.io.png.load_png``, Pillow) must agree bit for bit.

The JAX package's own native library is not called here: its build races
under several test workers (ROADMAP Queue 3). Its RGB-to-grey chain (libpng's
``png_set_rgb_to_gray_fixed(1, -1, -1)`` and ``png_set_expand_16``) is held
through a golden taken once from that library on the image of
``_rgb_image``.
"""

import os
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest

import tsdf_tpu.native
from tsdf_tpu.io.png import load_png as jax_load_png
from tsdf_tpu.io.tum import TUMDataLoader as JaxTUMDataLoader
from tsdf_tpu_torch import native
from tsdf_tpu_torch.io import png
from tsdf_tpu_torch.io.tum import TUMDataLoader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [4, 0, 3, 1, 2]}

# tsdf_tpu/native/libtsdf_io.so's tsdf_load_png16 of _rgb_image()
RGB_GOLDEN = [
    [20046, 8738, 59881, 31354, 42919, 31354, 32382, 59881],
    [56026, 42919, 8481, 28784, 38807, 18247, 33410, 36751],
    [29298, 17990, 5654, 50372, 49601, 21845, 38550, 49601],
    [57568, 34181, 34438, 19789, 22359, 16962, 15163, 51657],
    [39578, 24672, 40863, 35466, 38550, 52171, 41634, 27756],
    [50115, 32382, 51143, 24929, 42405, 48059, 31868, 16962],
]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(path, array, filters) -> None:
    """Write ``array`` (u16 grey, u8 grey or u8 RGB) as a PNG whose row y
    is filtered with ``filters[y % len(filters)]``."""
    array = np.asarray(array)
    if array.dtype == np.uint16:
        depth, ctype, rows = 16, 0, array.astype(">u2")
    elif array.ndim == 2:
        depth, ctype, rows = 8, 0, array
    else:
        depth, ctype, rows = 8, 2, array
    h, w = array.shape[:2]
    bpp = (1 if ctype == 0 else 3) * depth // 8
    rows = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    rows = rows.astype(np.int32)
    out = []
    prior = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        f = filters[y % len(filters)]
        pred = [0, a, prior, (a + prior) >> 1, _paeth(a, prior, c)][f]
        out.append(np.concatenate([[f], (x - pred) & 0xFF]).astype(np.uint8))
        prior = x

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _image(kind, rng, shape=(37, 29)):
    if kind == "grey16":
        return rng.integers(0, 65536, shape, dtype=np.uint16)
    if kind == "grey8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.integers(0, 256, shape + (3,), dtype=np.uint8)


def _rgb_image():
    rgb = np.random.default_rng(11).integers(0, 256, (6, 8, 3), dtype=np.uint8)
    rgb[0, :4] = rgb[0, :4, :1]  # grey pixels: r == g == b
    return rgb


def _twin(path):
    """``io.png.load_png`` with the row filters undone by the plain twin."""
    data = png.read_png(path)
    pixels = png._unfilter(data.raw, data.height, data.width * data.bpp,
                           data.bpp)
    if data.depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(data.height,
                                                            data.width)
    return pixels.reshape(np.asarray(png.load_png(path)).shape)


def test_the_library_builds_here():
    assert native.available(), native.build_error()
    assert native.build_error() is None


@pytest.mark.parametrize("kind", ["grey16", "grey8", "rgb"])
@pytest.mark.parametrize("filters", list(FILTERS))
def test_native_twin_and_pillow_agree(tmp_path, kind, filters):
    rng = np.random.default_rng(len(kind) * 10 + len(filters))
    img = _image(kind, rng)
    path = str(tmp_path / "f.png")
    encode_png(path, img, FILTERS[filters])
    got = png.load_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(_twin(path), img)
    np.testing.assert_array_equal(np.asarray(jax_load_png(path)), img)
    if kind == "grey16":
        np.testing.assert_array_equal(native.load_png16(path), img)


def test_load_png_without_the_library_is_the_twin(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    img = _image("grey16", rng)
    path = str(tmp_path / "f.png")
    encode_png(path, img, FILTERS["mixed"])
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(png.load_png(path), img)


def test_unknown_filter_type_raises(tmp_path):
    path = str(tmp_path / "bad.png")
    encode_png(path, np.zeros((4, 5), np.uint16), [0])
    data = png.read_png(path)
    raw = bytearray(data.raw)
    raw[2 * (5 * 2 + 1)] = 5  # row 2's filter byte
    with pytest.raises(ValueError, match="row 2"):
        native.unfilter(bytes(raw), 4, 10, 2)
    with pytest.raises(ValueError, match="row 2"):
        png._unfilter(bytes(raw), 4, 10, 2)
    with pytest.raises(ValueError, match="wrong size"):
        native.unfilter(bytes(raw[:-1]), 4, 10, 2)


def test_load_png16_expands_grey8_and_reduces_rgb(tmp_path):
    """The permissive chain of tsdf_tpu/native/tsdf_io.cpp:60-95: 8-bit
    grey times 257; RGB through libpng's fixed-point rgb_to_gray, the
    golden of the JAX library."""
    rng = np.random.default_rng(4)
    grey = _image("grey8", rng)
    encode_png(str(tmp_path / "g.png"), grey, FILTERS["mixed"])
    np.testing.assert_array_equal(native.load_png16(str(tmp_path / "g.png")),
                                  grey.astype(np.uint16) * 257)
    encode_png(str(tmp_path / "rgb.png"), _rgb_image(), [0, 1, 2, 3, 4])
    got = native.load_png16(str(tmp_path / "rgb.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, np.array(RGB_GOLDEN, np.uint16))
    with pytest.raises(IOError):
        native.load_png16(str(tmp_path / "missing.png"))
    (tmp_path / "junk.png").write_bytes(b"not a png")
    with pytest.raises(IOError):
        native.load_png16(str(tmp_path / "junk.png"))


def test_save_png16_round_trip(tmp_path):
    img = _image("grey16", np.random.default_rng(5))
    native.save_png16(str(tmp_path / "s.png"), img)
    np.testing.assert_array_equal(native.load_png16(str(tmp_path / "s.png")),
                                  img)
    np.testing.assert_array_equal(np.asarray(jax_load_png(str(tmp_path / "s.png"))),
                                  img)


def _frames(tmp_path, n, shape=(37, 29), filters="mixed"):
    rng = np.random.default_rng(6)
    paths, imgs = [], []
    for i in range(n):
        img = _image("grey16", rng, shape)
        paths.append(str(tmp_path / f"{i}.png"))
        encode_png(paths[-1], img, FILTERS[filters])
        imgs.append(img)
    return paths, imgs


def test_load_png16_batch(tmp_path):
    paths, imgs = _frames(tmp_path, 7)
    got = native.load_png16_batch(paths, threads=3)
    assert got.shape == (7, 37, 29) and got.dtype == np.uint16
    np.testing.assert_array_equal(got, np.stack(imgs))
    assert native.load_png16_batch([]).shape == (0, 0, 0)
    encode_png(str(tmp_path / "odd.png"), np.zeros((5, 5), np.uint16), [0])
    with pytest.raises(IOError):
        native.load_png16_batch(paths[:2] + [str(tmp_path / "odd.png")])


def test_prefetcher_order_retake_and_strictness(tmp_path):
    paths, imgs = _frames(tmp_path, 6)
    encode_png(paths[3], _image("grey8", np.random.default_rng(7)), [4])
    pf = native.PNGPrefetcher(paths, threads=2)
    try:
        assert len(pf) == 6
        for i in range(6):
            if i == 3:  # 8-bit grey: the strict prefetcher refuses it
                with pytest.raises(IOError):
                    pf.get(i)
                continue
            np.testing.assert_array_equal(pf.get(i), imgs[i])
        with pytest.raises(IOError):
            pf.get(2)  # a frame is taken once
        with pytest.raises(IOError):
            pf.get(6)
    finally:
        pf.close()
    pf = native.PNGPrefetcher(paths[:3])
    frames = list(pf)
    pf.close()
    for got, want in zip(frames, imgs):
        np.testing.assert_array_equal(got, want)


def _wait_for(cond, seconds=20.0):
    end = time.monotonic() + seconds
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


def test_prefetcher_window_and_close(tmp_path, monkeypatch):
    """Workers decode no more than PREFETCH_WINDOW frames past the one the
    consumer last asked for; close() stops and joins them."""
    n = native.PREFETCH_WINDOW * 2 + 5
    paths, imgs = _frames(tmp_path, n, shape=(8, 8))
    decoded = []
    lock = threading.Lock()
    real = native._decode

    def counting(path, strict):
        with lock:
            decoded.append(path)
        return real(path, strict)

    monkeypatch.setattr(native, "_decode", counting)
    threads_before = threading.active_count()
    pf = native.PNGPrefetcher(paths, threads=4)
    assert threading.active_count() == threads_before + 4
    window = native.PREFETCH_WINDOW
    assert _wait_for(lambda: len(decoded) == window)
    time.sleep(0.2)
    assert len(decoded) == window  # nothing past the window
    np.testing.assert_array_equal(pf.get(10), imgs[10])
    assert _wait_for(lambda: len(decoded) == 10 + window)
    time.sleep(0.2)
    assert len(decoded) == 10 + window
    pf.close()
    assert threading.active_count() == threads_before  # workers joined
    with pytest.raises(IOError):
        pf.get(n - 1)  # never decoded: the prefetcher is closed
    assert len(decoded) == 10 + window


def _tum_dir(root, n=6):
    """A TUM directory of Paeth/mixed-filtered 16-bit depth frames, one
    8-bit grey frame (which the prefetcher refuses) and filtered rgb
    frames."""
    rng = np.random.default_rng(8)
    os.makedirs(os.path.join(root, "depth"))
    os.makedirs(os.path.join(root, "rgb"))
    lines = []
    for i in range(n):
        stamp = f"{i}.000000"
        if i == 2:
            depth = _image("grey8", rng, (24, 32))
        else:
            depth = rng.integers(2000, 12000, (24, 32)).astype(np.uint16)
        encode_png(os.path.join(root, "depth", f"{stamp}.png"), depth,
                   FILTERS["paeth" if i % 2 else "mixed"])
        encode_png(os.path.join(root, "rgb", f"{stamp}.png"),
                   _image("rgb", rng, (24, 32)), FILTERS["mixed"])
        lines.append(f"{stamp} {0.01 * i} 0.02 -0.5 0.0 0.0 0.0 1.0")
    with open(os.path.join(root, "ground_truth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_tum_loader_prefetched_plain_and_jax_agree(tmp_path, monkeypatch):
    _tum_dir(str(tmp_path))
    fetched = [(d.data.copy(), p) for d, p in TUMDataLoader(str(tmp_path))]
    rgbs = [r for _d, _p, r in TUMDataLoader(str(tmp_path)).iter_with_rgb()]
    # the JAX loader through Pillow: its native prefetcher is not built
    monkeypatch.setattr(tsdf_tpu.native, "available", lambda: False)
    jax_frames = [(np.asarray(d.data), np.asarray(p))
                  for d, p in JaxTUMDataLoader(str(tmp_path))]
    monkeypatch.setattr(native, "available", lambda: False)
    plain = [(d.data.copy(), p) for d, p in TUMDataLoader(str(tmp_path))]
    assert len(fetched) == len(plain) == len(jax_frames) == 6
    for (a, pa), (b, pb), (c, pc) in zip(fetched, plain, jax_frames):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(pa, pc)
    for i, rgb in enumerate(rgbs):
        want = np.asarray(jax_load_png(
            os.path.join(str(tmp_path), "rgb", f"{i}.000000.png")))
        np.testing.assert_array_equal(rgb, want)


_BUILD = """
import ctypes, sys
import numpy as np
from tsdf_tpu_torch import native
lib = ctypes.CDLL(str(native.build(sys.argv[1], force=True)))
lib.tsdf_png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_void_p] + [
    ctypes.c_int] * 4
out = np.empty(3, np.uint8)
raw = bytes([1, 5, 6, 7])
assert lib.tsdf_png_unfilter(raw, out.ctypes.data, 1, 3, 1, 0) == 0
assert out.tolist() == [5, 11, 18], out
print("loaded")
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "loaded"
    assert (tmp_path / native.LIB_NAME).exists()
    assert not list(tmp_path.glob("*.tmp"))
