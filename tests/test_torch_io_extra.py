"""The port's remaining host I/O vs the JAX package: DepthImage's ops,
the TUM cursor, PGM, BlockTSDF, the file utilities, the converters, and
the ``view`` and ``convert`` verbs.

Tolerance: none. Arrays, file bytes and printed lines are equal, with
one exception of encoding: the JAX package writes PNGs through Pillow
(adaptive row filters and its own zlib), the port through its own codec
(filter 0, the standard library's zlib), so a PNG is held by its decoded
pixels, and by the bytes of the JAX image re-encoded with the port's
codec.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsdf_tpu
import tsdf_tpu.io
import tsdf_tpu_torch.io
from tsdf_tpu.cli import main as jax_main
from tsdf_tpu.io import block_tsdf as jax_block
from tsdf_tpu.io import convert as jax_convert
from tsdf_tpu.io import file_utils as jax_files
from tsdf_tpu.io import pgm as jax_pgm
from tsdf_tpu.io import png as jax_png
from tsdf_tpu.io.depth_image import DepthImage as JaxDepthImage
from tsdf_tpu.io.tsdf_file import save_tsdf as jax_save_tsdf
from tsdf_tpu.io.tum import TUMDataLoader as JaxTUMDataLoader
from tsdf_tpu_torch import cli, make_volume
from tsdf_tpu_torch.io import block_tsdf, convert, file_utils, pgm, png
from tsdf_tpu_torch.io.depth_image import DepthImage
from tsdf_tpu_torch.io.tum import TUMDataLoader
from tsdf_tpu_torch.utils import fixtures

CPU = torch.device("cpu")
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
BLOCK_FIX = os.path.join(FIXDIR, "ref_writer.blocktsdf")
SX, SY, SZ = 3, 2, 2  # the fixture's grid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_io_exports_the_jax_names():
    assert set(tsdf_tpu_torch.io.__all__) == set(tsdf_tpu.io.__all__)
    for name in tsdf_tpu.io.__all__:
        assert hasattr(tsdf_tpu_torch.io, name), name


# -- DepthImage and the TUM cursor ------------------------------------------


def test_depth_image_ops():
    depth = np.zeros((10, 12), np.uint16)
    depth[5, 5] = 5000
    depth[2, 2] = 1000
    di = DepthImage(depth)
    assert (di.width, di.height) == (12, 10)
    scaled = di.scale_depth(0.2)
    assert scaled.data[5, 5] == 1000
    truncated = scaled.truncate_depth_to(500)
    assert truncated.data[5, 5] == 0 and truncated.data[2, 2] == 200
    assert truncated.min_max() == (200, 200)
    assert scaled.data[5, 5] == 1000  # truncate_depth_to copies
    assert DepthImage(np.zeros((3, 4), np.uint16)).min_max() == (0, 0)


def test_depth_image_ops_match_jax():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 9000, size=(48, 64)).astype(np.uint16)
    data[rng.uniform(size=data.shape) < 0.2] = 0
    ours, theirs = DepthImage(data), JaxDepthImage(data)
    assert (ours.width, ours.height) == (theirs.width, theirs.height)
    for cut in (0, 1, 4000, 65535):
        a, b = ours.truncate_depth_to(cut), theirs.truncate_depth_to(cut)
        np.testing.assert_array_equal(a.data, b.data)
        assert a.min_max() == b.min_max()
    assert ours.min_max() == theirs.min_max()


def _tum_dir(root, n=3, seed=5):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "depth"))
    lines = ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(n):
        stamp = f"{1305031102.1 + i:.4f}"
        frame = rng.integers(0, 20000, (24, 32)).astype(np.uint16)
        png.save_png(os.path.join(root, "depth", f"{stamp}.png"), frame)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.uniform(-1, 1, 3)
        lines.append(f"{stamp} " + " ".join(repr(float(v)) for v in (*t, *q)))
    with open(os.path.join(root, "ground_truth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_tum_next_walk_equals_iteration_and_jax(tmp_path):
    _tum_dir(str(tmp_path))
    loader, theirs = TUMDataLoader(str(tmp_path)), JaxTUMDataLoader(str(tmp_path))
    walked = []
    while True:
        d, p = loader.next()
        dj, pj = theirs.next()
        if d is None:
            assert dj is None and p is None and pj is None
            break
        np.testing.assert_array_equal(d.data, dj.data)
        np.testing.assert_array_equal(p, pj)
        walked.append((d, p))
    assert loader.next() == (None, None)  # stays at the end
    iterated = list(loader)  # iteration does not use the cursor
    assert len(walked) == len(iterated) == 3
    for (d, p), (di, pi) in zip(walked, iterated):
        np.testing.assert_array_equal(d.data, di.data)
        np.testing.assert_array_equal(p, pi)


# -- PGM ----------------------------------------------------------------------


def test_pgm_u16_roundtrip(tmp_path):
    img = (np.arange(48, dtype=np.uint16) * 1000).reshape(6, 8)
    p = str(tmp_path / "x.pgm")
    pgm.save_pgm(p, img)
    np.testing.assert_array_equal(pgm.load_pgm(p), img)
    jax_pgm.save_pgm(str(tmp_path / "j.pgm"), img)
    assert (tmp_path / "x.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()


def test_pgm_u8_roundtrip(tmp_path):
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    p = str(tmp_path / "x.pgm")
    pgm.save_pgm(p, img)
    np.testing.assert_array_equal(pgm.load_pgm(p), img)
    jax_pgm.save_pgm(str(tmp_path / "j.pgm"), img)
    assert (tmp_path / "x.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()


def test_pgm_header_comments_match_jax(tmp_path):
    img = np.arange(35, dtype=np.uint16).reshape(5, 7) * 1801
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5\n# made by hand\n7 5\n# max\n65535\n"
                  + img.astype(">u2").tobytes())
    np.testing.assert_array_equal(pgm.load_pgm(str(p)), img)
    np.testing.assert_array_equal(pgm.load_pgm(str(p)), jax_pgm.load_pgm(str(p)))
    (tmp_path / "bad.pgm").write_bytes(b"P2\n1 1\n255\n0")
    with pytest.raises(ValueError):
        pgm.load_pgm(str(tmp_path / "bad.pgm"))


def test_nyu_byteswap(tmp_path):
    img = np.array([[0x1234, 0xABCD]], np.uint16)
    p = tmp_path / "nyu.pgm"
    with open(p, "wb") as f:
        f.write(b"P5\n2 1\n65535\n")
        f.write(img.astype("<u2").tobytes())
    np.testing.assert_array_equal(pgm.read_nyu_depth_map(str(p)), img)


def test_read_tum_depth_map_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 65535, size=(9, 13)).astype(np.uint16)
    p = str(tmp_path / "d.png")
    png.save_png(p, img)
    got = pgm.read_tum_depth_map(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, jax_pgm.read_tum_depth_map(p))
    np.testing.assert_array_equal(got, img // 5)


# -- BlockTSDF ------------------------------------------------------------------


def _sphere_volume():
    vol = make_volume((6, 5, 4), (600.0, 500.0, 400.0), offset=(0, 0, 0),
                      device=CPU)
    vol = fixtures.sphere_tsdf(vol, 150.0)
    w = torch.arange(vol.weight.numel(), dtype=torch.float32) * 0.25
    return vol.replace(weight=w.reshape(vol.weight.shape))


def test_block_tsdf_roundtrip(tmp_path):
    vol = _sphere_volume()
    p = str(tmp_path / "vol.txt")
    block_tsdf.save_block_tsdf(vol, p)
    out = block_tsdf.load_block_tsdf(p, device=CPU)
    assert out.size == (6, 5, 4) and out.device == CPU
    assert torch.equal(out.tsdf, vol.tsdf)
    assert torch.equal(out.weight, vol.weight)
    np.testing.assert_array_equal(out.physical_size.numpy(), [600.0, 500.0, 400.0])


def test_block_tsdf_bytes_and_load_match_jax(tmp_path):
    vol = _sphere_volume()
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    block_tsdf.save_block_tsdf(vol, str(ours))
    jvol = tsdf_tpu.make_volume((6, 5, 4), (600.0, 500.0, 400.0),
                                offset=(0, 0, 0))
    jvol = jvol.replace(tsdf=vol.tsdf.numpy(), weight=vol.weight.numpy())
    jax_block.save_block_tsdf(jvol, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    loaded = block_tsdf.load_block_tsdf(str(theirs), device=CPU)
    jloaded = jax_block.load_block_tsdf(str(theirs))
    for name in ("tsdf", "weight", "physical_size", "offset",
                 "truncation_distance", "max_weight"):
        np.testing.assert_array_equal(getattr(loaded, name).numpy(),
                                      np.asarray(getattr(jloaded, name)), name)


def test_block_tsdf_comments_and_blanks(tmp_path):
    vol = make_volume((2, 2, 2), 200.0, offset=(0, 0, 0), device=CPU)
    p = tmp_path / "vol.txt"
    block_tsdf.save_block_tsdf(vol, str(p))
    p.write_text("# comment\n\n" + p.read_text())
    assert block_tsdf.load_block_tsdf(str(p), device=CPU).size == (2, 2, 2)
    p.write_text("voxel_size= 2 2 2\n")
    with pytest.raises(ValueError):
        block_tsdf.load_block_tsdf(str(p), device=CPU)


def test_blocktsdf_fixture_loads():
    vol = block_tsdf.load_block_tsdf(BLOCK_FIX, device=CPU)
    assert vol.size == (SX, SY, SZ)
    np.testing.assert_array_equal(vol.physical_size.numpy(), [300.0, 200.0, 250.0])
    for z in range(SZ):
        for y in range(SY):
            for x in range(SX):
                i = x + y * SX + z * SX * SY  # the reference's linear index
                assert float(vol.tsdf[z, y, x]) == 100.0 + i
                assert float(vol.weight[z, y, x]) == 0.5 * i


def test_blocktsdf_fixture_roundtrips_with_jax_bytes(tmp_path):
    vol = block_tsdf.load_block_tsdf(BLOCK_FIX, device=CPU)
    ours, theirs = tmp_path / "ours.blocktsdf", tmp_path / "theirs.blocktsdf"
    block_tsdf.save_block_tsdf(vol, str(ours))
    jax_block.save_block_tsdf(jax_block.load_block_tsdf(BLOCK_FIX), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    again = block_tsdf.load_block_tsdf(str(ours), device=CPU)
    assert torch.equal(again.tsdf, vol.tsdf)
    assert torch.equal(again.weight, vol.weight)


# -- file utilities -------------------------------------------------------------


def test_file_utils_match_jax(tmp_path):
    for name in ("depth_00003.png", "depth_00004.png", "colour_00003.png",
                 "notes.txt"):
        (tmp_path / name).write_text("a\n\nlast line\n\n" if "txt" in name else "")
    (tmp_path / "sub").mkdir()
    d = str(tmp_path)
    assert file_utils.files_in_directory(d) == jax_files.files_in_directory(d)
    assert "sub" not in file_utils.files_in_directory(d)
    pred = lambda f: f.endswith(".png")  # noqa: E731
    assert (file_utils.files_in_directory(d, pred)
            == jax_files.files_in_directory(d, pred)
            == ["colour_00003.png", "depth_00003.png", "depth_00004.png"])
    for args in (("depth_", 3, "", "png", "depth_00003.png"),
                 ("depth_", 3, "", "png", "depth_3.png"),
                 ("a", 12345, "_b", "txt", "a12345_b.txt")):
        assert file_utils.match_file_name(*args) == jax_files.match_file_name(*args)
    txt = str(tmp_path / "notes.txt")
    assert file_utils.read_last_line(txt) == jax_files.read_last_line(txt) == "last line"
    got, want = [], []
    file_utils.process_file_by_lines(txt, got.append)
    jax_files.process_file_by_lines(txt, want.append)
    assert got == want == ["a", "", "last line", ""]
    assert file_utils.file_exists(txt) and not file_utils.file_exists(d)


# -- converters -------------------------------------------------------------------


def test_freenect_raw11_to_mm_matches_jax():
    raw = np.arange(0, 2100, dtype=np.uint16).reshape(30, 70)
    got = convert.freenect_raw11_to_mm(raw)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, jax_convert.freenect_raw11_to_mm(raw))
    assert (got.ravel()[2047:] == 0).all()


def test_fl_2_uchar(tmp_path):
    rng = np.random.RandomState(0)
    data = rng.uniform(-4.0, 9.0, size=(2, 3, 4)).astype(np.float32)
    src = tmp_path / "vol.fl"
    with open(src, "wb") as f:
        np.array([4, 3, 2], np.uint32).tofile(f)
        np.array([1.0, 1.0, 1.0], np.float32).tofile(f)
        data.ravel().tofile(f)
    lo, hi = convert.fl_2_uchar(str(src), str(tmp_path / "ours.u8"))
    jlo, jhi = jax_convert.fl_2_uchar(str(src), str(tmp_path / "theirs.u8"))
    assert (lo, hi) == (jlo, jhi) == (float(data.min()), float(data.max()))
    out = np.fromfile(tmp_path / "ours.u8", np.uint8)
    expect = np.clip((data.ravel() - lo) * (255.0 / (hi - lo)), 0, 255
                     ).astype(np.uint8)
    np.testing.assert_array_equal(out, expect)
    assert (tmp_path / "ours.u8").read_bytes() == (tmp_path / "theirs.u8").read_bytes()
    with open(tmp_path / "short.fl", "wb") as f:
        np.array([4, 3, 2], np.uint32).tofile(f)
        np.zeros(3 + 5, np.float32).tofile(f)
    with pytest.raises(ValueError):
        convert.fl_2_uchar(str(tmp_path / "short.fl"), str(tmp_path / "x.u8"))


def _same_png(ours, theirs, tmp_path):
    """Equal pixels; and the JAX image re-encoded by the port's codec is
    the port's file byte for byte."""
    a, b = png.load_png(ours), jax_png.load_png(theirs)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    again = str(tmp_path / "reencoded.png")
    png.save_png(again, b)
    assert open(again, "rb").read() == open(ours, "rb").read()


def _freenect_pgm(path):
    rng = np.random.default_rng(3)
    raw = rng.integers(300, 1100, size=(48, 64)).astype(np.uint16)
    raw[rng.uniform(size=raw.shape) < 0.05] = 2047
    jax_pgm.save_pgm(path, raw.byteswap())  # freenect's low byte first
    return raw


@pytest.mark.parametrize("kind", ["freenect2png", "pgm2png", "fl2uchar"])
def test_convert_verb_matches_jax(kind, tmp_path, capsys):
    if kind == "fl2uchar":
        src = str(tmp_path / "vol.fl")
        rng = np.random.default_rng(2)
        with open(src, "wb") as f:
            np.array([5, 4, 3], np.uint32).tofile(f)
            np.array([50.0, 40.0, 30.0], np.float32).tofile(f)
            rng.uniform(-40.0, 25.0, 60).astype(np.float32).tofile(f)
        ext = "u8"
    else:
        src = str(tmp_path / "in.pgm")
        _freenect_pgm(src)
        ext = "png"
    ours, theirs = str(tmp_path / f"ours.{ext}"), str(tmp_path / f"theirs.{ext}")
    assert cli.main(["convert", kind, src, ours]) == 0
    printed = capsys.readouterr().out
    assert jax_main(["convert", kind, src, theirs]) == 0
    assert printed.replace(ours, theirs) == capsys.readouterr().out
    if kind == "fl2uchar":
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        assert printed.startswith("Min: ")
    else:
        _same_png(ours, theirs, tmp_path)
    if kind == "freenect2png":
        np.testing.assert_array_equal(
            png.load_png(ours),
            convert.freenect_raw11_to_mm(_freenect_pgm(str(tmp_path / "x.pgm"))))


# -- the view verb ------------------------------------------------------------------


def _view_volume(shape, seed):
    """A JAX volume whose field crosses every branch of the heat map:
    below -trunc, between, exactly 0 and +-trunc, beyond +trunc."""
    sx, sy, sz = shape
    jvol = tsdf_tpu.make_volume(shape, (10.0 * sx, 10.0 * sy, 10.0 * sz),
                                offset=(0.0, 0.0, 0.0))
    trunc = float(jvol.truncation_distance)
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.6 * trunc, 1.6 * trunc, size=(sz, sy, sx)).astype(np.float32)
    flat = d.reshape(-1)
    flat[:4] = [0.0, trunc, -trunc, np.float32(trunc) * np.float32(0.5)]
    return jvol.replace(tsdf=jnp.asarray(d))


@pytest.mark.parametrize("shape", [(20, 17, 13), (9, 16, 25), (8, 8, 8)])
def test_view_verb_matches_jax(shape, tmp_path, capsys):
    """The three tiles (top, right, front, in that order) on a volume with
    no square number of slices and one with: pixels equal JAX's cmd_view,
    and the printed lines name the same files in the same order."""
    f = str(tmp_path / "v.tsdf")
    jax_save_tsdf(_view_volume(shape, seed=sum(shape)), f)
    assert cli.main(["view", "-f", f, "-o", str(tmp_path / "ours"),
                     "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["view", "-f", f, "-o", str(tmp_path / "theirs")]) == 0
    theirs = capsys.readouterr().out
    assert ours.replace("ours", "theirs") == theirs
    assert [line.rsplit("/", 1)[-1] for line in ours.splitlines()] == [
        "top.png", "right.png", "front.png"]
    for name in ("top", "right", "front"):
        _same_png(str(tmp_path / "ours" / f"{name}.png"),
                  str(tmp_path / "theirs" / f"{name}.png"), tmp_path)


def test_view_tiles_layout():
    """Each tile is the slices laid out row by row, ceil(sqrt(n)) to a
    row, the cells past the last slice black."""
    vol = make_volume((3, 2, 5), (30.0, 20.0, 50.0), offset=(0, 0, 0),
                      device=CPU)
    vol = vol.replace(tsdf=torch.linspace(-20.0, 20.0, 30).reshape(5, 2, 3))
    tiles = dict(cli.view_tiles(vol))
    heat = cli.heat_map(vol.tsdf, vol.truncation_distance)
    front = tiles["front"]  # 5 z-slices of (2, 3): 3 columns, 2 rows
    assert tuple(front.shape) == (4, 9, 3) and front.dtype == torch.uint8
    for i in range(5):
        r, c = divmod(i, 3)
        assert torch.equal(front[2 * r:2 * r + 2, 3 * c:3 * c + 3], heat[i])
    assert not front[2:4, 6:9].any()
    # 2 y-slices of (5, 3): one row of 2; 3 x-slices of (5, 2): 2 x 2
    assert tuple(tiles["top"].shape) == (5, 2 * 3, 3)
    assert tuple(tiles["right"].shape) == (2 * 5, 2 * 2, 3)
