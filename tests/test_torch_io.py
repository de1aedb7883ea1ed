"""tsdf_tpu_torch host I/O vs Pillow and the JAX package.

Tolerance: none. Decoded PNG pixels, .tsdf bytes, loaded fields and TUM
frames/poses must be identical.
"""

import dataclasses
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tsdf_tpu
from tsdf_tpu.io import png as jax_png
from tsdf_tpu.io import tsdf_file as jax_tsdf
from tsdf_tpu.io.tum import TUMDataLoader as JaxTUMDataLoader
from tsdf_tpu_torch import TSDFVolume
from tsdf_tpu_torch.io import png, tsdf_file
from tsdf_tpu_torch.io.tum import TUMDataLoader

CPU = torch.device("cpu")
TESTS = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(TESTS, "goldens")
REF_TSDF = os.path.join(TESTS, "fixtures", "ref_writer.tsdf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in several worker processes: torch's default of one
    # thread per core oversubscribes the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pil(path):
    return jax_png.load_png(path)


@pytest.mark.parametrize("name", ["scene.png", "normals.png", "color.png"])
def test_png_decode_matches_pil_on_goldens(name):
    path = os.path.join(GOLDENS, name)
    got = png.load_png(path)
    want = _pil(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filtered_png(path, img, bpp, depth, ctype):
    """Encode with every row filter in turn (0..4), as a reference
    encoder would, to exercise each unfilter path."""
    h = img.shape[0]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = bytearray()
    prior = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        ftype = y % 5
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw.append(ftype)
        raw.extend(((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize(
    "kind", ["u16", "u8", "rgb"],
)
def test_png_all_row_filters_match_pil(tmp_path, kind):
    rng = np.random.default_rng(3)
    if kind == "u16":
        img = rng.integers(0, 65536, (23, 37)).astype(np.uint16)
        enc = img.astype(">u2")
        args = (2, 16, 0)
    elif kind == "u8":
        img = rng.integers(0, 256, (23, 37)).astype(np.uint8)
        enc, args = img, (1, 8, 0)
    else:
        img = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
        enc, args = img, (3, 8, 2)
    path = str(tmp_path / "f.png")
    _filtered_png(path, enc, *args)
    np.testing.assert_array_equal(_pil(path), img)
    got = png.load_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["u16", "u8", "rgb"])
def test_png_round_trips_with_pil(tmp_path, kind):
    rng = np.random.default_rng(4)
    # smooth depth-like content makes Pillow choose a mix of filters
    yy, xx = np.mgrid[0:120, 0:160]
    base = (4000 + 30 * xx + 17 * yy + rng.integers(0, 9, (120, 160)))
    img = {
        "u16": base.astype(np.uint16),
        "u8": (base % 256).astype(np.uint8),
        "rgb": np.stack([base % 256, xx, yy], -1).astype(np.uint8),
    }[kind]
    pil_path = str(tmp_path / "pil.png")
    ours = str(tmp_path / "ours.png")
    jax_png.save_png(pil_path, img)
    png.save_png(ours, img)
    np.testing.assert_array_equal(png.load_png(pil_path), img)
    np.testing.assert_array_equal(_pil(ours), img)
    assert Image.open(ours).mode == Image.open(pil_path).mode


def _jax_volume(size=(6, 5, 4), seed=0, with_color=False):
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    vol = tsdf_tpu.make_volume(size, (300.0, 200.0, 250.0),
                               offset=(-10.0, -20.0, 30.0),
                               with_color=with_color)
    vol = vol.replace(
        tsdf=jnp.asarray(rng.normal(size=(sz, sy, sx)).astype(np.float32)),
        weight=jnp.asarray(rng.uniform(0, 9, (sz, sy, sx)).astype(np.float32)),
        global_rotation=jnp.asarray([0.1, 0.2, 0.3], jnp.float32),
        global_translation=jnp.asarray([1.0, 2.0, 3.0], jnp.float32),
    )
    if with_color:
        vol = vol.replace(color=jnp.asarray(
            rng.integers(0, 256, (sz, sy, sx, 3)).astype(np.uint8)))
    return vol


def _to_port(jvol):
    return TSDFVolume.from_numpy(
        **{f.name: (None if getattr(jvol, f.name) is None
                    else np.asarray(getattr(jvol, f.name)))
           for f in dataclasses.fields(jvol)},
        device=CPU,
    )


@pytest.mark.parametrize("with_color", [False, True])
def test_tsdf_files_byte_identical_both_ways(tmp_path, with_color):
    jvol = _jax_volume(with_color=with_color)
    a, b = str(tmp_path / "jax.tsdf"), str(tmp_path / "port.tsdf")
    jax_tsdf.save_tsdf(jvol, a)
    tsdf_file.save_tsdf(_to_port(jvol), b)
    assert open(a, "rb").read() == open(b, "rb").read()

    # port save -> JAX load, and JAX save -> port load, field by field
    from_port = jax_tsdf.load_tsdf(b)
    from_jax = tsdf_file.load_tsdf(a, device=CPU).to_numpy()
    for f in dataclasses.fields(jvol):
        want = getattr(jvol, f.name)
        got_j = getattr(from_port, f.name)
        got_t = from_jax[f.name]
        if want is None:
            # no colour: both loaders read the zero colour block
            if f.name == "color":
                assert not np.asarray(got_j).any() and not got_t.any()
            else:
                assert got_j is None and got_t is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(got_j), np.asarray(want))
        np.testing.assert_array_equal(got_t, np.asarray(want), err_msg=f.name)


def test_ref_writer_fixture_loads_every_field(tmp_path):
    sx, sy, sz = 3, 2, 2
    vol = tsdf_file.load_tsdf(REF_TSDF, device=CPU)
    assert vol.size == (sx, sy, sz)
    assert tuple(vol.tsdf.shape) == (sz, sy, sx)
    np.testing.assert_allclose(vol.physical_size.numpy(), [300.0, 200.0, 250.0])
    np.testing.assert_allclose(vol.offset.numpy(), [-10.0, -20.0, 30.0])
    assert float(vol.truncation_distance) == pytest.approx(25.5)
    assert float(vol.max_weight) == pytest.approx(15.0)
    np.testing.assert_allclose(vol.global_translation.numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_allclose(vol.global_rotation.numpy(),
                               np.float32([0.1, 0.2, 0.3]))
    jvol = jax_tsdf.load_tsdf(REF_TSDF)
    for z in range(sz):
        for y in range(sy):
            for x in range(sx):
                i = x + y * sx + z * sx * sy
                assert vol.tsdf[z, y, x] == 100.0 + i
                assert vol.weight[z, y, x] == 0.5 * i
                assert vol.color[z, y, x].tolist() == [i, 2 * i, 3 * i]
    # the fixture's warp field is not the identity: both keep it
    np.testing.assert_array_equal(vol.deform.numpy(), np.asarray(jvol.deform))
    np.testing.assert_array_equal(vol.deform_rot.numpy(),
                                  np.asarray(jvol.deform_rot))
    out = tmp_path / "again.tsdf"
    tsdf_file.save_tsdf(vol, str(out))
    assert out.read_bytes() == open(REF_TSDF, "rb").read()


def test_tum_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "depth").mkdir()
    lines = ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(3):
        stamp = f"{1305031102.1 + i:.4f}"
        frame = rng.integers(0, 20000, (48, 64)).astype(np.uint16)
        jax_png.save_png(tmp_path / "depth" / f"{stamp}.png", frame)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.uniform(-1, 1, 3)
        lines.append(f"{stamp} " + " ".join(repr(float(v)) for v in (*t, *q)))
    lines.append("")
    (tmp_path / "ground_truth.txt").write_text("\n".join(lines))

    ours = list(TUMDataLoader(str(tmp_path)))
    theirs = list(JaxTUMDataLoader(str(tmp_path)))
    assert len(ours) == len(theirs) == 3
    for (d, p), (dj, pj) in zip(ours, theirs):
        assert d.data.dtype == dj.data.dtype == np.uint16
        np.testing.assert_array_equal(d.data, dj.data)
        np.testing.assert_array_equal(p, pj)
