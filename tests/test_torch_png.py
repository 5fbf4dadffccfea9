"""The port's PNG reader and writer (gcd_tpu_torch/data/png.py and the host
C++ unfilter, gcd_tpu_torch/native/png.cpp) on the CPU.

The reader decodes PNGs that cv2 (libpng) writes, gray, RGB and RGBA, noisy
and smooth, with each of the five row filters forced and with libpng's
adaptive choice among all five, to the same pixels as
cv2.imread(..., IMREAD_UNCHANGED) with its BGR(A) order reversed: bit for
bit. The C++ unfilter equals the plain Python one on random rows of every
filter type; what the writer writes reads back, and cv2 reads it too;
palette, 16-bit and interlaced files, bad CRCs, short streams and unknown
filter types raise.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from gcd_tpu_torch import native
from gcd_tpu_torch.data import png

CV2_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP, "average": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(channels: int, kind: str, h: int = 37, w: int = 53) -> np.ndarray:
    """(h, w, channels) uint8: uniform noise, or smooth ramps whose rows and
    columns predict each other (which the adaptive filter choice exploits)."""
    if kind == "noise":
        return np.random.default_rng(channels).integers(0, 256, (h, w, channels), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(3 * xx + 5 * c * yy + xx * yy // 7) % 256 for c in range(channels)],
                    axis=-1).astype(np.uint8)


def _cv2_read(path: str) -> np.ndarray:
    """cv2.imread(IMREAD_UNCHANGED) as (H, W, C) in file channel order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        return img[..., None]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)


def _filter_types(path: str) -> set:
    """The filter-type bytes of a PNG's rows."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = list(png._chunks(data, path))
    (h,) = struct.unpack(">I", chunks[0][1][4:8])
    raw = zlib.decompress(b"".join(p for tag, p in chunks if tag == b"IDAT"))
    return set(np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_read_png_is_cv2_s_bit_for_bit(tmp_path, channels, kind):
    img = _image(channels, kind)
    bgr = img[..., 0] if channels == 1 else np.concatenate([img[..., 2::-1], img[..., 3:]], -1)
    used = set()
    for name, flag in CV2_FILTERS.items():
        path = str(tmp_path / f"{name}.png")
        assert cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_FILTER, flag])
        got = png.read_png(path)
        assert got.dtype == np.uint8 and got.shape == img.shape
        assert np.array_equal(got, _cv2_read(path)), name
        assert np.array_equal(got, img), name
        used |= _filter_types(path)
    assert used == {0, 1, 2, 3, 4}


def test_adaptive_filtering_uses_every_filter_type(tmp_path):
    """libpng's adaptive choice alone mixes all five types a file."""
    path = str(tmp_path / "adaptive.png")
    cv2.imwrite(path, _image(3, "noise"), [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    assert _filter_types(path) == {0, 1, 2, 3, 4}
    assert np.array_equal(png.read_png(path), _cv2_read(path))


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_write_png_round_trips_each_filter(tmp_path, filter_type, channels):
    """Every row of one filter type, hand-built by write_png: read_png gives
    the pixels back, and cv2 decodes the same file to them too."""
    img = _image(channels, "noise" if channels % 2 else "smooth", 19, 23)
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filters=filter_type)
    assert _filter_types(path) == {filter_type}
    assert np.array_equal(png.read_png(path), img)
    if channels != 2:  # cv2 expands gray + alpha to four channels
        assert np.array_equal(_cv2_read(path), img)


def test_write_png_takes_a_filter_a_row_and_gray_planes(tmp_path):
    img = _image(3, "smooth", 41, 29)
    path = str(tmp_path / "rows.png")
    png.write_png(path, img, filters=np.arange(41) % 5)
    assert _filter_types(path) == {0, 1, 2, 3, 4}
    assert np.array_equal(png.read_png(path), img)
    png.write_png(path, img[..., 0])
    assert np.array_equal(png.read_png(path), img[..., :1])
    with pytest.raises(ValueError, match="filter types must be 0-4"):
        png.write_png(path, img, filters=5)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, img.astype(np.uint16))


@pytest.mark.parametrize("bpp,width", [(1, 1), (1, 9), (2, 5), (3, 1), (3, 17), (4, 8)])
def test_native_unfilter_equals_the_plain_version(bpp, width):
    """Random filtered rows (random bytes, random filter types): the C++ and
    Python reconstructions agree byte for byte, including rows narrower
    than a pixel's lead and the first row's zero "up"."""
    rng = np.random.default_rng(bpp * 100 + width)
    h, row_bytes = 11, width * bpp
    rows = rng.integers(0, 256, (h, row_bytes + 1), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h)
    rows[:5, 0] = np.arange(5)  # every type, the first row included
    got = native.png_unfilter(rows, h, row_bytes, bpp)
    want = png.unfilter_plain(rows.tobytes(), h, row_bytes, bpp)
    assert np.array_equal(got, want)


def test_plain_unfilter_follows_the_specification():
    """One 2-byte-pixel row pair by hand: Average floors (a + b) / 2 in
    integers wider than a byte, Paeth breaks ties a, then b, then c."""
    rows = np.array([[0, 200, 100, 250, 30],     # None: 200 100 250 30
                     [3, 10, 20, 1, 2],          # Average
                     ], dtype=np.uint8)
    out = png.unfilter_plain(rows.tobytes(), 2, 4, 2)
    # Average: byte 0: a = 0, b = 200 -> 10 + 100; byte 1: a = 0, b = 100
    # -> 20 + 50; byte 2: a = 110, b = 250 -> 1 + 180 (360 / 2, not
    # (360 - 256) / 2); byte 3: a = 70, b = 30 -> 2 + 50.
    assert out[1].tolist() == [110, 70, 181, 52]
    assert png._paeth(10, 10, 10) == 10 and png._paeth(1, 5, 1) == 5
    assert png._paeth(5, 1, 1) == 5  # p = 5: a is nearest
    assert png._paeth(3, 9, 6) == 6  # p = 6: c is nearest
    assert np.array_equal(native.png_unfilter(rows, 2, 4, 2), out)


def _chunk(tag: bytes, data: bytes, crc_ok: bool = True) -> bytes:
    crc = (zlib.crc32(tag + data) & 0xFFFFFFFF) ^ (0 if crc_ok else 1)
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _png_bytes(width, height, depth, color, interlace, raw, crc_ok=True, extra=b""):
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw), crc_ok) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color,interlace,match", [
    (8, 3, 0, "bit depth 8, colour type 3"),
    (16, 2, 0, "bit depth 16, colour type 2"),
    (8, 2, 1, "interlace 1"),
    (4, 0, 0, "bit depth 4"),
])
def test_unsupported_pngs_raise_naming_the_header(tmp_path, depth, color, interlace, match):
    """Palette (with its PLTE chunk), 16-bit, Adam7 and sub-byte files."""
    path = tmp_path / "bad.png"
    extra = _chunk(b"PLTE", bytes(6)) if color == 3 else b""
    path.write_bytes(_png_bytes(4, 2, depth, color, interlace, bytes(2 * 25), extra=extra))
    with pytest.raises(ValueError, match=match):
        png.read_png(str(path))


def test_real_16_bit_and_palette_files_raise(tmp_path):
    """What cv2 and PIL write: a 16-bit RGB file and a palette file."""
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.full((4, 5, 3), 40000, np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)
    from PIL import Image  # the test host has it; the card's machine need not

    Image.fromarray(np.zeros((4, 5), np.uint8), mode="L").convert("P").save(
        str(tmp_path / "pal.png"))
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(str(tmp_path / "pal.png"))


def test_corrupt_files_raise(tmp_path):
    path = tmp_path / "c.png"
    raw = bytes([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12] * 2)  # 2 rows of 4 RGB pixels
    path.write_bytes(_png_bytes(4, 2, 8, 2, 0, raw))
    assert png.read_png(str(path)).shape == (2, 4, 3)
    path.write_bytes(_png_bytes(4, 2, 8, 2, 0, raw, crc_ok=False))
    with pytest.raises(ValueError, match="bad CRC in chunk b'IDAT'"):
        png.read_png(str(path))
    path.write_bytes(_png_bytes(4, 2, 8, 2, 0, raw[:-5]))
    with pytest.raises(ValueError, match="expected 26 .*width 4, height 2"):
        png.read_png(str(path))
    path.write_bytes(_png_bytes(4, 2, 8, 2, 0, raw)[:-30])
    with pytest.raises(ValueError, match="truncated"):
        png.read_png(str(path))
    path.write_bytes(_png_bytes(4, 2, 8, 2, 0, bytes([7]) + raw[1:]))
    with pytest.raises(ValueError, match="row 0: filter type 7"):
        png.read_png(str(path))
    path.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(path))


def test_read_png_raises_when_the_unfilter_cannot_be_built(monkeypatch, tmp_path):
    """No compiler: the reader raises; nothing decodes in its place."""
    path = str(tmp_path / "ok.png")
    png.write_png(path, _image(3, "noise", 4, 4))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_png_lib", None)
    with pytest.raises(RuntimeError, match="cannot build the native png"):
        png.read_png(path)
