"""A PNG reader and writer of the port's own: zlib from the standard library
and the five PNG row filters (the card's machine has no cv2, imageio or PIL).

    img = read_png(path)            # (H, W, C) uint8, C = 1, 2, 3 or 4
    write_png(path, img, filters=np.arange(h) % 5)

`read_png` decodes 8-bit, non-interlaced gray (colour type 0), RGB (2), gray
+ alpha (4) and RGBA (6) images, in the file's channel order (RGB, not
cv2's BGR), from any number of IDAT chunks. The filters are undone by host
C++ (native/png.cpp): Average and Paeth carry a dependency along each row.
Everything else raises ValueError naming the header's fields: palette
images, 16-bit samples, Adam7 interlacing, a bad CRC, a short or corrupt
stream. `unfilter_plain` is the same reconstruction in Python, for the
tests.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

from gcd_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels, for the 8-bit types the reader takes.
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    """(tag, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated chunk header at byte {pos}")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        if len(payload) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: chunk {tag!r} truncated ({len(payload)} of {n} bytes)")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        yield tag, payload
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit non-interlaced PNG, C = 1 (gray),
    2 (gray + alpha), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for tag, payload in _chunks(data, path):
        if header is None:
            if tag != b"IHDR" or len(payload) != 13:
                raise ValueError(f"{path}: the first chunk is {tag!r}, not a 13-byte IHDR")
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    fields = (f"width {width}, height {height}, bit depth {depth}, colour type {color}, "
              f"compression {compression}, filter method {filter_method}, "
              f"interlace {interlace}")
    if (depth != 8 or color not in CHANNELS or compression != 0 or filter_method != 0
            or interlace != 0 or width == 0 or height == 0):
        raise ValueError(f"{path}: unsupported PNG ({fields}); the reader takes 8-bit, "
                         "non-interlaced gray, gray + alpha, RGB and RGBA")
    if not idat:
        raise ValueError(f"{path}: no IDAT chunk ({fields})")
    channels = CHANNELS[color]
    row_bytes = width * channels
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({fields}): {e}") from e
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected "
                         f"{height * (row_bytes + 1)} ({fields})")
    try:
        pixels = native.png_unfilter(np.frombuffer(raw, dtype=np.uint8), height, row_bytes,
                                     channels)
    except ValueError as e:
        raise ValueError(f"{path}: {e} ({fields})") from e
    return pixels.reshape(height, width, channels)


def unfilter_plain(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """native.png_unfilter in Python: (height, row_bytes) uint8."""
    src = np.frombuffer(raw, dtype=np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), dtype=np.uint8)
    prev = np.zeros(row_bytes, dtype=np.int64)
    for y in range(height):
        kind, line = int(src[y, 0]), src[y, 1:].astype(np.int64)
        row = np.zeros(row_bytes, dtype=np.int64)
        if kind == 0:
            row = line
        elif kind == 2:
            row = (line + prev) % 256
        elif kind in (1, 3, 4):
            for i in range(row_bytes):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    pred = _paeth(a, b, c)
                row[i] = (line[i] + pred) % 256
        else:
            raise ValueError(f"row {y}: filter type {kind} is not one of PNG's five (0-4)")
        out[y] = row
        prev = row
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def filter_rows(pixels: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Filter (H, row_bytes) uint8 rows, row y with type filters[y]: (H, 1 +
    row_bytes) uint8, each row led by its type byte. The encoder predicts
    from the unfiltered neighbours, so every type is a whole-array
    operation."""
    x = pixels.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    filters = np.asarray(filters, dtype=np.int64)
    pred = preds[filters, np.arange(x.shape[0])]
    out = np.empty((x.shape[0], x.shape[1] + 1), dtype=np.uint8)
    out[:, 0] = filters
    out[:, 1:] = ((x - pred) % 256).astype(np.uint8)
    return out


def write_png(path: str, img: np.ndarray,
              filters: Union[int, Sequence[int], np.ndarray] = 0) -> None:
    """(H, W) or (H, W, C) uint8 as an 8-bit PNG: gray (C = 1), gray + alpha
    (2), RGB (3) or RGBA (4). `filters` is the filter type of every row or
    one type a row: 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"write_png takes (H, W[, 1-4]) uint8, not {img.shape} {img.dtype}")
    h, w, ch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    filters = np.broadcast_to(np.asarray(filters, dtype=np.int64), (h,))
    if filters.min() < 0 or filters.max() > 4:
        raise ValueError(f"filter types must be 0-4, not {sorted(set(filters.tolist()))}")
    rows = filter_rows(np.ascontiguousarray(img).reshape(h, w * ch), filters, ch)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
