"""Colour tables and text for the port's images: matplotlib's colormaps and
cv2.putText's text, which the card's machine has neither of.

Both come from data files in gcd_tpu_torch/assets/, written by
assets/make_assets.py from the test host's matplotlib 3.10.8 and cv2 5.0.0:
  * `colormap(name, x)`: `plasma` and `magma` (256 RGB rows each), indexed
    by matplotlib's rule, so the colours are `matplotlib.colormaps[name](x)
    [..., :3]` bit for bit;
  * `draw_text(img01, text, org)`: cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, 0.5, white, 1, LINE_AA) on the image quantised
    to uint8, as scripts/eval_utils.py draw_text calls it (the galleries'
    one use). Each character is putText's own pixels of it alone on black
    (the atlas: every advance of the font at scale 0.5 is a whole pixel, so
    one phase a glyph), composited in order with white over the image:
    out = 255 - round((255 - out) * (255 - glyph) / 255), integer.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
TEXT_SCALE = 0.5


@functools.lru_cache(maxsize=None)
def _colour_tables() -> Dict[str, np.ndarray]:
    with np.load(os.path.join(ASSETS, "colormaps.npz")) as z:
        return {k: z[k] for k in ("plasma", "magma")}


@functools.lru_cache(maxsize=None)
def _glyphs() -> Dict[str, Tuple[int, int, int, np.ndarray]]:
    """{character: (dy, dx, advance, pixels)} of the atlas."""
    with np.load(os.path.join(ASSETS, "glyphs.npz")) as z:
        a = {k: z[k] for k in z.files}
    out = {}
    for i, code in enumerate(a["codes"]):
        h, w, o = int(a["height"][i]), int(a["width"][i]), int(a["offset"][i])
        out[chr(code)] = (int(a["dy"][i]), int(a["dx"][i]), int(a["advance"][i]),
                          a["pixels"][o:o + h * w].reshape(h, w))
    return out


def colormap(name: str, x: np.ndarray) -> np.ndarray:
    """matplotlib.colormaps[name](x)[..., :3] (float64) for `plasma` or
    `magma`: a float x indexes row int(x * 256), x == 1 the last row,
    below 0 the first, above 1 the last, NaN black; an integer x indexes
    its row, clipped the same way."""
    lut = _colour_tables()[name]
    n = len(lut)
    xa = np.array(x, copy=True)
    if xa.dtype.kind == "f":
        xa *= n
        xa[xa == n] = n - 1
    under, over = xa < 0, xa >= n
    bad = np.isnan(xa) if xa.dtype.kind == "f" else np.zeros(xa.shape, bool)
    with np.errstate(invalid="ignore"):
        xa = xa.astype(int)
    xa[under], xa[over], xa[bad] = 0, n - 1, 0
    rgb = lut[xa]
    rgb[bad] = 0.0
    return rgb


def draw_text(img01: np.ndarray, text: str, org: Tuple[int, int] = (6, 18),
              scale: float = TEXT_SCALE) -> np.ndarray:
    """scripts/eval_utils.py draw_text in white at scale 0.5: the (H, W, C)
    image in [0, 1] quantised to uint8, `text` drawn with its baseline's
    left end at `org` (x, y), back in [0, 1] as float32. A character
    outside the printable ASCII range raises, as putText does."""
    if scale != TEXT_SCALE:
        raise ValueError(f"draw_text: the glyph atlas is of scale {TEXT_SCALE}, not {scale}")
    img = np.ascontiguousarray((np.clip(img01, 0.0, 1.0) * 255.0).astype(np.uint8))
    out = img.astype(np.int32)
    glyphs = _glyphs()
    h, w = out.shape[:2]
    x = int(org[0])
    for c in text:
        if c not in glyphs:
            raise ValueError(f"draw_text: {c!r} is not printable ASCII")
        dy, dx, advance, pixels = glyphs[c]
        y0, x0 = int(org[1]) + dy, x + dx
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + pixels.shape[0], h), min(x0 + pixels.shape[1], w)
        if ye > ys and xe > xs:
            d = out[ys:ye, xs:xe]
            g = pixels[ys - y0:ye - y0, xs - x0:xe - x0].astype(np.int32)
            g = g.reshape(g.shape + (1,) * (d.ndim - 2))
            out[ys:ye, xs:xe] = 255 - ((255 - d) * (255 - g) + 127) // 255
        x += advance
    return out.astype(np.uint8).astype(np.float32) / 255.0
