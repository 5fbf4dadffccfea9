"""Write the data files beside this script: matplotlib's `plasma` and
`magma` colour tables and a glyph atlas of cv2.putText's text, which the
port reads (utils/draw.py) on machines that have neither library.

    python gcd_tpu_torch/assets/make_assets.py

Needs matplotlib and cv2 (the JAX package's test host has both); the
package never imports this script (this directory is not a package).

colormaps.npz: `plasma` and `magma`, each the (256, 3) float64 RGB rows of
the colormap's lookup table (`cmap(np.arange(256))[:, :3]`), so that
indexing them as matplotlib indexes its table gives its colours bit for bit.

glyphs.npz: each printable ASCII character drawn alone by
`cv2.putText(img, c, org, FONT_HERSHEY_SIMPLEX, 0.5, white, 1, LINE_AA)` on
a black uint8 image: its pixels (one channel; the three are equal) cropped
to their bounding box, the box's offset from `org` and the character's
advance. putText places the glyphs in fixed point with 16 fraction bits:
at scale 0.5 a character's advance is (right - left) * 32768, and every
advance of this font is an even number of those half pixels, so each
glyph starts on a whole pixel and one phase of each is all a string needs
(checked here). The arrays: `codes` (95,), `dy`, `dx` (box offsets from
org), `height`, `width` (box size), `advance` (pixels), `offset` (into
`pixels`, each box row-major).
"""

from __future__ import annotations

import os

import cv2
import matplotlib
import numpy as np
from matplotlib import colormaps

HERE = os.path.dirname(os.path.abspath(__file__))
SCALE = 0.5
CANVAS, ORG = (80, 120), (40, 40)  # (H, W), (x, y): every glyph fits inside


def colour_tables() -> dict:
    return {name: np.asarray(colormaps[name](np.arange(256))[:, :3], np.float64)
            for name in ("plasma", "magma")}


def glyph_atlas() -> dict:
    out = {k: [] for k in ("codes", "dy", "dx", "height", "width", "advance", "offset")}
    pixels = []
    n = 0
    for code in range(32, 127):
        c = chr(code)
        img = np.zeros((*CANVAS, 3), np.uint8)
        cv2.putText(img, c, ORG, cv2.FONT_HERSHEY_SIMPLEX, SCALE, (255.0, 255.0, 255.0), 1,
                    cv2.LINE_AA)
        assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all()
        img = img[..., 0]
        # getTextSize of the character twice: round(2 * advance * scale + 1),
        # an integer when the advance is a whole number of pixels.
        (w2, _), _ = cv2.getTextSize(c + c, cv2.FONT_HERSHEY_SIMPLEX, SCALE, 1)
        assert (w2 - 1) % 2 == 0, f"{c!r}: an advance of half a pixel"
        ys, xs = np.nonzero(img)
        if len(ys):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            assert 0 < y0 and y1 < CANVAS[0] and 0 < x0 and x1 < CANVAS[1]
        else:
            y0 = y1 = ORG[1]
            x0 = x1 = ORG[0]
        box = img[y0:y1, x0:x1]
        for k, v in (("codes", code), ("dy", y0 - ORG[1]), ("dx", x0 - ORG[0]),
                     ("height", y1 - y0), ("width", x1 - x0), ("advance", (w2 - 1) // 2),
                     ("offset", n)):
            out[k].append(v)
        pixels.append(box.ravel())
        n += box.size
    arrays = {k: np.asarray(v, np.int32) for k, v in out.items()}
    arrays["pixels"] = np.concatenate(pixels).astype(np.uint8)
    return arrays


def main() -> None:
    np.savez_compressed(os.path.join(HERE, "colormaps.npz"), **colour_tables(),
                        matplotlib=np.array(matplotlib.__version__))
    np.savez_compressed(os.path.join(HERE, "glyphs.npz"), **glyph_atlas(),
                        cv2=np.array(cv2.__version__))


if __name__ == "__main__":
    main()
