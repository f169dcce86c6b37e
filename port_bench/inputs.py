"""Seeded orchard-like tiles: uint8 RGB images (N, H, W, 3) and their
fruit masks (N, H, W) in {0, 1}, made with numpy.

A tile is foliage (a green base, a brightness field over 32-pixel cells,
uniform per-pixel noise) with 6 to 14 fruit: filled ellipses of yellow to
orange, each with a radial shading; the mask marks the fruit. Every batch
of one size costs the same work whatever the seed: the seed moves the
fruit, their sizes and colours, never the shapes of the arrays. The
full-size arrays are made in int16 (about 0.4 s for 32 tiles of 512²).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CELL = 32
NOISE = 12  # ± grey levels of per-pixel noise


def tiles(seed: int, stream: int, n: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch ``stream`` of the run seeded by ``seed``: ``n`` tiles of h × w."""
    rng = np.random.default_rng([int(seed) % (1 << 63), stream])
    hc, wc = -(-h // CELL), -(-w // CELL)
    base = np.array([60.0, 110.0, 45.0]) + rng.normal(0, 8, (n, 1, 1, 3))
    cells = np.rint(base * rng.normal(1.0, 0.18, (n, hc, wc, 1))).astype(np.int16)
    img = np.repeat(np.repeat(cells, CELL, axis=1), CELL, axis=2)[:, :h, :w]
    img += rng.integers(-NOISE, NOISE + 1, (n, h, w, 3), dtype=np.int16)
    mask = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        for _ in range(int(rng.integers(6, 15))):
            ry, rx = rng.uniform(0.03, 0.09, 2) * (h, w)
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            y0, y1 = int(max(0, cy - ry)), int(min(h, cy + ry + 1))
            x0, x1 = int(max(0, cx - rx)), int(min(w, cx + rx + 1))
            if y0 >= y1 or x0 >= x1:
                continue
            yy, xx = np.ogrid[y0:y1, x0:x1]
            d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            inside = d <= 1.0
            colour = np.array([rng.uniform(200, 250), rng.uniform(120, 200), rng.uniform(20, 60)])
            shade = (1.0 - 0.35 * d)[..., None] * colour + rng.integers(-6, 7, d.shape + (3,))
            img[i, y0:y1, x0:x1][inside] = np.rint(shade[inside]).astype(np.int16)
            mask[i, y0:y1, x0:x1][inside] = 1
    return np.clip(img, 0, 255).astype(np.uint8), mask
