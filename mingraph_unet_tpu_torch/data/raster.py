"""OpenCV's drawing and resizing (OpenCV 5.0), reproduced so that the port
draws its synthetic data and instance masks and resizes its images as the
JAX package does with OpenCV, on a machine without OpenCV. Every function
equals OpenCV bit for bit but one: :func:`resize_cubic_f32` is within
2e-6.

- Drawing (the C++ of ``csrc/raster.cc``, OpenCV's fixed-point rules with
  ``XY_SHIFT`` = 16 and its rounding; 8-connected lines):
  :func:`ellipse2poly`, :func:`ellipse` (filled, whole turn),
  :func:`fill_convex_poly`, :func:`fill_poly` and :func:`polylines`. Each
  draws in place into a C-contiguous uint8 or float32 (H, W) or (H, W, C)
  array, the colour converted as ``cv2`` converts it (a number is the first
  channel; uint8 rounds half to even and saturates).
- :func:`erode` and :func:`dilate` with a square kernel of ones (OpenCV's
  default border, which never wins).
- Resizing: :func:`resize_nearest` (``INTER_NEAREST``, the source index
  from OpenCV's floating-point scale) and :func:`resize_linear_u8`
  (``INTER_LINEAR`` on uint8: 11-bit fixed-point weights, and ``INTER_AREA``
  on an exact 2x downscale), both the C++ of ``csrc/decode.cc``, and
  :func:`resize_cubic_f32` (``INTER_CUBIC``, A = -0.75, on float32; within
  2e-6 of OpenCV's, which hands it to Intel IPP's float32 code).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from mingraph_unet_tpu_torch.ops.kernels import build

__all__ = [
    "dilate",
    "ellipse",
    "ellipse2poly",
    "erode",
    "fill_convex_poly",
    "fill_poly",
    "polylines",
    "resize_cubic_f32",
    "resize_linear_u8",
    "resize_nearest",
]

XY_SHIFT = 16

# OpenCV's table of sines at 1 degree steps (seven decimals, as float).
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def _canvas(img: np.ndarray) -> Tuple[int, int, int]:
    if img.dtype not in (np.uint8, np.float32) or img.ndim not in (2, 3) or not img.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous uint8 or float32 (H, W[, C]) array, got {img.dtype} {img.shape}")
    return img.shape[0], img.shape[1], img.itemsize * (1 if img.ndim == 2 else img.shape[2])


def _color(img: np.ndarray, color) -> bytes:
    """``color`` as the raw bytes of one pixel of ``img`` (cv::scalarToRawData)."""
    vals = [float(v) for v in (color if isinstance(color, (tuple, list, np.ndarray)) else (color,))]
    cn = 1 if img.ndim == 2 else img.shape[2]
    vals = (vals + [0.0] * 4)[:cn]
    if img.dtype == np.uint8:
        return np.clip(np.rint(vals), 0, 255).astype(np.uint8).tobytes()
    return np.asarray(vals, np.float32).tobytes()


def _points(polys: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    arrs = [np.asarray(p).reshape(-1, 2) for p in polys]
    for a in arrs:
        if a.dtype.kind not in "iu":
            raise ValueError(f"points must be integers, got {a.dtype}")
    xy = np.ascontiguousarray(np.concatenate(arrs) if arrs else np.zeros((0, 2)), np.int64)
    return xy, np.asarray([len(a) for a in arrs], np.int32)


def _lib() -> ctypes.CDLL:
    return build.host_library("raster")


def _call(name: str, img: np.ndarray, *args) -> None:
    h, w, pix = _canvas(img)
    rc = getattr(_lib(), name)(img.ctypes.data, h, w, pix, *args)
    if rc != 0:
        raise ValueError(f"{name} refused its arguments (code {rc})")


def _ellipse2poly_f(center, axes, angle: int, arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """cv::ellipse2Poly on doubles: (P, 2) float64 points."""
    if not 0 < delta <= 180:
        raise ValueError(f"delta must be in (0, 180], got {delta}")
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start, arc_end = arc_start + 360, arc_end + 360
    while arc_end > 360:
        arc_start, arc_end = arc_start - 360, arc_end - 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha, beta = _SIN[450 - angle], _SIN[angle]
    a = np.minimum(np.arange(arc_start, arc_end + delta, delta), arc_end)
    a = np.where(a < 0, a + 360, a)
    x = float(axes[0]) * _SIN[450 - a]
    y = float(axes[1]) * _SIN[a]
    pts = np.stack([float(center[0]) + x * alpha - y * beta, float(center[1]) + x * beta + y * alpha], axis=1)
    if len(pts) == 1:
        pts = np.asarray([center, center], np.float64)
    return pts


def _dedup(pts: np.ndarray) -> np.ndarray:
    keep = np.ones(len(pts), bool)
    keep[1:] = (pts[1:] != pts[:-1]).any(axis=1)
    return pts[keep]


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``: the integer outline, (P, 2) int32."""
    pts = _dedup(np.rint(_ellipse2poly_f(center, axes, int(angle), int(arc_start), int(arc_end), int(delta)))
                 .astype(np.int64))
    if len(pts) == 1:
        pts = np.asarray([center, center], np.int64)
    return pts.astype(np.int32)


def ellipse(img: np.ndarray, center, axes, angle: float, start_angle: float, end_angle: float, color,
            thickness: int = -1) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, angle, start, end, color, -1)`` for a
    filled whole turn (the only form the port draws), in place."""
    start, end = int(np.rint(start_angle)), int(np.rint(end_angle))
    if thickness >= 0 or end - start < 360:
        raise ValueError("only filled whole ellipses (thickness < 0, end - start >= 360) are drawn")
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    aw, ah = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    delta = (max(aw, ah) + (1 << (XY_SHIFT - 1))) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = _ellipse2poly_f((cx, cy), (aw, ah), int(np.rint(angle)), start, end, delta)
    hi = np.rint(v / (1 << XY_SHIFT)).astype(np.int64) << XY_SHIFT
    pts = _dedup(hi + np.rint(v - hi).astype(np.int64))
    if len(pts) == 1:
        pts = np.asarray([(cx, cy), (cx, cy)], np.int64)
    xy = np.ascontiguousarray(pts, np.int64)
    _call("mgu_fill_convex_poly", img, xy.ctypes.data, len(xy), _color(img, color), XY_SHIFT)
    return img


def fill_convex_poly(img: np.ndarray, pts, color, shift: int = 0) -> np.ndarray:
    """``cv2.fillConvexPoly(img, pts, color, LINE_8, shift)``, in place."""
    xy, _ = _points([pts])
    _call("mgu_fill_convex_poly", img, xy.ctypes.data, len(xy), _color(img, color), int(shift))
    return img


def fill_poly(img: np.ndarray, polys: Sequence, color, shift: int = 0) -> np.ndarray:
    """``cv2.fillPoly(img, polys, color, LINE_8, shift)``: every ring at
    once, even-odd, in place, vertices inside the image or not."""
    xy, counts = _points(polys)
    _call("mgu_fill_poly", img, xy.ctypes.data, counts.ctypes.data, len(counts), _color(img, color), int(shift))
    return img


def polylines(img: np.ndarray, polys: Sequence, closed: bool, color, thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, polys, closed, color, thickness)`` on integer
    points, in place."""
    xy, counts = _points(polys)
    _call("mgu_polylines", img, xy.ctypes.data, counts.ctypes.data, len(counts), int(bool(closed)),
          _color(img, color), int(thickness))
    return img


def _square_radius(kernel: np.ndarray) -> int:
    k = np.asarray(kernel)
    if k.ndim != 2 or k.shape[0] != k.shape[1] or k.shape[0] % 2 == 0 or not (k != 0).all():
        raise ValueError(f"expected an odd square kernel of ones, got {k.shape}")
    return k.shape[0] // 2


def _morph(img: np.ndarray, kernel: np.ndarray, reduce, border) -> np.ndarray:
    r = _square_radius(kernel)
    h, w = img.shape[:2]
    pad = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img, pad, constant_values=border)
    x = reduce.reduce(np.stack([x[i : i + h] for i in range(2 * r + 1)]), axis=0)
    return reduce.reduce(np.stack([x[:, j : j + w] for j in range(2 * r + 1)]), axis=0)


def erode(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.erode(img, kernel)`` with a square kernel of ones (uint8)."""
    return _morph(img, kernel, np.minimum, np.iinfo(img.dtype).max)


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, kernel)`` with a square kernel of ones (uint8)."""
    return _morph(img, kernel, np.maximum, np.iinfo(img.dtype).min)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)`` of an (H, W)
    or (H, W, C) array of any dtype: source index ``floor(d * (1 / (dst /
    src)))`` in doubles, as OpenCV computes it (the C++ of
    ``csrc/decode.cc``, which ``load_batch(exact=True)`` runs too)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"expected (H, W[, C]), got {img.shape}")
    src = np.ascontiguousarray(img)
    h, w = size
    out = np.empty((h, w) + img.shape[2:], img.dtype)
    pix = img.itemsize * (1 if img.ndim == 2 else img.shape[2])
    rc = build.host_library("decode").mgu_resize_nearest(src.ctypes.data, img.shape[0], img.shape[1], pix,
                                                         out.ctypes.data, h, w)
    if rc != 0:
        raise ValueError(f"cannot resize {img.shape} to {size}")
    return out


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` on uint8
    (H, W) or (H, W, C)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected uint8 (H, W[, C]), got {img.dtype} {img.shape}")
    src = np.ascontiguousarray(img)
    h, w = size
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((h, w) + img.shape[2:], np.uint8)
    rc = build.host_library("decode").mgu_resize_linear_u8(src.ctypes.data, img.shape[0], img.shape[1], cn,
                                                           out.ctypes.data, h, w)
    if rc != 0:
        raise ValueError(f"cannot resize {img.shape} to {size}")
    return out


def _cubic_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (dst, 4), clamped, and the weights (dst, 4) of the
    cubic kernel with A = -0.75 (OpenCV's ``interpolateCubic``), in
    doubles."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    x = f - s
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1)


def resize_cubic_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)`` on a float32
    (H, W) array: rows then columns, in doubles, rounded once to float32.
    OpenCV hands this resize to Intel IPP where it has it, whose float32
    arithmetic lands within 2e-6 of this on fields near 1 (and its own
    code within 3e-7), so the result is close, not exact."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise ValueError(f"expected float32 (H, W), got {img.dtype} {img.shape}")
    xi, xa = _cubic_taps(img.shape[1], size[1])
    yi, ya = _cubic_taps(img.shape[0], size[0])
    rows = (img.astype(np.float64)[:, xi] * xa[None]).sum(-1)  # (H, W')
    return (rows[yi] * ya[:, :, None]).sum(1).astype(np.float32)
