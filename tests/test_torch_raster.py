"""The port's copy of OpenCV's drawing and resizing (``data/raster.py``,
``csrc/raster.cc``, the resize of ``csrc/decode.cc``) against ``cv2`` on
the same arrays, driven by hypothesis: every drawing function and
``INTER_NEAREST`` / ``INTER_LINEAR`` equal bit for bit, ``INTER_CUBIC`` on
float32 within 2e-6 (OpenCV hands that resize to Intel IPP, whose float32
arithmetic the port does not copy: it is not exact)."""

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from mingraph_unet_tpu_torch.data import raster

SETTINGS = settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])

sizes = st.tuples(st.integers(1, 70), st.integers(1, 70))
colors = st.tuples(*[st.floats(-20, 300, allow_nan=False)] * 3)
# (dtype, channels) of the canvases OpenCV and the port draw on.
canvases = st.sampled_from([(np.uint8, 1), (np.uint8, 3), (np.float32, 1), (np.float32, 3)])


def _canvas(data, hw, kind):
    dtype, ch = kind
    shape = hw if ch == 1 else (*hw, ch)
    seed = data.draw(st.integers(0, 2**31 - 1))
    return (np.random.default_rng(seed).random(shape) * 40).astype(dtype)


def _points(data, hw, n, margin):
    h, w = hw
    xs = data.draw(st.lists(st.integers(-margin, w + margin), min_size=n, max_size=n))
    ys = data.draw(st.lists(st.integers(-margin, h + margin), min_size=n, max_size=n))
    return np.stack([xs, ys], axis=1).astype(np.int32)


@SETTINGS
@given(data=st.data(), hw=sizes, kind=canvases, color=colors,
       axes=st.tuples(st.integers(0, 200), st.integers(0, 200)), angle=st.floats(-720, 720, allow_nan=False))
def test_ellipse_matches_cv2(data, hw, kind, color, axes, angle):
    """Filled ellipses, centres inside and off the image, axes 0-200, float
    angles (rounded as OpenCV rounds them)."""
    center = (data.draw(st.integers(-150, hw[1] + 150)), data.draw(st.integers(-150, hw[0] + 150)))
    img = _canvas(data, hw, kind)
    want, got = img.copy(), img.copy()
    cv2.ellipse(want, center, axes, angle, 0, 360, color, -1)
    raster.ellipse(got, center, axes, angle, 0, 360, color, -1)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(center=st.tuples(st.integers(-300, 300), st.integers(-300, 300)),
       axes=st.tuples(st.integers(0, 200), st.integers(0, 200)), angle=st.integers(-720, 720),
       arc=st.tuples(st.integers(-400, 400), st.integers(-400, 400)), delta=st.integers(1, 180))
def test_ellipse2poly_matches_cv2(center, axes, angle, arc, delta):
    np.testing.assert_array_equal(raster.ellipse2poly(center, axes, angle, arc[0], arc[1], delta),
                                  cv2.ellipse2Poly(center, axes, angle, arc[0], arc[1], delta))


@SETTINGS
@given(data=st.data(), hw=sizes, kind=canvases, color=colors, thickness=st.sampled_from([1, 2]),
       closed=st.booleans(), n=st.integers(1, 7), rings=st.integers(1, 3))
def test_polylines_matches_cv2(data, hw, kind, color, thickness, closed, n, rings):
    """Thickness 1 (8-connected line) and 2 (the thick line's quadrilateral
    and round caps), open and closed, points inside and off the image."""
    polys = [_points(data, hw, n, 40) for _ in range(rings)]
    img = _canvas(data, hw, kind)
    want, got = img.copy(), img.copy()
    cv2.polylines(want, polys, closed, color, thickness)
    raster.polylines(got, polys, closed, color, thickness)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(data=st.data(), hw=sizes, n=st.integers(1, 9), shift=st.sampled_from([0, 4, 16]))
def test_fill_convex_poly_matches_cv2(data, hw, n, shift):
    """Any point set (convex or not), inside and off the image, at integer
    and fixed-point coordinates."""
    pts = _points(data, (hw[0] << shift, hw[1] << shift), n, 30 << shift)
    want, got = np.zeros(hw, np.uint8), np.zeros(hw, np.uint8)
    cv2.fillConvexPoly(want, pts, 7, cv2.LINE_8, shift)
    raster.fill_convex_poly(got, pts, 7, shift)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(data=st.data(), hw=sizes, kind=canvases, color=colors, rings=st.integers(1, 4), n=st.integers(1, 10))
def test_fill_poly_matches_cv2(data, hw, kind, color, rings, n):
    """Random non-convex, self-intersecting and multi-ring polygons, with
    vertices inside the image, on its last row and column, at x = W and
    y = H (where rounded COCO coordinates land), and up to 40 px off it."""
    margin = data.draw(st.sampled_from([0, 1, 40]))
    polys = [_points(data, hw, n, margin) for _ in range(rings)]
    img = _canvas(data, hw, kind)
    want, got = img.copy(), img.copy()
    cv2.fillPoly(want, polys, color)
    raster.fill_poly(got, polys, color)
    np.testing.assert_array_equal(got, want)


def test_fill_poly_cases():
    """Hand-made cases: a bow tie, a ring with a hole, a sliver, a point,
    collinear vertices, one on the last row and column, one reaching x = W
    and y = H, and edges that leave the image (their clipped line flat or
    not, a two-point ring lying left of it)."""
    cases = [
        [[[2, 2], [20, 14], [20, 2], [2, 14]]],
        [[[1, 1], [22, 1], [22, 15], [1, 15]], [[6, 5], [16, 5], [16, 11], [6, 11]]],
        [[[3, 3], [21, 4], [3, 5]]],
        [[[7, 7]]],
        [[[0, 0], [5, 5], [10, 10], [0, 10]]],
        [[[23, 0], [23, 15], [0, 15]]],
        [[[10, 2], [24, 3], [24, 16], [5, 16]]],
        [[[0, 2], [-4, 6]]],
        [[[-9, 3], [1, 31]]],
        [[[-9, 3], [3, 31]]],
        [[[3, 10], [30, -2]]],
        [[[-5, -5], [30, 4], [12, 22], [-3, 12]]],
    ]
    for rings in cases:
        polys = [np.asarray(r, np.int32) for r in rings]
        want, got = np.zeros((16, 24), np.uint8), np.zeros((16, 24), np.uint8)
        cv2.fillPoly(want, polys, 1)
        raster.fill_poly(got, polys, 1)
        np.testing.assert_array_equal(got, want)


@SETTINGS
@given(data=st.data(), hw=sizes, k=st.integers(1, 3), op=st.sampled_from(["erode", "dilate"]),
       density=st.floats(0.05, 0.95))
def test_erode_dilate_match_cv2(data, hw, k, op, density):
    seed = data.draw(st.integers(0, 2**31 - 1))
    m = (np.random.default_rng(seed).random(hw) < density).astype(np.uint8) * data.draw(st.integers(1, 255))
    kernel = np.ones((2 * k + 1, 2 * k + 1), np.uint8)
    np.testing.assert_array_equal(getattr(raster, op)(m, kernel), getattr(cv2, op)(m, kernel))


# Every ratio from 1/4 to 4x (the source sizes below 4 go up to 64).
ratios = st.tuples(st.integers(1, 96), st.integers(1, 96)).flatmap(
    lambda s: st.tuples(st.just(s), st.tuples(st.integers(max(1, -(-s[0] // 4)), 4 * s[0]),
                                              st.integers(max(1, -(-s[1] // 4)), 4 * s[1]))))


@SETTINGS
@given(data=st.data(), shapes=ratios, ch=st.sampled_from([1, 3]), dtype=st.sampled_from([np.uint8, np.int32,
                                                                                          np.float32]))
def test_resize_nearest_matches_cv2(data, shapes, ch, dtype):
    (h, w), size = shapes
    seed = data.draw(st.integers(0, 2**31 - 1))
    img = np.random.default_rng(seed).integers(0, 256, (h, w) if ch == 1 else (h, w, ch)).astype(dtype)
    np.testing.assert_array_equal(raster.resize_nearest(img, size),
                                  cv2.resize(img, size[::-1], interpolation=cv2.INTER_NEAREST))


@SETTINGS
@given(data=st.data(), shapes=ratios, ch=st.sampled_from([1, 3]), halve=st.booleans())
def test_resize_linear_u8_matches_cv2(data, shapes, ch, halve):
    """INTER_LINEAR on uint8 at every ratio, and exact halving (where
    OpenCV takes INTER_AREA)."""
    (h, w), size = shapes
    if halve:
        size, (h, w) = (h, w), (2 * h, 2 * w)
    seed = data.draw(st.integers(0, 2**31 - 1))
    img = np.random.default_rng(seed).integers(0, 256, (h, w) if ch == 1 else (h, w, ch)).astype(np.uint8)
    np.testing.assert_array_equal(raster.resize_linear_u8(img, size),
                                  cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR))


@SETTINGS
@given(data=st.data(), src=st.tuples(st.integers(2, 40), st.integers(2, 40)),
       dst=st.tuples(st.integers(1, 600), st.integers(1, 600)))
def test_resize_cubic_f32_within_2e6_of_cv2(data, src, dst):
    """Fields in [0.5, 1.3], as the lighting field draws them."""
    seed = data.draw(st.integers(0, 2**31 - 1))
    field = np.random.default_rng(seed).uniform(0.5, 1.3, src).astype(np.float32)
    got = raster.resize_cubic_f32(field, dst)
    want = cv2.resize(field, dst[::-1], interpolation=cv2.INTER_CUBIC)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-6


def test_refusals():
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(ValueError, match="whole"):
        raster.ellipse(img, (4, 4), (2, 2), 0, 0, 180, 1, -1)
    with pytest.raises(ValueError, match="whole"):
        raster.ellipse(img, (4, 4), (2, 2), 0, 0, 360, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        raster.fill_poly(np.zeros((8, 8, 3), np.uint8)[:, :, 0], [np.int32([[0, 0], [4, 4], [0, 4]])], 1)
    with pytest.raises(ValueError, match="integers"):
        raster.fill_poly(img, [np.float32([[0, 0], [4, 4], [0, 4]])], 1)
    with pytest.raises(ValueError, match="kernel"):
        raster.erode(img, np.ones((2, 2), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        raster.resize_linear_u8(img.astype(np.float32), (4, 4))
