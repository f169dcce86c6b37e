"""The port's image decoders (``csrc/decode.cc`` through
``data/native_loader.py::decode``) against ``cv2.imread``, colour and grey,
bit for bit: every committed fixture (``tests/fixtures/jpeg``), JPEGs that
hypothesis encodes with ``cv2.imencode`` (sizes 1-97, quality 10-100,
progressive, restart intervals, optimised tables, 4:4:4 / 4:2:2 / 4:2:0),
EXIF orientations, 16-bit and interlaced PNGs, BMPs; the files the decoder
refuses, each with its cause; and the fixtures' manifest, recomputed with
OpenCV and the JAX generator."""

import importlib.util
import json
import os
import struct

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from mingraph_unet_tpu_torch.data import native_loader

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jpeg")
MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))

_spec = importlib.util.spec_from_file_location("make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)


def _assert_reads_like_cv2(path):
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = native_loader.decode(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    np.testing.assert_array_equal(native_loader.decode(path, gray=True), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_decodes_like_cv2(name):
    _assert_reads_like_cv2(os.path.join(FIXTURES, name))


def test_manifest_recomputed_with_cv2_and_jax():
    """The committed files are what the fixture script encodes now, and the
    manifest is what OpenCV and the JAX generator give for them."""
    for name, data in make_fixtures.encoded_files().items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
    assert make_fixtures.manifest(FIXTURES) == MANIFEST
    with open(os.path.join(FIXTURES, "scene.json")) as f:
        assert json.load(f) == json.loads(json.dumps(make_fixtures.coco(make_fixtures.scene()[2])))


def test_fixture_digests_of_the_port():
    """The check the card machine runs: each digest of the port's decode."""
    for name, rec in MANIFEST["files"].items():
        path = os.path.join(FIXTURES, name)
        colour = np.ascontiguousarray(native_loader.decode(path)[..., ::-1])
        grey = native_loader.decode(path, gray=True)
        assert [list(colour.shape), make_fixtures.sha(colour)] == [rec["color_bgr"]["shape"],
                                                                   rec["color_bgr"]["sha256"]]
        assert [list(grey.shape), make_fixtures.sha(grey)] == [rec["gray"]["shape"], rec["gray"]["sha256"]]


SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(h=st.integers(1, 97), w=st.integers(1, 97), grey=st.booleans(), smooth=st.booleans(),
       quality=st.integers(10, 100), progressive=st.booleans(), restart=st.integers(0, 4), optimize=st.booleans(),
       sampling=st.sampled_from(sorted(SAMPLING)), seed=st.integers(0, 2**31 - 1))
def test_encoded_jpeg_decodes_like_cv2(tmp_path, h, w, grey, smooth, quality, progressive, restart, optimize,
                                       sampling, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w) if grey else (h, w, 3)).astype(np.uint8)
    if smooth:
        img = cv2.GaussianBlur(img, (7, 7), 0)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    _assert_reads_like_cv2(path)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("byte_order", ["II", "MM"])
def test_exif_orientation_applied_as_imread(tmp_path, orientation, byte_order):
    img = np.random.default_rng(orientation).integers(0, 256, (12, 30, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", cv2.GaussianBlur(img, (5, 5), 0))
    e = "<" if byte_order == "II" else ">"
    tiff = (byte_order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\0" * 4)
    payload = b"Exif\0\0" + tiff
    data = buf.tobytes()
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:])
    _assert_reads_like_cv2(path)
    assert native_loader.decode(path).shape[:2] == ((30, 12) if orientation >= 5 else (12, 30))


@pytest.mark.parametrize("shape", [(1, 1), (9, 5), (13, 17, 3), (33, 40, 3)])
def test_png_interlaced_and_16_bit_like_cv2(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "i.png")
    with open(path, "wb") as f:
        f.write(make_fixtures.png_interlaced(arr[..., ::-1] if arr.ndim == 3 else arr))
    _assert_reads_like_cv2(path)
    wide = rng.integers(0, 65536, shape).astype(np.uint16)
    wide[::3] = wide[::3, :1] if wide.ndim == 2 else wide[::3, :, :1]  # grey pixels among colour ones
    cv2.imwrite(path, wide)
    _assert_reads_like_cv2(path)


@pytest.mark.parametrize("shape", [(7, 9), (13, 5, 3), (40, 33, 3)])
def test_bmp_and_png_like_cv2(tmp_path, shape):
    arr = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    for ext in (".bmp", ".png"):
        path = str(tmp_path / f"x{ext}")
        cv2.imwrite(path, arr)
        _assert_reads_like_cv2(path)


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the first scan's
    data, ``end`` past the segment."""
    pos, out = 2, []
    while pos < len(data):
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2 : pos + 4])[0]
        out.append((marker, pos, pos + 2 + length))
        if marker == 0xDA:
            break
        pos += 2 + length
    return out


@pytest.fixture(scope="module")
def base_jpeg():
    img = np.random.default_rng(5).integers(0, 256, (24, 32, 3)).astype(np.uint8)
    return cv2.imencode(".jpg", cv2.GaussianBlur(img, (5, 5), 0))[1].tobytes()


def _edit_sof(data, fn):
    marker, start, end = next(s for s in _segments(data) if s[0] in (0xC0, 0xC1, 0xC2))
    seg = bytearray(data[start:end])
    fn(seg)
    return data[:start] + bytes(seg) + data[end:]


def _refused(tmp_path, data, cause):
    path = str(tmp_path / "r.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=cause):
        native_loader.decode(path)


def test_refuses_arithmetic_coding(tmp_path, base_jpeg):
    _refused(tmp_path, _edit_sof(base_jpeg, lambda s: s.__setitem__(1, 0xC9)), "arithmetic")


def test_refuses_12_bit(tmp_path, base_jpeg):
    _refused(tmp_path, _edit_sof(base_jpeg, lambda s: s.__setitem__(4, 12)), "8-bit")


def test_refuses_lossless(tmp_path, base_jpeg):
    _refused(tmp_path, _edit_sof(base_jpeg, lambda s: s.__setitem__(1, 0xC3)), "lossless")


def test_refuses_cmyk(tmp_path, base_jpeg):
    _refused(tmp_path, _edit_sof(base_jpeg, lambda s: s.__setitem__(9, 4)), "CMYK")


def test_refuses_rgb_coded(tmp_path, base_jpeg):
    """An Adobe APP14 segment with transform 0 (RGB) and no JFIF marker."""
    segs = _segments(base_jpeg)
    jfif = next(s for s in segs if s[0] == 0xE0)
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + b"\x00\x64\x00\x00\x00\x00\x00"
    _refused(tmp_path, base_jpeg[: jfif[1]] + adobe + base_jpeg[jfif[2] :], "RGB-coded")


def test_refuses_truncated(tmp_path, base_jpeg):
    _refused(tmp_path, base_jpeg[: len(base_jpeg) * 2 // 3], "truncated")
    _refused(tmp_path, base_jpeg[:200], "truncated")


def test_refuses_corrupt(tmp_path, base_jpeg):
    sos = next(s for s in _segments(base_jpeg) if s[0] == 0xDA)
    _refused(tmp_path, base_jpeg[: sos[2]] + b"\xff\x00" * 40 + b"\xff\xd9", "corrupt")  # no code is all ones
    dht = next(s for s in _segments(base_jpeg) if s[0] == 0xC4)
    _refused(tmp_path, base_jpeg[: dht[1]] + base_jpeg[dht[2] :], "corrupt")  # no Huffman tables


def test_refuses_what_is_not_an_image(tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="not a PNG, JPEG or BMP"):
        native_loader.decode(str(path))
    png = cv2.imencode(".png", np.zeros((8, 8), np.uint8))[1].tobytes()
    path.write_bytes(png[: len(png) - 20])
    with pytest.raises(ValueError, match="truncated"):
        native_loader.decode(str(path))
    with pytest.raises(FileNotFoundError, match="cannot open"):
        native_loader.decode(str(tmp_path / "missing.jpg"))
