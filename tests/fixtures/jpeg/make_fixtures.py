"""Write the image fixtures of the port's decoders and their manifest.

The files are made with OpenCV (``cv2.imencode``) from the JAX package's
synthetic orchard scene; the manifest records, for each file, the shape
and SHA-256 of ``cv2.imread``'s colour (BGR) and grey arrays, and the
digests of the JAX generator's seeded 512 x 512 scene (its mask and its
instance list). ``tests/test_torch_jpeg.py`` recomputes the manifest and
checks it against this one; ``chip_smoke.py`` checks the port's decoders
and generator against it on a machine without OpenCV.

Run from the repository root: ``python tests/fixtures/jpeg/make_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE_SEED = 14
SCENE_HW = (768, 1024)
SYNTH_SEED = 3
SYNTH_HW = (512, 512)


def sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def instances_digest(instances) -> str:
    """SHA-256 of the instance list as canonical JSON (polygon, box, flag)."""
    rows = [{"poly": np.asarray(i["poly"]).tolist(), "bbox": [float(v) for v in i["bbox"]],
             "occluded": bool(i["occluded"])} for i in instances]
    return hashlib.sha256(json.dumps(rows, sort_keys=True).encode()).hexdigest()


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment holding an EXIF IFD0 with one orientation tag."""
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1,
                                                                                  orientation, 0) + b"\0" * 4
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def png_interlaced(arr: np.ndarray) -> bytes:
    """An 8-bit Adam7-interlaced PNG of a uint8 (H, W) or (H, W, 3) RGB array."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else 3
    x = arr.reshape(h, w, c)
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = x[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if c == 1 else 2, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


def scene():
    from mingraph_unet_tpu.data.synthetic import render_orchard_scene

    return render_orchard_scene(np.random.default_rng(SCENE_SEED), *SCENE_HW)


def encoded_files() -> dict:
    """File name -> bytes of every fixture image."""
    import cv2

    img, _, _ = scene()
    crop = img[200:264, 300:380]  # 64 x 80 BGR
    q = cv2.IMWRITE_JPEG_QUALITY
    sf, sfs = cv2.IMWRITE_JPEG_SAMPLING_FACTOR, {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                                                   "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}

    def jpg(arr, *params):
        ok, buf = cv2.imencode(".jpg", arr, list(params))
        assert ok
        return buf.tobytes()

    files = {
        "scene.jpg": jpg(img, q, 85),
        "gray.jpg": jpg(cv2.cvtColor(crop, cv2.COLOR_BGR2GRAY), q, 90),
        "s444.jpg": jpg(crop, q, 90, sf, sfs["444"]),
        "s422.jpg": jpg(crop, q, 90, sf, sfs["422"]),
        "progressive.jpg": jpg(crop, q, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "restart.jpg": jpg(crop, q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "odd_37x23.jpg": jpg(crop[:23, :37], q, 75),
    }
    base = jpg(crop[:20, :40], q, 85)
    for o in (3, 6, 8):
        files[f"exif{o}.jpg"] = base[:2] + exif_app1(o) + base[2:]
    ok, buf = cv2.imencode(".png", crop.astype(np.uint16) * 257 + np.arange(80, dtype=np.uint16)[None, :, None])
    assert ok
    files["rgb16.png"] = buf.tobytes()
    files["interlaced.png"] = png_interlaced(crop[:37, :29, ::-1])
    return files


def coco(instances) -> dict:
    """The scene's COCO annotation file (JAX generator's polygons and boxes)."""
    h, w = SCENE_HW
    anns = [{"id": k + 1, "image_id": 0, "category_id": 0, "bbox": inst["bbox"],
             "segmentation": [np.asarray(inst["poly"]).reshape(-1).tolist()], "iscrowd": 0,
             "attributes": {"occluded": bool(inst["occluded"])}} for k, inst in enumerate(instances)]
    return {"images": [{"id": 0, "file_name": "scene.jpg", "height": h, "width": w}], "annotations": anns,
            "categories": [{"id": 0, "name": "mango"}]}


def manifest(directory: str) -> dict:
    """The manifest of the files in ``directory``, recomputed with OpenCV and
    the JAX generator."""
    import cv2

    from mingraph_unet_tpu.data.synthetic import render_orchard_scene

    out = {"files": {}}
    for name in sorted(encoded_files()):
        path = os.path.join(directory, name)
        colour, grey = cv2.imread(path, cv2.IMREAD_COLOR), cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        out["files"][name] = {"color_bgr": {"shape": list(colour.shape), "sha256": sha(colour)},
                              "gray": {"shape": list(grey.shape), "sha256": sha(grey)}}
    _, mask, instances = render_orchard_scene(np.random.default_rng(SYNTH_SEED), *SYNTH_HW)
    out["synthetic"] = {"seed": SYNTH_SEED, "size": list(SYNTH_HW), "mask_sha256": sha(mask),
                        "instances_sha256": instances_digest(instances), "instances": len(instances)}
    out["scene"] = {"seed": SCENE_SEED, "size": list(SCENE_HW), "annotations": "scene.json"}
    return out


def main() -> None:
    for name, data in encoded_files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    with open(os.path.join(HERE, "scene.json"), "w") as f:
        json.dump(coco(scene()[2]), f)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest(HERE), f, indent=1, sort_keys=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    main()
