"""The port's data layer on files, against the JAX package (which reads,
resizes and draws with OpenCV) on the same files and seeds: ``read_image``
at a size the file is not at, ``MangoDataset`` and ``BatchLoader`` over a
directory of JPEGs (EXIF orientation, grey, odd sizes, a PNG among them)
with masks and a COCO file, the instance masks of the fixture scene's
polygons, and ``infer_segmentation`` on a PNG and a JPEG not at
``resize_dim``. Decoded arrays, instance planes and label maps are equal
bit for bit. A subprocess in which ``import cv2`` fails runs the data
paths, the CLIs' smoke runs and ``run_results``' dataset stage, as a
machine without OpenCV runs them."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest

from mingraph_unet_tpu.data import annotations as j_ann
from mingraph_unet_tpu.data import dataset as j_ds
from mingraph_unet_tpu.train import infer as j_infer
from mingraph_unet_tpu_torch.data import annotations as t_ann
from mingraph_unet_tpu_torch.data import dataset as t_ds
from mingraph_unet_tpu_torch.scripts import infer_segmentation as t_infer_cli
from test_torch_scripts import S, _check_margin, run_dir, unet_weights  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jpeg")


def _smooth(rng, shape):
    return cv2.GaussianBlur(rng.integers(0, 256, shape).astype(np.uint8), (5, 5), 0)


def test_read_image_resizes_a_png_as_jax_infers(tmp_path):
    """``read_image(png, size)`` is the JAX package's inference input,
    ``cv2.resize(load_image_rgb(png), INTER_LINEAR)``, bit for bit (the C++
    loader's own bilinear came within one grey level of it)."""
    rng = np.random.default_rng(14)
    for shape, size in (((45, 61, 3), (32, 40)), ((64, 64, 3), (32, 32)), ((23, 31, 3), (64, 48))):
        path = str(tmp_path / f"{shape[0]}.png")
        cv2.imwrite(path, rng.integers(0, 256, shape).astype(np.uint8))
        np.testing.assert_array_equal(t_ds.read_image(path, size),
                                      j_ds._resize_image(j_ds.load_image_rgb(path), size))


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """Six images (JPEGs at odd sizes, an EXIF-rotated one, a grey one, a
    progressive 4:2:0 one, a PNG), a PNG mask of each at its read size, and
    a COCO file with polygons on four of them and a box-only annotation."""
    root = tmp_path_factory.mktemp("jpeg_dir")
    img_dir, mask_dir = root / "images", root / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.default_rng(3)
    q = cv2.IMWRITE_JPEG_QUALITY

    def jpg(arr, *params):
        return cv2.imencode(".jpg", arr, [q, 85, *params])[1].tobytes()

    rotated = jpg(_smooth(rng, (30, 40, 3)))
    tiff = b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00\x00\x00\x06\x00\x00\x00\x00\x00\x00\x00"
    payload = b"Exif\x00\x00" + tiff
    files = {
        "a.jpg": jpg(_smooth(rng, (50, 70, 3))),
        "b.jpg": jpg(_smooth(rng, (37, 23))),
        "c.jpg": rotated[:2] + b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload + rotated[2:],
        "d.png": cv2.imencode(".png", _smooth(rng, (48, 48, 3)))[1].tobytes(),
        "e.jpg": jpg(_smooth(rng, (64, 80, 3)), cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "f.jpg": jpg(_smooth(rng, (33, 47, 3)), cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
    }
    images, anns = [], []
    for k, (name, data) in enumerate(sorted(files.items())):
        (img_dir / name).write_bytes(data)
        h, w = cv2.imread(str(img_dir / name)).shape[:2]
        cv2.imwrite(str(mask_dir / f"{os.path.splitext(name)[0]}.png"), rng.integers(0, 3, (h, w)).astype(np.uint8))
        if name == "d.png":
            continue  # an image the annotation file does not name
        images.append({"id": k, "file_name": name, "height": h, "width": w})
        for j in range(int(rng.integers(1, 4))):
            n = int(rng.integers(3, 9))
            poly = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1).astype(float)
            x0, y0 = poly.min(0)
            x1, y1 = poly.max(0)
            anns.append({"id": len(anns) + 1, "image_id": k, "category_id": 0,
                         "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1], "segmentation": [poly.reshape(-1).tolist()],
                         "iscrowd": 0})
        if name == "e.jpg":
            anns.append({"id": len(anns) + 1, "image_id": k, "category_id": 0, "bbox": [3.0, 4.0, 20.0, 9.0],
                         "segmentation": [], "iscrowd": 1})
    ann_file = str(root / "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 0, "name": "mango"}]}, f)
    return str(img_dir), str(mask_dir), ann_file


def _assert_items_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("masks", [True, False], ids=["mask_folder", "no_masks"])
@pytest.mark.parametrize("annotated", [True, False], ids=["coco", "plain"])
@pytest.mark.parametrize("size", [(32, 32), (40, 56)])
def test_mango_dataset_over_jpegs_matches_jax(jpeg_dir, masks, annotated, size, capsys):
    """Every item equal to JAX's; ``strict=False`` never reaches its zeros
    (nor says so) on files the decoder takes."""
    img_dir, mask_dir, ann = jpeg_dir
    kw = dict(mask_dir=mask_dir if masks else None, image_size=size, annotations_file=ann if annotated else None,
              max_instances=3, strict=False)
    td, jd = t_ds.MangoDataset(img_dir, **kw), j_ds.MangoDataset(img_dir, **kw)
    assert len(td) == len(jd) == 6
    for i in range(len(td)):
        _assert_items_equal(td[i], jd[i])
    assert "WARNING" not in capsys.readouterr().out


@pytest.mark.parametrize("use_native", [True, False], ids=["thread_pool", "one_by_one"])
@pytest.mark.parametrize("annotated", [True, False], ids=["coco", "plain"])
def test_batch_loader_over_jpegs_matches_jax(jpeg_dir, use_native, annotated):
    img_dir, mask_dir, ann = jpeg_dir
    kw = dict(mask_dir=mask_dir, image_size=(40, 56), annotations_file=ann if annotated else None, max_instances=3)
    tl = t_ds.BatchLoader(t_ds.MangoDataset(img_dir, use_native=use_native, **kw), 3, seed=5)
    jl = j_ds.BatchLoader(j_ds.MangoDataset(img_dir, **kw), 3, seed=5)
    for epoch in (0, 1):
        got, ref = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(ref) == 2
        for gb, rb in zip(got, ref):
            _assert_items_equal(gb, rb)


def test_mango_dataset_strict_raises_the_cause(jpeg_dir, tmp_path):
    """A truncated JPEG raises with its cause (strict), or gives zeros and
    a warning, as in JAX (``strict=False``)."""
    img_dir, _, _ = jpeg_dir
    d = tmp_path / "images"
    shutil.copytree(img_dir, d)
    data = (d / "a.jpg").read_bytes()
    (d / "a.jpg").write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        t_ds.MangoDataset(str(d), image_size=(32, 32))[0]
    img, mask = t_ds.MangoDataset(str(d), image_size=(32, 32), strict=False)[0]
    assert not img.any() and not mask.any()


@pytest.mark.parametrize("out_hw,max_instances", [(None, None), ((512, 512), 8), ((384, 512), 40), ((97, 61), 3)])
def test_scene_instance_masks_match_jax(out_hw, max_instances):
    """The fixture scene's COCO polygons (1024 x 768) filled and resized."""
    path = os.path.join(FIXTURES, "scene.json")
    got = t_ann.CocoAnnotations(path).instance_masks_for(0, out_hw, max_instances)
    ref = j_ann.CocoAnnotations(path).instance_masks_for(0, out_hw, max_instances)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape and got.any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_hw", [None, (48, 64)])
def test_border_polygon_instance_masks_match_jax(tmp_path, out_hw):
    """Polygons that reach the right and bottom border (x = W, y = H after
    rounding, as COCO and CVAT exports give them) or run off the image:
    the rounded points are not clipped, so the fill's clipped edges decide
    these masks."""
    w, h = 61, 45
    rng = np.random.default_rng(7)
    anns = []
    for k in range(96):
        n = int(rng.integers(3, 9))
        xs = rng.uniform(-30.0, w + 30.0, n)
        ys = rng.uniform(-30.0, h + 30.0, n)
        edge = rng.integers(0, n, 2)
        xs[edge[0]], ys[edge[1]] = w - rng.uniform(0.0, 0.5), h + rng.uniform(-0.5, 0.5)
        seg = np.stack([xs, ys], 1).ravel().round(2).tolist()
        anns.append({"id": k + 1, "image_id": 1, "category_id": 1, "segmentation": [seg],
                     "bbox": [0, 0, 1, 1], "area": 1.0, "iscrowd": 0})
    path = tmp_path / "border.json"
    path.write_text(json.dumps({"images": [{"id": 1, "file_name": "a.jpg", "width": w, "height": h}],
                                "annotations": anns, "categories": [{"id": 1, "name": "mango"}]}))
    got = t_ann.CocoAnnotations(str(path)).instance_masks_for(1, out_hw)
    ref = j_ann.CocoAnnotations(str(path)).instance_masks_for(1, out_hw)
    assert got.shape == ref.shape == (96, *(out_hw or (h, w))) and got.any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_infer_segmentation_not_at_resize_dim_matches_jax(fmt, run_dir, unet_weights, tmp_path):
    """One of the run's images at 45 x 61 (the config's ``resize_dim`` is
    32²): the port's input is JAX's exactly, and the label maps are
    equal."""
    _, cfg_dir, image = run_dir
    jdir, tdir = unet_weights
    path = str(tmp_path / f"scene.{fmt}")
    cv2.imwrite(path, cv2.resize(cv2.imread(image), (61, 45), interpolation=cv2.INTER_CUBIC))
    rgb = t_ds.read_image(path, (S, S))
    np.testing.assert_array_equal(rgb, j_ds._resize_image(j_ds.load_image_rgb(path), (S, S)))
    _check_margin(cfg_dir, tdir, rgb)
    ref = j_infer.infer_segmentation(cfg_dir, path, jdir, str(tmp_path / "j"))
    got = t_infer_cli.main(["--config_path", cfg_dir, "--image_path", path, "--weights_path", tdir,
                            "--output_dir", str(tmp_path / "t"), "--cpu"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    for key in ("label_path", "vis_path"):
        np.testing.assert_array_equal(cv2.imread(got[key], cv2.IMREAD_UNCHANGED),
                                      cv2.imread(ref[key], cv2.IMREAD_UNCHANGED))


_NO_OPENCV = textwrap.dedent("""
    import json, os, shutil, sys, tempfile
    sys.modules["cv2"] = None  # import cv2 raises ImportError, as where OpenCV is not installed
    import numpy as np
    from mingraph_unet_tpu_torch.data.dataset import BatchLoader, MangoDataset
    from mingraph_unet_tpu_torch.data.synthetic import generate_orchard_dataset
    from mingraph_unet_tpu_torch.scripts import graph_refinement, infer_segmentation, train_end_to_end
    from mingraph_unet_tpu_torch.scripts import train_segmentation
    from mingraph_unet_tpu_torch.utils.bootstrap import make_dummy_run

    fixtures, root = sys.argv[1], tempfile.mkdtemp()
    cfg = make_dummy_run(os.path.join(root, "run"), num_images=4, image_size=(32, 32), with_annotations=True)
    # run_results' dataset stage at --quick
    generate_orchard_dataset(os.path.join(root, "orchard"), 12, 4, 6, (64, 64), max_fruits=6)
    # a JPEG + COCO epoch: the fixture scene twice
    img_dir = os.path.join(root, "jpeg")
    os.makedirs(img_dir)
    coco = json.load(open(os.path.join(fixtures, "scene.json")))
    for k in range(2):
        shutil.copy(os.path.join(fixtures, "scene.jpg"), os.path.join(img_dir, f"scene_{k}.jpg"))
    coco["images"] = [dict(coco["images"][0], id=k, file_name=f"scene_{k}.jpg") for k in range(2)]
    coco["annotations"] = [dict(a, id=100 * k + a["id"], image_id=k) for k in range(2) for a in coco["annotations"]]
    ann = os.path.join(root, "scene.json")
    json.dump(coco, open(ann, "w"))
    for native in (True, False):
        ds = MangoDataset(img_dir, image_size=(64, 64), annotations_file=ann, max_instances=4, use_native=native)
        (imgs, masks, inst), = BatchLoader(ds, 2).epoch(0)
        assert imgs.shape == (2, 64, 64, 3) and inst.shape == (2, 4, 64, 64) and masks.any() and inst.any()
    # the four CLIs' smoke runs
    train_segmentation.main(["--cpu", "--epochs", "1"])
    train_end_to_end.main(["--cpu", "--epochs", "1"])
    infer_segmentation.main(["--cpu", "--output_dir", os.path.join(root, "infer")])
    graph_refinement.main(["--cpu"])
    assert sys.modules["cv2"] is None
    shutil.rmtree(root)
    print("NO_OPENCV_OK")
""")


def test_data_paths_and_smoke_runs_without_opencv():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_OPENCV, FIXTURES], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_OPENCV_OK" in proc.stdout
    for cli in ("train_segmentation", "train_end_to_end", "infer_segmentation", "graph_refinement"):
        assert f"[smoke] {cli} OK" in proc.stdout
