"""The data slice of mingraph_unet_tpu_torch against the JAX package on the
CPU, on the same files and seeds: COCO annotations (``data/annotations.py``),
the instance-carrying ``MangoDataset`` and ``BatchLoader``, the instances
through ``device_preprocess_batch``, the synthetic orchard scenes
(``data/synthetic.py``), ``utils/bootstrap.py::make_dummy_run``, the C++
PNG loader (``data/native_loader.py``, built by ``ops/kernels/build.py``)
and ``data/collection.py::FrameExtractor``.

Everything here is host numpy and OpenCV, so it is held bit for bit: arrays
equal, files equal byte for byte. The augmented images are f32 and held
within 1e-5 of their scale, as ``tests/test_torch_train.py`` holds them.
"""

import ctypes
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.data import annotations as j_ann
from mingraph_unet_tpu.data import collection as j_col
from mingraph_unet_tpu.data import dataset as j_ds
from mingraph_unet_tpu.data import native_loader as j_nl
from mingraph_unet_tpu.data import synthetic as j_syn
from mingraph_unet_tpu.ops import image as j_image
from mingraph_unet_tpu.utils import bootstrap as j_boot
from mingraph_unet_tpu_torch.data import annotations as t_ann
from mingraph_unet_tpu_torch.data import collection as t_col
from mingraph_unet_tpu_torch.data import dataset as t_ds
from mingraph_unet_tpu_torch.data import native_loader as t_nl
from mingraph_unet_tpu_torch.data import synthetic as t_syn
from mingraph_unet_tpu_torch.ops import image as t_image
from mingraph_unet_tpu_torch.ops.kernels import build
from mingraph_unet_tpu_torch.utils import bootstrap as t_boot
from test_torch_train import _jax_draws, _rel_err

REPO = Path(__file__).resolve().parents[1]


def _png(path, arr):
    import cv2

    assert cv2.imwrite(str(path), arr)


def _coco_fixture(tmp_path, module):
    """Three images and annotations that take every branch: a polygon, a
    box-only annotation flagged occluded, a crowd, a polygon too short to
    fill (its box instead), two polygons in one annotation, six objects on
    one image (more than ``max_instances``) and an image without any."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(3)
    for name in ("a.png", "b.png", "c.png", "z.png"):  # z.png has no entry
        _png(img_dir / name, rng.integers(0, 256, (40, 60, 3), np.uint8))
    images = [{"id": i, "file_name": n, "height": 40, "width": 60} for i, n in ((1, "a.png"), (2, "b.png"),
                                                                                (3, "c.png"))]
    anns = [
        {"id": 10, "image_id": 1, "category_id": 0, "bbox": [10.0, 5.0, 20.0, 20.0],
         "segmentation": [[20, 5, 30, 15, 20, 25, 10, 15]], "iscrowd": 0},
        {"id": 11, "image_id": 1, "category_id": 1, "bbox": [40.4, 20.6, 10.2, 8.3],
         "attributes": {"occluded": True}},
        {"id": 12, "image_id": 1, "category_id": 0, "bbox": [1.0, 30.0, 6.0, 6.0], "segmentation": [[1, 30, 7, 30]]},
        {"id": 13, "image_id": 1, "category_id": 0, "bbox": [30.0, 28.0, 25.0, 10.0],
         "segmentation": [[30.2, 28.7, 40.5, 28.1, 40.0, 37.9], [45, 28, 55, 28, 50, 37.6]]},
        {"id": 14, "image_id": 2, "category_id": 0, "bbox": [0.0, 0.0, 5.0, 5.0], "iscrowd": 1},
    ] + [{"id": 20 + k, "image_id": 3, "category_id": 0, "bbox": [3.0 * k, 2.0 * k, 4.0 + k, 3.0 + 2 * k]}
         for k in range(6)]
    return str(img_dir), module.write_coco_json(str(tmp_path / "ann.json"), images, anns)


def test_write_coco_json_bytes_match_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    _, jann = _coco_fixture(tmp_path / "j", j_ann)
    _, tann = _coco_fixture(tmp_path / "t", t_ann)
    assert Path(jann).read_bytes() == Path(tann).read_bytes()
    default = t_ann.write_coco_json(str(tmp_path / "d.json"), [], [])
    assert json.loads(Path(default).read_text())["categories"] == [{"id": 0, "name": "mango"}]


@pytest.mark.parametrize("out_hw,max_instances", [(None, None), ((40, 60), 4), ((23, 37), 3), ((64, 96), 8)])
def test_coco_instance_masks_and_objects_match_jax(tmp_path, out_hw, max_instances):
    """Polygons (one, two, too short), box fallback with rounding, resize
    (down and up, nearest), ``max_instances`` cut (the largest kept) and
    padding: bit-equal; objects, occlusion and categories equal."""
    _, ann = _coco_fixture(tmp_path, j_ann)
    ja, ta = j_ann.CocoAnnotations(ann), t_ann.CocoAnnotations(ann)
    assert ta.file_to_id == ja.file_to_id and ta.categories == ja.categories
    for image_id in (1, 2, 3):
        assert ta.objects_for(image_id) == ja.objects_for(image_id)
        got = ta.instance_masks_for(image_id, out_hw, max_instances)
        ref = j_ann.CocoAnnotations(ann).instance_masks_for(image_id, out_hw, max_instances)
        assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    occluded = [o["occluded"] for o in ta.objects_for(1)] + [o["occluded"] for o in ta.objects_for(2)]
    assert occluded == [False, True, False, False, True]
    assert ta.id_for_file("/somewhere/else/b.png") == 2 and ta.id_for_file("z.png") is None


def test_yield_image_dataset_items_match_jax(tmp_path):
    img_dir, ann = _coco_fixture(tmp_path, j_ann)
    jd, td = j_ann.YieldImageDataset(img_dir, ann), t_ann.YieldImageDataset(img_dir, ann)
    assert len(td) == len(jd) == 3 and [p for p, _ in td.items] == [p for p, _ in jd.items]
    for i in range(len(td)):
        (ji, jc, jo), (ti, tc, to) = jd[i], td[i]
        np.testing.assert_array_equal(ti, ji)
        assert (tc, to) == (jc, jo)
        np.testing.assert_array_equal(td.instance_masks(i, (20, 30), 5), jd.instance_masks(i, (20, 30), 5))
    with pytest.raises(FileNotFoundError, match="No annotated images"):
        t_ann.YieldImageDataset(str(tmp_path), ann)


# ---------------------------------------------------------------------------
# MangoDataset and BatchLoader with instances
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def annotated_run(tmp_path_factory):
    """JAX's ``make_dummy_run(with_annotations=True)`` data at 48², 6 images."""
    base = tmp_path_factory.mktemp("annotated")
    j_boot.make_dummy_run(str(base), num_images=6, image_size=(48, 48), with_annotations=True, seed=4)
    train = base / "data" / "train"
    return str(train / "images"), str(train / "masks"), str(train / "annotations.json")


@pytest.mark.parametrize("with_masks", [True, False], ids=["mask_folder", "instance_union"])
@pytest.mark.parametrize("size", [(48, 48), (40, 56)], ids=["own_size", "resized"])
def test_mango_dataset_instance_items_match_jax(annotated_run, with_masks, size):
    """``(img, mask, inst)`` items bit-equal to JAX's: with a mask folder,
    and without one (the mask is the union of the instances); resized."""
    img_dir, mask_dir, ann = annotated_run
    kw = dict(mask_dir=mask_dir if with_masks else None, image_size=size, annotations_file=ann, max_instances=3)
    jd, td = j_ds.MangoDataset(img_dir, **kw), t_ds.MangoDataset(img_dir, **kw)
    assert len(td) == len(jd) == 6
    for i in range(len(td)):
        got, ref = td[i], jd[i]
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
    if not with_masks:
        np.testing.assert_array_equal(td[0][1], td[0][2].any(0).astype(np.int32))


def test_mango_dataset_unlisted_image_and_lenient_zeros(tmp_path, annotated_run):
    """An image the annotation file does not name gets empty instances; a
    broken file under ``strict=False`` gives zeros in all three columns."""
    img_dir, _, ann = annotated_run
    d = tmp_path / "images"
    d.mkdir()
    for name in sorted(os.listdir(img_dir))[:2]:
        (d / name).write_bytes((Path(img_dir) / name).read_bytes())
    (d / "img_999.png").write_bytes((Path(img_dir) / "img_000.png").read_bytes())
    (d / "img_zz.png").write_bytes(b"not a png")
    kw = dict(image_size=(48, 48), annotations_file=ann, max_instances=4, strict=False)
    jd, td = j_ds.MangoDataset(str(d), **kw), t_ds.MangoDataset(str(d), **kw)
    for i in range(4):
        for g, r in zip(td[i], jd[i]):
            np.testing.assert_array_equal(g, r)
    assert not td[2][2].any() and not td[3][0].any() and td[3][2].shape == (4, 48, 48)
    with pytest.raises(FileNotFoundError):
        t_ds.MangoDataset(str(d), image_size=(48, 48), annotations_file=ann)[3]


@pytest.mark.parametrize("case", ["instances", "native", "native_no_masks", "cv2"])
def test_batch_loader_epochs_match_jax(annotated_run, case, monkeypatch):
    """Two epochs of (img, mask[, inst]) batches equal to the JAX loader's,
    in the same shuffled order; with ``use_native`` the C++ loader decodes
    every batch (the instance batches as OpenCV does), without it none."""
    img_dir, mask_dir, ann = annotated_run
    kw = dict(mask_dir=None if case == "native_no_masks" else mask_dir, image_size=(48, 48),
              annotations_file=ann if case == "instances" else None, max_instances=3, use_native=case != "cv2")
    native_calls = []
    real = t_nl.load_batch
    monkeypatch.setattr(t_nl, "load_batch", lambda *a, **k: native_calls.append(1) or real(*a, **k))
    jl = j_ds.BatchLoader(j_ds.MangoDataset(img_dir, **dict(kw, use_native=False)), 4, shuffle=True, seed=7)
    tl = t_ds.BatchLoader(t_ds.MangoDataset(img_dir, **kw), 4, shuffle=True, seed=7)
    for epoch in (0, 1):
        got, ref = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(ref) == 1
        for gb, rb in zip(got, ref):
            assert len(gb) == len(rb) == (3 if case == "instances" else 2)
            for g, r in zip(gb, rb):
                assert g.dtype == r.dtype
                np.testing.assert_array_equal(g, r)
    assert len(native_calls) == (0 if case == "cv2" else 2)


def test_batch_loader_shards_carry_their_instance_rows(annotated_run):
    """Under ``shard=(i, 2)`` each rank's batches are its half of the
    one-process batch's rows, instances included; prefetch yields the same."""
    img_dir, mask_dir, ann = annotated_run
    ds = t_ds.MangoDataset(img_dir, mask_dir, image_size=(48, 48), annotations_file=ann, max_instances=3)
    whole = list(t_ds.BatchLoader(ds, 4, seed=2).epoch(1))
    for i in (0, 1):
        part = list(t_ds.BatchLoader(ds, 4, seed=2, shard=(i, 2)).prefetch_epoch(1))
        for pb, wb in zip(part, whole):
            for p, w in zip(pb, wb):
                np.testing.assert_array_equal(p, w[2 * i : 2 * i + 2])


def test_batch_loader_non_png_takes_the_cv2_path(tmp_path, monkeypatch):
    """A JPEG batch is decoded and resized as OpenCV does it (the JAX
    package's cv2 path), never by the JAX loader's own PNG contract."""
    import cv2

    d = tmp_path / "jpg"
    d.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        cv2.imwrite(str(d / f"{i}.jpg"), rng.integers(0, 256, (16, 16, 3), np.uint8))
    real = t_nl.load_batch

    def exact_only(*a, **k):
        assert k.get("exact"), "a JPEG batch went through the JAX loader's PNG contract"
        return real(*a, **k)

    monkeypatch.setattr(t_nl, "load_batch", exact_only)
    (imgs, masks), = t_ds.BatchLoader(t_ds.MangoDataset(str(d), image_size=(16, 16)), 2, shuffle=False).epoch(0)
    ref, = j_ds.BatchLoader(j_ds.MangoDataset(str(d), image_size=(16, 16), use_native=False), 2, shuffle=False).epoch(0)
    np.testing.assert_array_equal(imgs, ref[0])
    np.testing.assert_array_equal(masks, ref[1])


# ---------------------------------------------------------------------------
# device_preprocess_batch with instances
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_classes,crop_prob", [(2, 0.5), (2, 0.0), (3, 0.5), (None, 0.0)],
                         ids=["packed_crop", "packed", "nearest_crop", "nearest"])
def test_device_preprocess_instances_match_jax(num_classes, crop_prob):
    """The instances ride the packed linear warp (``num_classes == 2``,
    rounded back) or each channel takes the nearest path, with their image's
    draw: images within 1e-5 of their scale, masks and instances equal,
    int32."""
    b, o, h, w = 4, 3, 24, 20
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    inst = np.zeros((b, o, h, w), np.uint8)
    inst[:, 0, 3:11, 2:9] = 1
    inst[:, 1, 12:21, 8:17] = 1
    inst[:, 2, 5:9, 12:18] = 1
    masks = inst.any(1).astype(np.int32)
    masks[:, 6:8, 13:15] = 2 if num_classes == 3 else 1
    key = jax.random.key(5)
    with jax.default_matmul_precision("highest"):
        ref_i, ref_m, ref_inst = j_ds.device_preprocess_batch(
            key, jnp.asarray(imgs), jnp.asarray(masks), j_image.IMAGENET_MEAN, j_image.IMAGENET_STD, augment=True,
            flip_prob=0.5, rotation_degrees=15.0, crop_prob=crop_prob, instances=jnp.asarray(inst),
            num_classes=num_classes)
    draw = _jax_draws(key, b, h, w, 0.5, 15.0, crop_prob)
    assert draw.flip.any() and not draw.flip.all()
    got_i, got_m, got_inst = t_ds.device_preprocess_batch(
        torch.from_numpy(imgs), torch.from_numpy(masks), t_image.IMAGENET_MEAN, t_image.IMAGENET_STD, draw,
        num_classes=num_classes, instances=torch.from_numpy(inst))
    assert _rel_err(got_i, ref_i) <= 1e-5
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_inst.numpy(), np.asarray(ref_inst))
    assert got_inst.dtype == torch.int32 and got_inst.shape == (b, o, h, w)
    assert int(got_inst.sum()) > 0


def test_device_preprocess_without_augmentation_casts_instances():
    inst = torch.zeros((2, 2, 8, 8), dtype=torch.uint8)
    inst[0, 1, 2:5, 3:6] = 1
    imgs = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    masks = inst.any(1).long()
    out = t_ds.device_preprocess_batch(imgs, masks, t_image.IMAGENET_MEAN, t_image.IMAGENET_STD, instances=inst)
    ref = j_ds.device_preprocess_batch(jax.random.key(0), jnp.asarray(imgs.numpy()), jnp.asarray(masks.numpy()),
                                       j_image.IMAGENET_MEAN, j_image.IMAGENET_STD, instances=jnp.asarray(inst.numpy()))
    assert len(out) == len(ref) == 3 and out[2].dtype == torch.int32
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert _rel_err(out[0], ref[0]) <= 1e-6
    assert len(t_ds.device_preprocess_batch(imgs, masks, t_image.IMAGENET_MEAN, t_image.IMAGENET_STD)) == 2


# ---------------------------------------------------------------------------
# Synthetic scenes and make_dummy_run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [{}, {"clutter": 3.0, "label_noise": 0.6, "lighting_strength": 1.6}],
                         ids=["defaults", "hard_regime"])
def test_render_orchard_scene_matches_jax(knobs):
    for seed in (0, 1, 2):
        got = t_syn.render_orchard_scene(np.random.default_rng(seed), 64, 80, **knobs)
        ref = j_syn.render_orchard_scene(np.random.default_rng(seed), 64, 80, **knobs)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert len(got[2]) == len(ref[2]) > 0
        for g, r in zip(got[2], ref[2]):
            np.testing.assert_array_equal(g["poly"], r["poly"])
            assert (g["bbox"], g["occluded"]) == (r["bbox"], r["occluded"])


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _assert_same_files(tb, jb, replace=(b"", b"")):
    """PNGs equal once decoded (the port's writer is not OpenCV's encoder;
    an image may differ by one grey level on at most 1e-4 of its values,
    the residue of the cubic lighting field), every other file byte for
    byte."""
    import cv2

    assert sorted(tb) == sorted(jb)
    for k in jb:
        if k.endswith(".png"):
            got, ref = (cv2.imdecode(np.frombuffer(b[k], np.uint8), cv2.IMREAD_UNCHANGED) for b in (tb, jb))
            assert got.shape == ref.shape, k
            diff = np.abs(got.astype(int) - ref.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, k
            if "/masks/" in k:
                np.testing.assert_array_equal(got, ref)
        else:
            assert tb[k] == jb[k].replace(*replace), k


def test_generate_orchard_dataset_files_match_jax(tmp_path):
    """Every file of a three-split dataset (PNG images and masks decoded,
    the annotation JSON byte for byte), with train-only label noise."""
    kw = dict(num_train=3, num_val=2, num_test=0, image_size=(48, 64), seed=5, train_only_kwargs={"label_noise": 0.5},
              clutter=1.0)
    got = t_syn.generate_orchard_dataset(str(tmp_path / "t"), **kw)
    ref = j_syn.generate_orchard_dataset(str(tmp_path / "j"), **kw)
    assert sorted(got) == sorted(ref) == ["train", "val"]
    tb, jb = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert len(tb) == 2 * 5 + 2
    _assert_same_files(tb, jb)
    data = json.loads((tmp_path / "t" / "train" / "annotations.json").read_text())
    assert {a["attributes"]["occluded"] for a in data["annotations"]} <= {True, False}
    assert t_syn.generate_orchard_split(str(tmp_path / "s"), 1, (32, 32), seed=1).endswith("annotations.json")


@pytest.mark.parametrize("with_annotations", [False, True], ids=["masks", "annotations"])
def test_make_dummy_run_files_match_jax(tmp_path, with_annotations):
    """The images and masks (decoded), the annotation JSON and the four YAML
    files (byte for byte but for the paths they name)."""
    kw = dict(num_images=3, image_size=(40, 48), batch_size=2, num_epochs=1, patch_size=8, init_features=4, depth=2,
              seed=6, with_annotations=with_annotations)
    got_dir = t_boot.make_dummy_run(str(tmp_path / "t"), **kw)
    ref_dir = j_boot.make_dummy_run(str(tmp_path / "j"), **kw)
    assert Path(got_dir).relative_to(tmp_path / "t") == Path(ref_dir).relative_to(tmp_path / "j")
    tb, jb = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert ("data/train/annotations.json" in tb) == with_annotations
    _assert_same_files(tb, jb, (str(tmp_path / "j").encode(), str(tmp_path / "t").encode()))


# ---------------------------------------------------------------------------
# The native loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    """RGB images and label masks as PNGs (cv2), 60 × 80."""
    import cv2

    base = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    imgs, masks = [], []
    for i in range(4):
        img, mask = rng.integers(0, 256, (60, 80, 3), np.uint8), rng.integers(0, 3, (60, 80), np.uint8)
        _png(base / f"img{i}.png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        _png(base / f"mask{i}.png", mask)
        imgs.append(str(base / f"img{i}.png"))
        masks.append(str(base / f"mask{i}.png"))
    return imgs, masks


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's loader on its own ``native/decode.cc``, compiled here
    as its Makefile compiles it (the JAX loader's shared build target is not
    used: parallel workers race on it)."""
    out = tmp_path_factory.mktemp("jax_native") / "libmgu_native.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", str(REPO / "native" / "decode.cc"), "-shared", "-lz",
                    "-lpthread", "-o", str(out)], check=True, capture_output=True, timeout=300)
    saved = (j_nl._LIB_PATH, j_nl._lib, j_nl._tried)
    j_nl._LIB_PATH, j_nl._lib, j_nl._tried = str(out), None, False
    assert j_nl.available()
    yield j_nl
    j_nl._LIB_PATH, j_nl._lib, j_nl._tried = saved


@pytest.mark.parametrize("size", [(60, 80), (32, 48), (75, 101)], ids=["own", "down", "up"])
def test_native_loader_matches_jax_and_cv2(png_files, jax_native, size):
    """Images (bilinear) and masks (nearest) bit-equal to JAX's loader; at
    the file's own size equal to cv2's decode, masks equal to cv2's nearest
    resize, images within 1 of cv2's bilinear."""
    import cv2

    imgs, masks = png_files
    got = t_nl.load_batch(imgs, masks, size, threads=3)
    ref = jax_native.load_batch(imgs, masks, size, threads=2)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    for i, (ip, mp) in enumerate(zip(imgs, masks)):
        np.testing.assert_array_equal(t_nl.load_image(ip, size), got[0][i])
        np.testing.assert_array_equal(t_nl.load_mask(mp, size), jax_native.load_mask(mp, size))
        cv_img = cv2.cvtColor(cv2.imread(ip), cv2.COLOR_BGR2RGB)
        cv_mask = cv2.resize(cv2.imread(mp, cv2.IMREAD_GRAYSCALE), size[::-1], interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(got[1][i], cv_mask)
        if size == (60, 80):
            np.testing.assert_array_equal(got[0][i], cv_img)
        else:
            cv_img = cv2.resize(cv_img, size[::-1], interpolation=cv2.INTER_LINEAR)
            assert np.abs(got[0][i].astype(int) - cv_img.astype(int)).max() <= 1
    imgs_only = t_nl.load_batch(imgs, None, size)
    assert imgs_only[1] is None and np.array_equal(imgs_only[0], got[0])


def test_native_loader_failures(png_files, tmp_path):
    """A missing or non-PNG file gives None, as in JAX; a batch with one
    gives None; mismatched lists raise."""
    imgs, masks = png_files
    (tmp_path / "x.png").write_bytes(b"\x89PNG but not really")
    assert t_nl.load_image(str(tmp_path / "nope.png"), (8, 8)) is None
    assert t_nl.load_image(str(tmp_path / "x.png"), (8, 8)) is None
    assert t_nl.load_mask(str(tmp_path / "nope.png"), (8, 8)) is None
    assert t_nl.load_batch(imgs[:1] + [str(tmp_path / "nope.png")], None, (8, 8)) is None
    with pytest.raises(ValueError, match="masks"):
        t_nl.load_batch(imgs, masks[:2], (8, 8))


_BUILD_SCRIPT = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import numpy as np
    from mingraph_unet_tpu_torch.ops.kernels import build
    out, start, png = Path(sys.argv[1]), float(sys.argv[2]), sys.argv[3]
    time.sleep(max(0.0, start - time.time()))
    build._build_host("decode", out)
    import ctypes
    lib = ctypes.CDLL(str(out))
    buf = np.empty((60, 80, 3), np.uint8)
    rc = lib.mgu_load_image(png.encode(), 60, 80, ctypes.c_void_p(buf.ctypes.data))
    print(rc, int(buf.astype(np.int64).sum()))
""")


def test_native_build_is_safe_when_two_processes_build_it(tmp_path, png_files):
    """Two processes compile the library into one path at the same moment:
    each writes its own file and renames it into place, both load a whole
    library that decodes, and no temporary file is left."""
    import time

    out = tmp_path / "decode.so"
    start = time.time() + 2.0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-c", _BUILD_SCRIPT, str(out), str(start), png_files[0][0]]
    procs = [subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [r[1][-500:] for r in results]
    expect = int(t_nl.load_image(png_files[0][0], (60, 80)).astype(np.int64).sum())
    assert [r[0].split() for r in results] == [["0", str(expect)]] * 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["decode.so"]


def test_native_build_failure_raises_with_the_first_error(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s first error line;
    the loader's message names ``use_native=False`` as the way out, and
    nothing falls back quietly."""
    (tmp_path / "decode.cc").write_text("int broken( {\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build 'decode': .*error"):
        build._build_host("decode", tmp_path / "out" / "decode.so")
    assert not (tmp_path / "out" / "decode.so").exists()

    def unavailable(name):
        raise RuntimeError("g++ failed to build 'decode': decode.cc:1: error: expected")

    monkeypatch.setattr(build, "host_library", unavailable)
    with pytest.raises(RuntimeError, match="use_native=False"):
        t_nl.load_image("x.png", (4, 4))


def test_native_library_is_built_once_and_loaded(png_files):
    lib = build.host_library("decode")
    assert build.host_library("decode") is lib and build._host_target("decode").exists()
    assert build._host_target("decode").parent == build.BUILD_DIR
    assert lib.mgu_load_batch.argtypes[0] is ctypes.c_void_p


# ---------------------------------------------------------------------------
# Data collection
# ---------------------------------------------------------------------------


def test_frame_extractor_matches_jax(tmp_path):
    """Every third frame of a written clip, as PNGs named as JAX names them,
    byte for byte; bad formats and missing files refused alike."""
    import cv2

    video = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 48))
    for i in range(10):
        writer.write(np.full((48, 64, 3), i * 20, np.uint8))
    writer.release()
    got = t_col.FrameExtractor(frame_interval=3).extract_frames(video, str(tmp_path / "t"))
    ref = j_col.FrameExtractor(frame_interval=3).extract_frames(video, str(tmp_path / "j"))
    assert got == ref == 4
    tb, jb = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert sorted(tb) == sorted(jb) and tb == jb
    with pytest.raises(ValueError):
        t_col.FrameExtractor(image_format="bmp")
    with pytest.raises(FileNotFoundError):
        t_col.FrameExtractor().extract_frames(str(tmp_path / "nope.mp4"), str(tmp_path))
    assert t_col.VideoCapture(3, str(tmp_path)).camera_index == 3
