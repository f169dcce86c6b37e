"""The inference surface of mingraph_unet_tpu_torch against the JAX package,
on the CPU: tiled inference (``parallel/spatial.py``), the large-scene
pipeline forward, the segmentation post-processing and the two
segmentation entry points on a checkpoint the port's own trainer wrote.

Tolerances: tiling and stitching are pure copies and must be exact, as
must the palette, the label maps and the hard patch labels; f32 model
outputs agree with JAX to 2e-4 of max |ref| (PARITY.md M5), and the tiled
forward with the port's own whole-scene forward to 1e-4 absolute (as
``tests/test_parallel.py`` holds the JAX pair).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.models.pipeline import MinGraphUNet as JaxMinGraphUNet
from mingraph_unet_tpu.parallel import spatial as jax_spatial
from mingraph_unet_tpu.train import infer as jax_infer
from mingraph_unet_tpu.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import load_jax_variables
from mingraph_unet_tpu_torch.data.dataset import load_image_rgb
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.ops.image import normalize
from mingraph_unet_tpu_torch.parallel import spatial as t_spatial
from mingraph_unet_tpu_torch.train import infer as t_infer
from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
from mingraph_unet_tpu_torch.train.segmentation import build_unet, train_unet_segmentation


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close_rel(got, ref, rel=2e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max error {err:.3g} of max |ref| > {rel}"


# ---------------------------------------------------------------------------
# parallel/spatial.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,tile,halo", [((96, 80), 32, 8), ((64, 64), 16, 16), ((48, 100), 40, 4)])
def test_extract_and_stitch_match_jax(hw, tile, halo):
    scene = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref_tiles, ref_grid = jax_spatial.extract_tiles(jnp.asarray(scene), tile, halo)
    tiles, grid = t_spatial.extract_tiles(_t(scene), tile, halo)
    assert grid == ref_grid
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(ref_tiles))
    out = tiles * 2.0 + 1.0
    ref = jax_spatial.stitch_tiles(ref_tiles * 2.0 + 1.0, ref_grid, 2, hw, tile, halo)
    got = t_spatial.stitch_tiles(out, grid, 2, hw, tile, halo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), scene * 2.0 + 1.0)


def test_extract_tiles_rejects_small_scene():
    with pytest.raises(ValueError, match="smaller than window"):
        t_spatial.extract_tiles(torch.zeros((1, 40, 64, 3)), 32, 8)


@pytest.mark.parametrize("tile_batch", [None, 4])
def test_tiled_inference_matches_jax(tile_batch):
    """A 3×3 box filter with zero padding: the windows' borders differ from
    the scene's, and the halo hides them."""
    scene = np.random.default_rng(1).standard_normal((1, 72, 88, 2)).astype(np.float32)

    def jax_fn(x):
        p = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        return sum(p[:, i : i + x.shape[1], j : j + x.shape[2]] for i in range(3) for j in range(3))

    def torch_fn(x):
        p = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        return sum(p[:, i : i + x.shape[1], j : j + x.shape[2]] for i in range(3) for j in range(3))

    ref = jax_spatial.tiled_inference(jax_fn, jnp.asarray(scene), tile=24, halo=8, tile_batch=tile_batch)
    got = t_spatial.tiled_inference(torch_fn, _t(scene), tile=24, halo=8, tile_batch=tile_batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(got.numpy(), torch_fn(_t(scene)).numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# pipeline_forward_large
# ---------------------------------------------------------------------------

SMALL = dict(init_features=4, depth=2, patch_size=8, unet_patch_feature_dim=6, gat_hidden_dim=16,
             gat_output_dim=8, gat_num_heads=2, num_segments=2, fc_hidden_dim=32)
LARGE_COMPARED = ("logits", "soft_assignments", "pred_bboxes", "pred_confidence", "pred_class_scores",
                  "dense_objectness_logits", "dense_boxes", "gat_feats", "region_embeddings")


@pytest.mark.parametrize("size", [128, 192])
def test_pipeline_forward_large_matches_jax_and_whole_scene(size):
    """Depth 2, tile 64, halo 32: a 128² scene is one window (the U-Net
    runs whole), a 192² scene nine. The dense head and class scores are on;
    ``detection_pre_pool`` 16 takes the reference-exact path with the
    head's own pre-pool."""
    cfg = dict(SMALL, detection_pre_pool=16, use_dense_detection=True, num_detection_classes=2)
    scene = np.random.default_rng(21).random((1, size, size, 3)).astype(np.float32)
    jm = JaxMinGraphUNet(**cfg)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(scene[:, :32, :32]))
    v = jax.tree_util.tree_map(np.asarray, v)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda s: jax_infer.pipeline_forward_large(jm, v, s, tile=64, halo=32))(jnp.asarray(scene))
    model = load_jax_variables(MinGraphUNet(device="cpu", **cfg), v)
    got = t_infer.pipeline_forward_large(model, _t(scene), tile=64, halo=32)
    whole = model(_t(scene))
    for k in LARGE_COMPARED:
        _assert_close_rel(got[k], np.asarray(ref[k]))
        np.testing.assert_allclose(got[k].numpy(), whole[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["hard_patch_labels"].numpy(), np.asarray(ref["hard_patch_labels"]))
    np.testing.assert_array_equal(got["hard_patch_labels"].numpy(), whole["hard_patch_labels"].numpy())
    assert not model.training


# ---------------------------------------------------------------------------
# Post-processing and the segmentation entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_classes", [1, 2, 4, 7])
def test_palette_and_postprocess_match_jax(num_classes):
    np.testing.assert_array_equal(t_infer.class_palette(num_classes), jax_infer.class_palette(num_classes))
    rng = np.random.default_rng(num_classes)
    logits = rng.standard_normal((1, 9, 11, num_classes)).astype(np.float32)
    labels = rng.integers(-1, num_classes + 1, (9, 11))
    for arr in (logits, logits[0], labels):
        got = t_infer.postprocess_segmentation(arr, num_classes)
        ref = jax_infer.postprocess_segmentation(arr, num_classes)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A ``make_dummy_run`` directory and one epoch of the port's
    segmentation trainer on the CPU, which writes its checkpoint."""
    base = str(tmp_path_factory.mktemp("infer_run"))
    cfg_dir = make_dummy_run(base, num_images=2, image_size=(32, 32), batch_size=2, num_epochs=1)
    train_unet_segmentation(cfg_dir, max_epochs=1, device="cpu")
    cfg = PipelineConfig.from_config_dir(cfg_dir)
    image = sorted(glob.glob(os.path.join(cfg.dataset.data_root, "train", "images", "*")))[0]
    return cfg_dir, cfg, image


def _unet_logits(cfg, weights, img):
    model = build_unet(cfg, device="cpu").eval()
    model.load_state_dict(weights)
    pre = cfg.preprocessing
    x = normalize(torch.from_numpy(img).float() / 255.0, pre.normalization_mean, pre.normalization_std)[None]
    with torch.no_grad():
        return model, x, model(x)["logits"]


def test_infer_segmentation_writes_label_map(trained_run, tmp_path):
    import cv2

    cfg_dir, cfg, image = trained_run
    res = t_infer.infer_segmentation(cfg_dir, image, cfg.training.checkpoint_dir, str(tmp_path), device="cpu")
    label_png = cv2.imread(res["label_path"], cv2.IMREAD_UNCHANGED)
    vis_png = cv2.imread(res["vis_path"], cv2.IMREAD_UNCHANGED)
    assert label_png.shape == (32, 32) and vis_png.shape == (32, 32, 3)
    weights = t_infer.load_variables(cfg.training.checkpoint_dir)
    _, _, logits = _unet_logits(cfg, weights, load_image_rgb(image))
    np.testing.assert_array_equal(label_png, logits[0].argmax(-1).numpy().astype(np.uint8))
    np.testing.assert_array_equal(vis_png, t_infer.class_palette(2)[label_png])


def test_infer_segmentation_large_tiles_the_scene(trained_run, tmp_path):
    """A 96² scene at tile 16, halo 24 (a multiple of 2^depth covering the
    depth-2 U-Net's ±20 px receptive field): 36 windows of 64²."""
    import cv2

    cfg_dir, cfg, image = trained_run
    scene = cv2.resize(cv2.imread(image), (96, 96), interpolation=cv2.INTER_LINEAR)
    path = str(tmp_path / "scene.png")
    cv2.imwrite(path, scene)
    res = t_infer.infer_segmentation_large(cfg_dir, path, cfg.training.checkpoint_dir, str(tmp_path / "out"),
                                           tile=16, halo=24, device="cpu")
    label_png = cv2.imread(res["label_path"], cv2.IMREAD_UNCHANGED)
    assert label_png.shape == (96, 96) and cv2.imread(res["vis_path"]).shape == (96, 96, 3)
    model, x, whole = _unet_logits(cfg, t_infer.load_variables(cfg.training.checkpoint_dir), load_image_rgb(path))
    with torch.no_grad():
        tiled = t_spatial.tiled_inference(lambda t: model(t)["logits"], x, tile=16, halo=24)
    np.testing.assert_array_equal(label_png, tiled[0].argmax(-1).numpy().astype(np.uint8))
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=0, atol=1e-4)


def test_load_variables_layouts(tmp_path):
    model = build_unet(PipelineConfig(), device="cpu")
    CheckpointManager(str(tmp_path / "bare")).save(3, model.state_dict())
    got = t_infer.load_variables(str(tmp_path / "bare"))
    assert got.keys() == model.state_dict().keys()
    CheckpointManager(str(tmp_path / "odd")).save(1, {"weights": {"a": torch.zeros(1)}})
    with pytest.raises(ValueError, match="Unrecognized checkpoint layout"):
        t_infer.load_variables(str(tmp_path / "odd"))
    with pytest.raises(FileNotFoundError):
        t_infer.load_variables(str(tmp_path / "missing"))
    assert not (tmp_path / "missing").exists()
