"""The paper's evaluations in mingraph_unet_tpu_torch against the JAX package
on the CPU: the detection and yield metrics (``experiments/metrics.py``),
``region_blend_logits`` with its purity gate, the three detectors of
``experiments/yield_estimation_performance.py`` and
``evaluate_segmentation_model`` on the same JAX weights (brought over by
``convert.py`` into a port checkpoint) and files, the Dummy and mock rows,
and ``experiments/ablation_study.py``'s trained Table 3.

Tolerances: the metrics helpers are host numpy and held exactly; the
blend at 1e-5 of its scale (f32 sums in another order); detections' boxes
and scores at 1e-4 of their scale, confidences 1e-5, and then the metrics
the harness derives from them equal. Equal detections need every discrete
decision the two frameworks make to be clear of its kink, so the fixture's
weights are drawn until they are and the tests check the margins: each
pixel's argmax (its top two logits), the dense scores against the score
threshold and against each other (top-k order), and the NMS overlaps
against the IoU threshold.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mingraph_unet_tpu.config import PipelineConfig as JaxPipelineConfig
from mingraph_unet_tpu.experiments import ablation_study as j_abl
from mingraph_unet_tpu.experiments import metrics as j_met
from mingraph_unet_tpu.experiments import segmentation_performance as j_seg
from mingraph_unet_tpu.experiments import yield_estimation_performance as j_yield
from mingraph_unet_tpu.train import end_to_end as jax_e2e
from mingraph_unet_tpu.train import segmentation as jax_seg
from mingraph_unet_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from mingraph_unet_tpu.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import variables_from_jax
from mingraph_unet_tpu_torch.experiments import ablation_study as t_abl
from mingraph_unet_tpu_torch.experiments import metrics as t_met
from mingraph_unet_tpu_torch.experiments import segmentation_performance as t_seg
from mingraph_unet_tpu_torch.experiments import yield_estimation_performance as t_yield
from mingraph_unet_tpu_torch.ops import boxes as t_boxes
from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager

S = 32
ARGMAX_MARGIN = 1e-4   # least |top-1 − top-2 logit| of a pixel, of the largest logit gap
SCORE_MARGIN = 1e-5    # least distance of a dense score from the threshold and from the next score
#                        (the two frameworks' scores agree to ~1e-6)
IOU_MARGIN = 1e-3      # least distance of a candidate pair's IoU from the NMS threshold


# ---------------------------------------------------------------------------
# The metrics helpers
# ---------------------------------------------------------------------------


def _random_objects(rng, n_images, with_conf):
    out = []
    for _ in range(n_images):
        objs = []
        for _ in range(int(rng.integers(0, 6))):
            x, y = rng.uniform(0, 40, 2)
            w, h = rng.uniform(4, 16, 2)
            o = {"bbox": [float(x), float(y), float(x + w), float(y + h)], "class_id": int(rng.integers(0, 2))}
            if with_conf:
                o["confidence"] = float(rng.random())
            else:
                o["occluded"] = bool(rng.random() < 0.4)
            objs.append(o)
        out.append(objs)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_and_yield_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    gt, pred = _random_objects(rng, 6, False), _random_objects(rng, 6, True)
    # Shifted copies of some ground truth: matches at several overlaps.
    for g, p in zip(gt, pred):
        for o in g[:2]:
            d = float(rng.uniform(0, 4))
            p.append({"bbox": [v + d for v in o["bbox"]], "class_id": o["class_id"], "confidence": float(rng.random())})
    for a in (g["bbox"] for img in gt for g in img):
        for b in (p["bbox"] for img in pred for p in img):
            assert t_met.calculate_iou(a, b) == j_met.calculate_iou(a, b)
    for thr in (0.3, 0.5, 0.7):
        assert t_met.object_detection_map(gt, pred, thr) == j_met.object_detection_map(gt, pred, thr)
        assert t_met.average_precision(gt, pred, thr) == j_met.average_precision(gt, pred, thr)
    counts_gt = [len(g) for g in gt]
    counts_pred = [len(p) for p in pred]
    for args in ((counts_gt, counts_pred), (counts_gt, counts_pred, gt, pred), ([0, 0], [0, 1]), ([0, 0], [0, 0])):
        assert t_met.yield_estimation_metrics(*args) == j_met.yield_estimation_metrics(*args)
    assert t_met.average_precision([[]], [[]]) == j_met.average_precision([[]], [[]]) == 0.0


# ---------------------------------------------------------------------------
# region_blend_logits
# ---------------------------------------------------------------------------


def _blend_inputs(seed, b=2, patch=4, grid=(4, 5), regions=3):
    rng = np.random.default_rng(seed)
    h, w = grid[0] * patch, grid[1] * patch
    logits = (rng.standard_normal((b, h, w, 2)) * 2.0).astype(np.float32)
    labels = rng.integers(0, regions, (b, *grid)).astype(np.int32)
    return logits, labels


def _region_variances(logits, labels, patch, regions):
    """Each region's variance of the foreground probability, in f64."""
    p = np.exp(logits[..., 1]) / np.exp(logits).sum(-1)
    pix = labels.repeat(patch, 1).repeat(patch, 2)
    return np.array([[p[i][pix[i] == s].var() if (pix[i] == s).any() else 0.0 for s in range(regions)]
                     for i in range(len(p))])


@pytest.mark.parametrize("gamma,gated", [(0.5, False), (0.3, False), (0.0, False), (0.5, True), (0.8, True)])
def test_region_blend_logits_matches_jax(gamma, gated):
    """The blend, and with ``purity_tau`` the gate: the threshold is set
    between two regions' variances, clear of both, so some regions blend
    and some keep their logits."""
    patch, regions = 4, 3
    logits, labels = _blend_inputs(4, patch=patch, regions=regions)
    tau = None
    if gated:
        var = np.sort(_region_variances(logits, labels, patch, regions).ravel())
        gaps = np.diff(var)
        k = int(np.argmax(gaps[1:-1])) + 1
        tau = float((var[k] + var[k + 1]) / 2)
        assert gaps[k] / 2 > 1e-4 * var.max()
    got = t_seg.region_blend_logits(torch.from_numpy(logits), torch.from_numpy(labels), patch, regions, gamma, tau)
    ref = np.asarray(j_seg.region_blend_logits(jnp.asarray(logits), jnp.asarray(labels), patch, regions, gamma, tau))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if gated:
        kept = np.isclose(got.numpy(), logits, atol=0).all(-1)
        assert kept.any() and not kept.all()


def test_region_blend_one_region_is_the_global_mean_blend():
    logits, _ = _blend_inputs(1)
    labels = np.zeros((2, 4, 5), np.int32)
    got = t_seg.region_blend_logits(torch.from_numpy(logits), torch.from_numpy(labels), 4, 2, gamma=0.5)
    ref = 0.5 * logits + 0.5 * logits.mean((1, 2), keepdims=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The detectors and Table 1 on JAX weights
# ---------------------------------------------------------------------------


def _jax_cfg(cfg_dir):
    return JaxPipelineConfig.from_config_dir(cfg_dir)


def _save_both(root, name, variables):
    """The same variables as a JAX (Orbax) and a port checkpoint."""
    jdir, tdir = os.path.join(root, f"jax_{name}"), os.path.join(root, f"torch_{name}")
    tree = jax.tree_util.tree_map(np.asarray, variables)
    mngr = JaxCheckpointManager(jdir)
    mngr.save(0, {"params": tree["params"], "batch_stats": tree["batch_stats"]})
    mngr.close()
    CheckpointManager(tdir).save(0, variables_from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]}))
    return jdir, tdir


def _init(module, key):
    return jax.jit(module.init)(jax.random.key(key), jnp.zeros((1, S, S, 3)))


def _sharpen(variables, dense_scale=None):
    """The final 1×1 conv scaled so that the foreground wins in blobs and
    loses clear of 0 elsewhere; the dense head's objectness spread so
    that its scores leave 0.5 (as ``tests/test_torch_e2e.py``'s start)."""
    params = jax.tree_util.tree_map(lambda a: a, variables["params"])
    fc = (params["unet"] if "unet" in params else params)["decoder"]["final_conv"]
    fc["kernel"] = fc["kernel"] * 4.0
    fc["bias"] = fc["bias"] + jnp.asarray([-0.5, 0.5])
    if dense_scale is not None:
        obj = params["dense_detection_head"]["obj_head"]
        obj["kernel"] = obj["kernel"] * dense_scale
        obj["bias"] = obj["bias"] + 0.5
    return {"params": params, "batch_stats": variables["batch_stats"]}


# Seeds whose decisions clear every margin (the tests check them).
WEIGHT_SEEDS = {"unet": 1, "mingraph": 2}


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A ``make_dummy_run(with_annotations=True)`` directory at 32² (dense
    head on in ``model.yaml``), its U-Net's and MinGraph-UNet's weights as
    JAX and port checkpoints."""
    root = str(tmp_path_factory.mktemp("experiments"))
    cfg_dir = make_dummy_run(root, num_images=4, image_size=(S, S), batch_size=2, patch_size=8, init_features=4,
                             depth=2, with_annotations=True, seed=3)
    path = os.path.join(cfg_dir, "model.yaml")
    data = yaml.safe_load(open(path))
    data["fusion_detection"]["use_dense_detection"] = True
    yaml.safe_dump(data, open(path, "w"), sort_keys=False)
    jcfg = _jax_cfg(cfg_dir)
    unet = _sharpen(_init(jax_seg.build_unet(jcfg), WEIGHT_SEEDS["unet"]))
    mgu = _sharpen(_init(jax_e2e.build_mingraph_unet(jcfg), WEIGHT_SEEDS["mingraph"]), dense_scale=30.0)
    train = os.path.join(root, "data", "train")
    return dict(cfg_dir=cfg_dir, unet=_save_both(root, "unet", unet), mgu=_save_both(root, "mgu", mgu),
                img_dir=os.path.join(train, "images"), ann=os.path.join(train, "annotations.json"))


def _port_model(evaluated, model_type):
    from mingraph_unet_tpu_torch.train.infer import load_variables

    cfg = PipelineConfig.from_config_dir(evaluated["cfg_dir"])
    ckpt = evaluated["unet" if model_type == "unet" else "mgu"][1]
    return cfg, t_seg.build_eval_model(cfg, model_type, load_variables(ckpt), "cpu")


def _images(evaluated):
    from mingraph_unet_tpu_torch.data.dataset import load_image_rgb

    names = sorted(os.listdir(evaluated["img_dir"]))
    return torch.from_numpy(np.stack([load_image_rgb(os.path.join(evaluated["img_dir"], n)) for n in names]))


def _check_argmax_margin(logits):
    top2 = logits.float().topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    assert float(gap.min()) >= ARGMAX_MARGIN * float(gap.max()), float(gap.min() / gap.max())


@pytest.mark.parametrize("model_type", t_seg.MODEL_TYPES)
def test_segmentation_count_detector_matches_jax(evaluated, model_type):
    """CC counting over the argmax (of the refined logits too): the same
    instances, boxes equal, confidences at 1e-5, on every image of the
    run, per image at batch 1 as the detectors call it."""
    cfg, model = _port_model(evaluated, model_type)
    imgs = _images(evaluated)
    _check_argmax_margin(t_seg.segmentation_logits(model, cfg, imgs, model_type))
    jdir, tdir = evaluated["unet" if model_type == "unet" else "mgu"]
    jdet = j_yield.SegmentationCountDetector(evaluated["cfg_dir"], jdir, model_type)
    tdet = t_yield.SegmentationCountDetector(evaluated["cfg_dir"], tdir, model_type, device="cpu")
    total = 0
    for img in imgs.numpy():
        got, ref = tdet(img), jdet(img)
        assert len(got) == len(ref)
        total += len(got)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g["bbox"], np.float32), np.asarray(r["bbox"], np.float32))
            assert abs(g["confidence"] - r["confidence"]) <= 1e-5
    assert total > 0


def test_dense_head_detector_matches_jax(evaluated):
    """The dense head's top-k + NMS decode: the same detections, boxes at
    1e-4 of their scale, scores at 1e-5; the scores clear of the threshold
    and of each other, the candidates' overlaps clear of the IoU
    threshold."""
    cfg, model = _port_model(evaluated, "mingraph-unet")
    out = t_seg.eval_forward(model, cfg, _images(evaluated))
    scores = torch.sigmoid(out["dense_objectness_logits"].double()).flatten(1)
    top = scores.topk(min(32, scores.shape[1]), dim=1).values
    assert float((top - 0.5).abs().min()) >= SCORE_MARGIN
    assert float((top[:, :-1] - top[:, 1:]).min()) >= SCORE_MARGIN
    boxes, _, valid = t_yield.dense_head_detect(model, cfg, _images(evaluated), score_threshold=0.0, iou_threshold=1.1)
    for i in range(boxes.shape[0]):
        iou = t_boxes.box_iou_matrix(boxes[i], boxes[i])
        off = ~torch.eye(iou.shape[0], dtype=torch.bool)
        assert float((iou[off] - 0.5).abs().min()) >= IOU_MARGIN
    jdir, tdir = evaluated["mgu"]
    jdet, tdet = j_yield.DenseHeadDetector(evaluated["cfg_dir"], jdir), t_yield.DenseHeadDetector(
        evaluated["cfg_dir"], tdir, device="cpu")
    total = 0
    for img in _images(evaluated).numpy():
        got, ref = tdet(img), jdet(img)
        assert len(got) == len(ref)
        total += len(got)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g["bbox"], r["bbox"], rtol=0, atol=1e-4 * S)
            assert abs(g["confidence"] - r["confidence"]) <= 1e-5
    assert total > 0


@pytest.mark.parametrize("model_type", ["unet", "mingraph-unet", "mingraph-unet-dense", "mingraph-unet-refined"])
def test_evaluate_yield_model_matches_jax(evaluated, model_type, capsys):
    """Table 2 on the annotated files (``YieldImageDataset``): every metric
    of the harness equal to JAX's on the same weights."""
    weights = evaluated["unet" if model_type == "unet" else "mgu"]
    kw = dict(model_type=model_type, num_images=4, image_dir=evaluated["img_dir"], ann_file=evaluated["ann"])
    ref = j_yield.evaluate_yield_model(evaluated["cfg_dir"], weights[0], **kw)
    got = t_yield.evaluate_yield_model(evaluated["cfg_dir"], weights[1], device="cpu", **kw)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert "Yield Estimation Performance" in capsys.readouterr().out


@pytest.mark.parametrize("model_type", t_seg.MODEL_TYPES)
def test_evaluate_segmentation_model_matches_jax(evaluated, model_type, capsys):
    """Table 1 over the train split (no test or val split: the fallback):
    the confusion matrix equal, every metric equal."""
    weights = evaluated["unet" if model_type == "unet" else "mgu"]
    ref = j_seg.evaluate_segmentation_model(evaluated["cfg_dir"], weights[0], model_type, batch_size=3)
    got = t_seg.evaluate_segmentation_model(evaluated["cfg_dir"], weights[1], model_type, batch_size=3, device="cpu")
    np.testing.assert_array_equal(got["confusion_matrix"], ref["confusion_matrix"])
    for k in ("mean_iou", "mean_precision", "mean_recall", "mean_f1", "iou_per_class"):
        assert got[k] == ref[k], k
    out = capsys.readouterr().out
    assert "falling back" in out and f"Segmentation Performance ({model_type})" in out
    with pytest.raises(NotImplementedError):
        t_seg.evaluate_segmentation_model(evaluated["cfg_dir"], "nope", "yolo", device="cpu")


def test_purity_gated_segmentation_matches_jax(evaluated):
    """Table 1 of the refined model with a purity gate that blends some
    regions and not others."""
    cfg, model = _port_model(evaluated, "mingraph-unet-refined")
    out = t_seg.eval_forward(model, cfg, _images(evaluated))
    var = np.sort(_region_variances(out["logits"].double().numpy(), out["hard_patch_labels"].numpy(),
                                    cfg.model.graph_construction.patch_size, cfg.dataset.num_semantic_regions).ravel())
    var = var[var > 0]
    k = int(np.argmax(np.diff(var)))
    tau = float((var[k] + var[k + 1]) / 2)
    _check_argmax_margin(t_seg.segmentation_logits(model, cfg, _images(evaluated), "mingraph-unet-refined", 0.5, tau))
    w = evaluated["mgu"]
    form = "mingraph-unet-refined"
    ref = j_seg.evaluate_segmentation_model(evaluated["cfg_dir"], w[0], form, 2, blend_purity_tau=tau)
    got = t_seg.evaluate_segmentation_model(evaluated["cfg_dir"], w[1], form, 2, blend_purity_tau=tau, device="cpu")
    np.testing.assert_array_equal(got["confusion_matrix"], ref["confusion_matrix"])


# ---------------------------------------------------------------------------
# The Dummy and mock rows, the ablation study
# ---------------------------------------------------------------------------


def test_dummy_dataset_and_mock_rows_equal_jax(capsys):
    """In one process (the mock ablation rows hash the variant's name): the
    Dummy dataset's items, the mock detector's detections, the mock yield
    metrics and every mock Table-3 row equal to JAX's."""
    jd, td = j_yield.DummyYieldDataset(5, (48, 40), seed=3), t_yield.DummyYieldDataset(5, (48, 40), seed=3)
    for i in range(5):
        np.testing.assert_array_equal(td[i][0], jd[i][0])
        assert td[i][1:] == jd[i][1:]
    img = np.zeros((64, 64, 3), np.uint8)
    assert t_yield.MockDetector(seed=2)(img) == j_yield.MockDetector(seed=2)(img)
    assert t_yield.evaluate_yield_model(model_type="mock", num_images=6, seed=4) == j_yield.evaluate_yield_model(
        model_type="mock", num_images=6, seed=4)
    rows = t_abl.run_ablation_study(allow_mock=True)
    assert rows == j_abl.run_ablation_study(allow_mock=True)
    assert len(rows) == 5 and all(r["mocked"] for r in rows)
    assert "Table-3" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        t_abl.run_ablation_experiment("Min-Cut Only", None, None, allow_mock=False)
    with pytest.raises(ValueError, match="Unknown variant"):
        t_abl.run_ablation_experiment("Everything", None, None)
    with pytest.raises(ValueError, match="required"):
        t_yield.evaluate_yield_model(model_type="unet")


def test_apply_variant_and_variant_config_dir_match_jax(tmp_path, evaluated):
    jcfg, cfg = _jax_cfg(evaluated["cfg_dir"]), PipelineConfig.from_config_dir(evaluated["cfg_dir"])
    for slug in t_abl.VARIANT_TOGGLES:
        got_cfg, ref_cfg = t_abl.apply_variant(cfg, slug), j_abl.apply_variant(jcfg, slug)
        assert vars(got_cfg.model.ablation) == vars(ref_cfg.model.ablation)
        got = t_abl._variant_config_dir(evaluated["cfg_dir"], str(tmp_path / "t" / slug / "configs"), slug)
        ref = j_abl._variant_config_dir(evaluated["cfg_dir"], str(tmp_path / "j" / slug / "configs"), slug)
        for name in sorted(os.listdir(ref)):
            expect = open(os.path.join(ref, name)).read().replace(str(tmp_path / "j"), str(tmp_path / "t"))
            assert open(os.path.join(got, name)).read() == expect, name
    assert t_abl.ABLATION_VARIANTS == j_abl.ABLATION_VARIANTS and t_abl.VARIANT_TOGGLES == j_abl.VARIANT_TOGGLES


def test_run_ablation_study_trained_one_variant(tmp_path, capsys):
    """The whole Table-3 loop for one variant and one epoch on the CPU:
    trained on the annotated dummy data (the step takes the instances),
    evaluated on its files; the row has JAX's keys and finite values."""
    rows = t_abl.run_ablation_study_trained(str(tmp_path), variants=["graph_traversal"], num_images=4,
                                            image_size=(S, S), epochs=1, eval_images=4, device="cpu")
    assert len(rows) == 1 and rows[0]["variant"] == "Graph Traversal" and rows[0]["mocked"] is False
    assert all(np.isfinite(v) for k, v in rows[0].items() if k not in ("variant", "mocked"))
    keys = set(j_met.yield_estimation_metrics([1], [1])) | {"ap50_perc", "variant", "mocked"}
    assert set(rows[0]) == keys
    ckpt = tmp_path / "variants" / "graph_traversal" / "checkpoints"
    assert json.loads((ckpt / "checkpoints.json").read_text())
    cfg = yaml.safe_load(open(tmp_path / "variants" / "graph_traversal" / "configs" / "model.yaml"))
    assert cfg["ablation"] == t_abl.VARIANT_TOGGLES["graph_traversal"]
    assert "TRAINED" in capsys.readouterr().out
