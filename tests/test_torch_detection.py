"""The multi-instance serving surface of mingraph_unet_tpu_torch against the
JAX package, on the CPU, on the same numpy inputs: the depth-to-space
kernel's plain path (K5) and its dispatch, ``ops/boxes.py``, the new
``ops/cc.py`` functions, the detection heads, the dense decode and loss,
and ``MinGraphUNet`` with the dense head, class scores and each ablation
switch, flax weights carried over by ``convert.py``.

Tolerances: f32 values agree to 2e-4 of max |ref| (PARITY.md M5; the two
frameworks sum in other orders, and the dense decode takes its sigmoid in
f64); K5, box conversions, NMS keep masks and orders, ``valid``,
``instance_boxes`` and ``component_count`` are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.models import detection as jax_det
from mingraph_unet_tpu.models.pipeline import MinGraphUNet as JaxMinGraphUNet
from mingraph_unet_tpu.ops import boxes as jax_boxes
from mingraph_unet_tpu.ops import cc as jax_cc
from mingraph_unet_tpu.ops.pallas import pool as jax_pool
from mingraph_unet_tpu_torch.convert import load_jax_variables
from mingraph_unet_tpu_torch.models import detection as t_det
from mingraph_unet_tpu_torch.models import unet as t_unet
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.ops import boxes as t_boxes
from mingraph_unet_tpu_torch.ops import cc as t_cc
from mingraph_unet_tpu_torch.ops.kernels import pool as t_pool

REL_TOL = 2e-4


def _assert_close_rel(got, ref, rel=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max error {err:.3g} of max |ref| > {rel}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gen():
    return torch.Generator().manual_seed(0)


def _perturb_stats(tree, seed):
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if str(path[-1].key) == "mean":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.2, jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


# ---------------------------------------------------------------------------
# K5: depth-to-space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [
    ((3, 16, 24, 128), "float32"),
    ((2, 8, 8, 256), "bfloat16"),
    ((1, 4, 40, 64), "bfloat16"),
])
def test_d2s_plain_path_matches_pallas(shape, dtype):
    """The K5 wrapper on a CPU tensor (its plain path) is bit-equal to the
    Pallas kernel in interpret mode."""
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    ref = jax_pool.depth_to_space_pallas(jnp.asarray(x, getattr(jnp, dtype)), interpret=True)
    got = t_pool.depth_to_space_kernel(_t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


class _Card:
    """A stand-in for a CUDA tensor of ``y``'s dtype and shape."""

    is_cuda = True

    def __init__(self, y):
        self.dtype, self.shape = y.dtype, y.shape


def _spy_d2s(monkeypatch):
    """Record the K5 wrapper's calls, with ``ops/kernels/pool.py``'s device
    check reading 'card' (the wrapper runs its plain version on the CPU)."""
    calls = []
    real = t_pool.depth_to_space_kernel

    def spy(y):
        calls.append(y.data_ptr())
        return real(y)

    monkeypatch.setattr(t_pool, "depth_to_space_kernel", spy)
    monkeypatch.setattr(t_pool, "_on_card", lambda y: True)
    return calls


@pytest.mark.parametrize("dtype,init,levels", [
    (torch.float32, 4, (0, 1)),    # 16 and 32 bytes per phase group: both fit
    (torch.bfloat16, 4, (1,)),     # level 0: 4 bf16 channels are 8 bytes
    (torch.bfloat16, 8, (0, 1)),
])
def test_d2s_dispatch_at_decoder_sites_only(monkeypatch, dtype, init, levels):
    """Eval calls the K5 wrapper at the decoder's s2d outputs where it fits
    (the level-1 handoff and f_u[0]), never at the skips or the logits;
    train mode never calls it."""
    calls = _spy_d2s(monkeypatch)
    model = t_unet.UNet(_gen(), init_features=init, depth=2, dtype=dtype).eval()
    x = torch.randn((1, 16, 16, 3), generator=_gen())
    with torch.no_grad():
        u = model(x, full_res_outputs=True)
    assert sorted(calls) == sorted(u["f_u_s2d"][i].data_ptr() for i in levels)
    calls.clear()
    model.train()
    model(x, full_res_outputs=True)["logits"].sum().backward()
    assert calls == []


@pytest.mark.parametrize("pre_pool,n_calls", [(4, 1), (None, 2)])
def test_d2s_launches_per_pipeline_forward(monkeypatch, pre_pool, n_calls):
    """The pooled serving path turns only the level-1 handoff to full
    resolution; the reference-exact path also f_u[0]."""
    calls = _spy_d2s(monkeypatch)
    model = MinGraphUNet(device="cpu", init_features=8, depth=2, detection_pre_pool=pre_pool)
    model(torch.randn((1, 64, 64, 3), generator=_gen()))
    assert len(calls) == n_calls


def test_d2s_fits_rule():
    """K5 takes the pool's rule (``pool._fits``), at inference only."""
    assert t_pool._fits(torch.bfloat16, 8) and t_pool._fits(torch.float32, 4)
    assert not t_pool._fits(torch.bfloat16, 4)
    assert not t_pool._fits(torch.float16, 64)
    y = torch.zeros((1, 2, 2, 32))
    assert not t_pool._kernel(y, training=False)  # a CPU tensor
    assert not t_pool._kernel(_Card(y), training=True)
    assert t_pool._kernel(_Card(y), training=False)


# ---------------------------------------------------------------------------
# ops/boxes.py and ops/cc.py
# ---------------------------------------------------------------------------


def _random_boxes(rng, shape, scale=100.0):
    xy = rng.uniform(0, scale, shape + (2,))
    wh = rng.uniform(1, scale / 3, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_conversions_and_iou_match_jax():
    rng = np.random.default_rng(0)
    a, b = _random_boxes(rng, (3, 7)), _random_boxes(rng, (3, 5))
    a[0, 0] = [5, 5, 5, 9]  # an empty box: a zero union with itself
    np.testing.assert_array_equal(t_boxes.xyxy_to_cxcywh(_t(a)).numpy(), jax_boxes.xyxy_to_cxcywh(jnp.asarray(a)))
    c = np.asarray(jax_boxes.xyxy_to_cxcywh(jnp.asarray(a)))
    np.testing.assert_array_equal(t_boxes.cxcywh_to_xyxy(_t(c)).numpy(), jax_boxes.cxcywh_to_xyxy(jnp.asarray(c)))
    ref = jax_boxes.box_iou_matrix(jnp.asarray(a), jnp.asarray(b))
    _assert_close_rel(t_boxes.box_iou_matrix(_t(a), _t(b)), ref)
    assert t_boxes.box_iou_matrix(_t(a[0, :1]), _t(a[0, :1])).item() == 0.0


def _nms_case(kind, rng):
    if kind == "overlapping":
        centers = rng.uniform(20, 40, (4, 12, 2))
        boxes = np.concatenate([centers - 10, centers + 10], -1).astype(np.float32)
        return boxes, rng.uniform(0, 1, (4, 12)).astype(np.float32)
    if kind == "equal_scores":
        centers = rng.uniform(20, 30, (3, 10, 2))
        boxes = np.concatenate([centers - 10, centers + 10], -1).astype(np.float32)
        return boxes, np.full((3, 10), 0.5, np.float32)
    boxes = np.stack([np.array([20 * i, 0, 20 * i + 10, 10], np.float32) for i in range(8)])[None]
    return boxes.repeat(2, 0), rng.uniform(0, 1, (2, 8)).astype(np.float32)


@pytest.mark.parametrize("kind", ["overlapping", "equal_scores", "disjoint"])
def test_nms_matches_jax(kind):
    """Batched NMS against JAX's per-image NMS: the same keep mask and
    order, equal scores lowest index first; disjoint boxes all survive."""
    boxes, scores = _nms_case(kind, np.random.default_rng(3))
    keep, order = t_boxes.nms(_t(boxes), _t(scores), iou_threshold=0.5)
    for i in range(boxes.shape[0]):
        k_ref, o_ref = jax_boxes.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), iou_threshold=0.5)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(k_ref))
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(o_ref))
    if kind == "disjoint":
        assert bool(keep.all())
    else:
        assert not bool(keep.all())


def test_instance_boxes_and_component_count_match_jax():
    rng = np.random.default_rng(5)
    masks = (rng.uniform(size=(2, 4, 12, 17)) < 0.08).astype(np.float32)
    masks[0, 2] = 0.0  # an empty slot
    ref = jax.vmap(jax.vmap(jax_cc.instance_boxes))(jnp.asarray(masks)[:, :, None])[:, :, 0]
    got = t_cc.instance_boxes(_t(masks))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[0, 2].any()
    blobs = (rng.uniform(size=(3, 20, 24)) < 0.35).astype(np.int32)
    labels = jax.vmap(jax_cc.label_components)(jnp.asarray(blobs))
    ref_count = jax.vmap(jax_cc.component_count)(labels)
    got_count = t_cc.component_count(_t(np.asarray(labels)))
    assert got_count.dtype == torch.int32
    np.testing.assert_array_equal(got_count.numpy(), np.asarray(ref_count))
    assert t_cc.component_count(_t(np.asarray(labels[0]))).item() == int(ref_count[0]) > 1


# ---------------------------------------------------------------------------
# Heads, decode, loss
# ---------------------------------------------------------------------------


def test_detection_head_with_class_scores_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 8, 8, 24)).astype(np.float32)
    jm = jax_det.DetectionHead(num_classes=3, fc_hidden_dim=32)
    v = jm.init(jax.random.key(4), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"], 5)}
    with jax.default_matmul_precision("highest"):
        ref = jm.apply(v, jnp.asarray(x))
    tm = t_det.DetectionHead(24, _gen(), fc_hidden_dim=32, num_classes=3).eval()
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        got = tm(_t(x))
    assert len(got) == len(ref) == 3 and got[2].shape == (2, 3)
    for g, r in zip(got, ref):
        _assert_close_rel(g, r)


def _dense_head_outputs():
    x = np.random.default_rng(12).standard_normal((2, 36, 32, 12)).astype(np.float32)
    jm = jax_det.DenseDetectionHead(cell_size=8, hidden=16)
    v = jm.init(jax.random.key(6), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        ref = jm.apply(v, jnp.asarray(x))
    tm = t_det.DenseDetectionHead(12, _gen(), cell_size=8, hidden=16)
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        got = tm(_t(x))
    return got, ref


def test_dense_head_matches_jax():
    """36 rows at cell 8: the VALID pool drops the ragged last 4."""
    got, ref = _dense_head_outputs()
    assert got["objectness_logits"].shape == (2, 4, 4) and got["boxes"].shape == (2, 4, 4, 4)
    for k in ("objectness_logits", "boxes"):
        _assert_close_rel(got[k], ref[k])


def _decode_inputs(kind):
    rng = np.random.default_rng(13)
    gh, gw = 5, 6
    boxes = rng.uniform(0, 1, (2, gh, gw, 4)).astype(np.float32)
    boxes[..., 2:] = 0.6 + 0.4 * boxes[..., 2:]  # most of the image: NMS suppresses
    if kind == "equal_scores":
        logits = np.zeros((2, gh, gw), np.float32)  # sigmoid exactly 0.5: at the threshold
    else:
        logits = rng.normal(0, 2, (2, gh, gw)).astype(np.float32)
    return logits, boxes


@pytest.mark.parametrize("kind,top_k", [("random", 8), ("equal_scores", 8), ("random", 64)])
def test_decode_dense_detections_matches_jax(kind, top_k):
    """top_k 64 exceeds the 30 cells and is clamped."""
    logits, boxes = _decode_inputs(kind)
    ref = jax_det.decode_dense_detections(jnp.asarray(logits), jnp.asarray(boxes), (40, 48), 8, top_k=top_k)
    got = t_det.decode_dense_detections(_t(logits), _t(boxes), (40, 48), 8, top_k=top_k)
    k = min(top_k, 30)
    assert got[0].shape == (2, k, 4) and got[1].shape == (2, k) and got[2].dtype == torch.bool
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _assert_close_rel(got[1], ref[1])
    assert got[2].any() and not got[2].all()


def test_dense_detection_loss_matches_jax():
    rng = np.random.default_rng(14)
    masks = np.zeros((2, 3, 32, 40), np.float32)
    masks[0, 0, 3:11, 30:39] = 1.0
    masks[0, 1, 20:31, 2:7] = 1.0
    masks[1, 0, 12:14, 16:25] = 1.0  # slot 1, 2 of image 1 and slot 2 of image 0 pad
    outputs = {"objectness_logits": rng.normal(0, 2, (2, 4, 5)).astype(np.float32),
               "boxes": rng.uniform(0, 1, (2, 4, 5, 4)).astype(np.float32)}
    ref = jax_det.dense_detection_loss({k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(masks), 8)
    t_out = {k: _t(v).requires_grad_() for k, v in outputs.items()}
    got = t_det.dense_detection_loss(t_out, _t(masks), 8)
    for g, r in zip(got, ref):
        _assert_close_rel(g, r)
    (got[0] + got[1]).backward()
    assert t_out["boxes"].grad.ne(0).sum() == 3 * 4  # the three positive cells


# ---------------------------------------------------------------------------
# MinGraphUNet: dense head, class scores, ablation switches
# ---------------------------------------------------------------------------

B, H = 2, 32
SMALL = dict(init_features=4, depth=2, patch_size=8, unet_patch_feature_dim=6, gat_hidden_dim=16,
             gat_output_dim=8, gat_num_heads=2, fc_hidden_dim=32)
VARIANTS = {
    "dense_classes_pooled": dict(use_dense_detection=True, num_detection_classes=3, detection_pre_pool=H // 8),
    "dense_classes_exact": dict(use_dense_detection=True, num_detection_classes=3),
    "no_patch_gat": dict(use_dense_detection=True, detection_pre_pool=H // 8, use_patch_gat=False),
    "no_partition": dict(use_dense_detection=True, detection_pre_pool=H // 8, use_partition=False),
    "no_region_gat": dict(use_dense_detection=True, detection_pre_pool=H // 8, use_region_gat=False),
    "no_fusion": dict(use_dense_detection=True, detection_pre_pool=H // 8, use_fusion=False),
}
# Parameter subtrees the variant must have (+) or lack (-) in the port.
TREES = {
    "dense_classes_pooled": ("+dense_detection_head.", "+detection_head.fc_class_scores."),
    "dense_classes_exact": ("+dense_detection_head.", "+detection_head.fc_class_scores."),
    "no_patch_gat": ("+patch_passthrough_proj.", "-patch_gat."),
    "no_partition": ("-mincut.", "-region_gat."),
    "no_region_gat": ("+mincut.", "-region_gat."),
    "no_fusion": ("+dense_detection_head.",),
}
COMPARED = ("logits", "pred_bboxes", "pred_confidence", "l_partition", "soft_assignments", "gat_feats",
            "region_embeddings", "f_unet_patches", "dense_objectness_logits", "dense_boxes")


def _images(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    cy, cx = H * rng.uniform(0.3, 0.7, (2, B, 1, 1))
    disc = ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.3 * H) ** 2)[..., None]
    img = np.where(disc, rng.uniform(0, 1, (B, 1, 1, 3)), rng.uniform(0, 1, (B, 1, 1, 3)))
    img = np.clip(img + 0.05 * rng.standard_normal((B, H, H, 3)), 0, 1)
    return ((img - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])).astype(np.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mingraph_unet_variant_matches_jax(variant):
    cfg = dict(SMALL, **VARIANTS[variant])
    x = _images(6)
    jm = JaxMinGraphUNet(dtype=jnp.float32, unet_s2d_level1=True, **cfg)
    v = jax.jit(jm.init)(jax.random.key(7), jnp.asarray(x))
    v = _np_tree({"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"], 11)})
    with jax.default_matmul_precision("highest"):
        ref = _np_tree(jax.jit(jm.apply)(v, jnp.asarray(x)))
    top2 = np.sort(ref["soft_assignments"], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4, "argmax margin too small for a stable label test"

    model = load_jax_variables(MinGraphUNet(device="cpu", **cfg), v)  # strict: the trees match
    names = list(model.state_dict())
    for rule in TREES[variant]:
        assert any(n.startswith(rule[1:]) for n in names) == (rule[0] == "+"), rule
    out = model(_t(x))
    for k in COMPARED:
        _assert_close_rel(out[k], ref[k])
    np.testing.assert_array_equal(out["hard_patch_labels"].numpy(), ref["hard_patch_labels"])
    np.testing.assert_array_equal(out["region_counts"].numpy(), ref["region_counts"])
    assert ("pred_class_scores" in out) == ("pred_class_scores" in ref)
    if "pred_class_scores" in ref:
        _assert_close_rel(out["pred_class_scores"], ref["pred_class_scores"])
