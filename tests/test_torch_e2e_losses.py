"""The end-to-end trainer's building blocks in mingraph_unet_tpu_torch against
the JAX package on the CPU, on the same seeded numpy inputs: K6's plain
version (hist-eq), the losses with their gradients, connected components
and instance selection, feature fusion, the detection-box target, and the
dropout helper's statistics.

Tolerances, relative to max |ref| of each compared tensor: values 2e-4,
gradients 1e-3 (PARITY.md M5: the frameworks sum in other orders). Hist-eq,
labels and instance masks are integer-valued and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.models import fusion as jax_fusion
from mingraph_unet_tpu.models import losses as jax_losses
from mingraph_unet_tpu.ops import cc as jax_cc
from mingraph_unet_tpu.ops import filters as jax_filters
from mingraph_unet_tpu.ops.pallas import histeq as jax_histeq
from mingraph_unet_tpu.train import end_to_end as jax_e2e
from mingraph_unet_tpu_torch.models import fusion as t_fusion
from mingraph_unet_tpu_torch.models import layers as t_layers
from mingraph_unet_tpu_torch.models import losses as t_losses
from mingraph_unet_tpu_torch.ops import cc as t_cc
from mingraph_unet_tpu_torch.ops.kernels import histeq as t_histeq
from mingraph_unet_tpu_torch.train import end_to_end as t_e2e

VAL_TOL, GRAD_TOL = 2e-4, 1e-3


def _rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K6: the plain version of equalize_channel
# ---------------------------------------------------------------------------


def _luma(kind, shape, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        y = rng.integers(0, 256, shape)
    elif kind == "low_contrast":
        y = rng.integers(90, 140, shape)
    elif kind == "constant":  # cdf_min = N: the denominator clamps to 1
        y = np.full(shape, 77)
    elif kind == "two_valued":
        y = np.where(rng.uniform(size=shape) < 0.3, 12, 200)
    else:  # "orchard": a dark ground with brighter blobs
        yy, xx = np.mgrid[: shape[1], : shape[2]]
        blob = ((yy - shape[1] / 2) ** 2 + (xx - shape[2] / 3) ** 2 < (shape[1] / 4) ** 2)
        y = np.where(blob, 170, 80) + rng.normal(0, 20, shape)
    return np.clip(y, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["uniform", "low_contrast", "constant", "two_valued", "orchard"])
def test_equalize_channel_plain_matches_pallas(kind):
    """Bit-equal to the Pallas kernel in interpret mode (H·W a multiple of 4096)."""
    y = _luma(kind, (2, 64, 64))
    ref = np.asarray(jax_histeq.equalize_channel_pallas(jnp.asarray(y, jnp.int32), interpret=True))
    got = t_histeq.equalize_channel_plain(_t(y))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)


@pytest.mark.parametrize("kind", ["uniform", "constant", "two_valued", "orchard"])
def test_equalize_channel_plain_matches_nibble_at_odd_size(kind):
    """At H·W not a multiple of 4096 (the Pallas kernel's layout rule, which
    the port does not carry over): bit-equal to the XLA nibble form."""
    y = _luma(kind, (3, 37, 53))
    ref = np.asarray(jax.vmap(jax_filters._equalize_channel_u8_nibble)(jnp.asarray(y, jnp.int32)))
    np.testing.assert_array_equal(t_histeq.equalize_channel_plain(_t(y)).numpy().astype(np.int32), ref)


def test_equalize_channel_wrapper_takes_the_plain_version_on_cpu():
    y = _luma("uniform", (2, 8, 12))
    before = t_histeq.equalize_channel.launches
    torch.testing.assert_close(t_histeq.equalize_channel(_t(y)), t_histeq.equalize_channel_plain(_t(y)),
                               rtol=0, atol=0)
    assert t_histeq.equalize_channel.launches == before  # a launch counts only on the card


# ---------------------------------------------------------------------------
# Losses: values and gradients against jax.grad
# ---------------------------------------------------------------------------


def _blob_logits(b, h, w, seed):
    """Two-class logits whose foreground probability holds blobs well above
    0.5 (logit gap ≥ 1.5 from the threshold), plus noise, so the CC
    threshold decisions are clear."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    fg = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(3):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(2, h / 5), rng.uniform(2, w / 5)
            fg[i] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    gap = np.where(fg, 2.5, -2.5) + rng.uniform(-1, 1, (b, h, w))
    base = rng.standard_normal((b, h, w))
    return np.stack([base, base + gap], axis=-1).astype(np.float32)


def _loss_cases():
    rng = np.random.default_rng(21)
    b, n, d = 2, 12, 5
    f_u = rng.standard_normal((b, n, d)).astype(np.float32)
    f_g = (f_u + 0.3 * rng.standard_normal((b, n, d))).astype(np.float32)
    y_p = (rng.uniform(size=(b, n)) < 0.5).astype(np.float32)
    soft = jax.nn.softmax(jnp.asarray(rng.standard_normal((b, 3, 4, 2)), jnp.float32), axis=-1)
    y_grid = (rng.uniform(size=(b, 3, 4)) < 0.5).astype(np.float32)
    tv_in = rng.standard_normal((b, 6, 7, 1)).astype(np.float32)
    masks = np.zeros((b, 3, 12, 14), np.float32)
    masks[0, 0, 2:8, 3:12] = 1
    masks[0, 1, 9:11, 1:4] = 1  # 6 pixels: below min_pixels
    masks[1, 0, 1:11, 5:9] = 1
    soft_masks = (masks * rng.uniform(0.2, 1.0, masks.shape)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(_blob_logits(b, 24, 20, 3)), axis=-1))
    boxes = np.asarray(jax.nn.sigmoid(rng.standard_normal((b, 4))), np.float32)
    conf = np.asarray(jax.nn.sigmoid(rng.standard_normal((b, 1))), np.float32)
    gt_boxes = rng.uniform(0.1, 0.9, (b, 4)).astype(np.float32)
    has = np.array([True, False])
    return {
        # name: (jax fn, port fn, differentiable inputs, fixed inputs)
        "feature_consistency": (lambda a, c, y: jax_losses.feature_consistency_loss(a, c, y, margin=2.0),
                                lambda a, c, y: t_losses.feature_consistency_loss(a, c, y, margin=2.0),
                                [f_u, f_g], [y_p]),
        "partition_supervision": (jax_losses.partition_supervision_loss, t_losses.partition_supervision_loss,
                                  [np.asarray(soft)], [y_grid]),
        "total_variation": (jax_losses.total_variation_loss, t_losses.total_variation_loss, [tv_in], []),
        "elliptical_shape_binary": (jax_losses.elliptical_shape_loss, t_losses.elliptical_shape_loss,
                                    [masks], []),
        "elliptical_shape_soft_masks": (jax_losses.elliptical_shape_loss, t_losses.elliptical_shape_loss,
                                        [soft_masks], []),
        "elliptical_shape_soft": (jax_losses.elliptical_shape_loss_soft, t_losses.elliptical_shape_loss_soft,
                                  [probs], []),
        "elliptical_shape_soft_instances_fast": (
            lambda p: jax_losses.elliptical_shape_loss_soft_instances(p, max_instances=4),
            lambda p: t_losses.elliptical_shape_loss_soft_instances(p, max_instances=4), [probs], []),
        "elliptical_shape_soft_instances_exact": (
            lambda p: jax_losses.elliptical_shape_loss_soft_instances(p, max_instances=4, exact=True),
            lambda p: t_losses.elliptical_shape_loss_soft_instances(p, max_instances=4, exact=True), [probs], []),
        "detection_bbox": (lambda bx, c, g, hs: jax_losses.detection_losses(bx, c, g, hs)[0],
                           lambda bx, c, g, hs: t_losses.detection_losses(bx, c, g, hs)[0],
                           [boxes, conf], [gt_boxes, has]),
        "detection_conf": (lambda bx, c, g, hs: jax_losses.detection_losses(bx, c, g, hs)[1],
                           lambda bx, c, g, hs: t_losses.detection_losses(bx, c, g, hs)[1],
                           [boxes, conf], [gt_boxes, has]),
    }


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_value_and_grads_match_jax(name):
    jfn, tfn, diff, fixed = LOSS_CASES[name]
    jdiff = [jnp.asarray(a) for a in diff]
    jfixed = [jnp.asarray(a) for a in fixed]
    with jax.default_matmul_precision("highest"):
        ref = jfn(*jdiff, *jfixed)
        grads = jax.grad(lambda *xs: jfn(*xs, *jfixed), argnums=tuple(range(len(diff))))(*jdiff)
    assert float(ref) != 0.0, "the case must exercise the loss"
    tdiff = [_t(a).requires_grad_() for a in diff]
    got = tfn(*tdiff, *[_t(a) for a in fixed])
    got.backward()
    assert _rel_err(got, ref) <= VAL_TOL
    for t, g in zip(tdiff, grads):
        if not np.asarray(g).any():  # an input the loss does not read
            assert t.grad is None or not t.grad.any()
        else:
            assert _rel_err(t.grad, g) <= GRAD_TOL


def test_masked_shape_terms_match_jax():
    masks = LOSS_CASES["elliptical_shape_soft_masks"][2][0]
    ref_obj, ref_valid = jax_losses._masked_shape_terms(jnp.asarray(masks), 10, 1e-6)
    got_obj, got_valid = t_losses._masked_shape_terms(_t(masks), 10, 1e-6)
    assert _rel_err(got_obj, ref_obj) <= VAL_TOL
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(ref_valid))
    assert got_valid.numpy().tolist() == [[True, False, False], [True, False, False]]


def test_shape_loss_without_a_valid_object_is_zero():
    empty = torch.zeros((2, 3, 8, 8), requires_grad=True)
    loss = t_losses.elliptical_shape_loss(empty)
    loss.backward()
    assert float(loss.detach()) == 0.0 and float(empty.grad.abs().max()) == 0.0
    one_class = torch.zeros((1, 4, 4, 1))
    assert float(t_losses.elliptical_shape_loss_soft_instances(one_class)) == 0.0


def test_gt_union_box_matches_jax():
    masks = np.zeros((3, 10, 16), np.int32)
    masks[0, 2:5, 3:9] = 1
    masks[0, 7, 12] = 1
    masks[1, 4:6, 0:2] = 2  # another class only: no object
    ref_box, ref_has = jax_e2e.gt_union_box(jnp.asarray(masks))
    box, has = t_e2e.gt_union_box(_t(masks).long())
    np.testing.assert_allclose(box.numpy(), np.asarray(ref_box), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(has.numpy(), np.asarray(ref_has))


# ---------------------------------------------------------------------------
# Connected components and instance selection: equal labels and masks
# ---------------------------------------------------------------------------


def _cc_masks():
    rng = np.random.default_rng(8)
    random = (rng.uniform(size=(3, 24, 28)) < np.array([0.3, 0.5, 0.6])[:, None, None]).astype(np.int32)
    ties = np.zeros((2, 24, 28), np.int32)
    for img in ties:  # areas 12, 9, 9, 9: top-2 must take the raster-first 9
        img[18:22, 2:5] = 1
        img[2:5, 20:23] = 1
        img[2:5, 3:6] = 1
        img[10:13, 10:13] = 1
    ties[1, 0:3, 8:11] = 1  # a fifth component ahead of all, also area 9
    snake = np.zeros((1, 24, 28), np.int32)  # one long component: diameter beyond 16 sweeps
    snake[0, ::2, 1:27] = 1
    snake[0, 1::4, 26] = 1
    snake[0, 3::4, 1] = 1
    return {"random": random, "ties": ties, "snake": snake}


CC_MASKS = _cc_masks()


@pytest.mark.parametrize("case", sorted(CC_MASKS))
@pytest.mark.parametrize("form", ["fast", "exact"])
def test_cc_labels_and_instances_match_jax(case, form):
    m = CC_MASKS[case]
    if form == "fast":
        jlabel, jtop = jax_cc.label_components_stencil, jax_cc.top_instances_dense
        tlabel, ttop = t_cc.label_components_stencil, t_cc.top_instances_dense
    else:
        jlabel, jtop = jax_cc.label_components, jax_cc.top_instances
        tlabel, ttop = t_cc.label_components, t_cc.top_instances
    ref = np.stack([np.asarray(jlabel(jnp.asarray(x))) for x in m])
    got = tlabel(_t(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    for k, min_area in ((2, 3), (4, 10)):
        pairs = [jtop(jnp.asarray(x), k, min_area=min_area) for x in ref]
        masks, areas = ttop(got, k, min_area=min_area)
        np.testing.assert_array_equal(masks.numpy(), np.stack([np.asarray(p[0]) for p in pairs]))
        np.testing.assert_array_equal(areas.numpy(), np.stack([np.asarray(p[1]) for p in pairs]))
    if case == "ties":
        masks, areas = ttop(got, 2, min_area=3)
        assert areas.numpy().tolist() == [[12.0, 9.0], [12.0, 9.0]]
        assert masks[0, 1, 2:5, 3:6].all() and masks[1, 1, 0:3, 8:11].all()  # the raster-first of the ties


def test_cc_stencil_splits_what_it_cannot_reach_and_exact_does_not():
    m = _t(CC_MASKS["snake"])
    n_stencil = len(set(t_cc.label_components_stencil(m, num_iters=16).unique().tolist()) - {-1})
    n_exact = len(set(t_cc.label_components(m).unique().tolist()) - {-1})
    assert n_exact == 1 and n_stencil > 1


# ---------------------------------------------------------------------------
# Feature fusion
# ---------------------------------------------------------------------------


def _fusion_cases():
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    rmap = rng.integers(-1, 4, (2, 4, 5)).astype(np.int32)  # -1 and 3 (>= R) give zeros
    return {
        "concat_pixel": ([f(2, 8, 10, 3)], f(2, 8, 10, 4), None, None, "concat"),
        "add_pixel": ([f(2, 8, 10, 4)], f(2, 8, 10, 4), None, None, "add"),
        "concat_resize_up_and_down": ([f(2, 6, 7, 3), f(2, 20, 22, 2)], f(2, 5, 9, 4), (12, 14), None, "concat"),
        "region_map_resized": ([f(2, 8, 10, 3)], f(3, 4), None, rmap, "concat"),
        "region_map_add": ([f(2, 4, 5, 4)], f(3, 4), None, rmap, "add"),
    }


FUSION_CASES = _fusion_cases()


@pytest.mark.parametrize("name", sorted(FUSION_CASES))
def test_fuse_features_value_and_grads_match_jax(name):
    f_u, f_g, size, rmap, method = FUSION_CASES[name]

    def jfn(fus, fg):
        return jax_fusion.fuse_features(fus, fg, size, None if rmap is None else jnp.asarray(rmap), method)

    with jax.default_matmul_precision("highest"):
        ref = jfn([jnp.asarray(a) for a in f_u], jnp.asarray(f_g))
        r = np.random.default_rng(1).standard_normal(ref.shape).astype(np.float32)
        g_u, g_g = jax.grad(lambda fus, fg: jnp.sum(jfn(fus, fg) * r), (0, 1))(
            [jnp.asarray(a) for a in f_u], jnp.asarray(f_g))
    t_u = [_t(a).requires_grad_() for a in f_u]
    t_g = _t(f_g).requires_grad_()
    got = t_fusion.FeatureFusion(method)(t_u, t_g, size, None if rmap is None else _t(rmap))
    (got * _t(r)).sum().backward()
    assert _rel_err(got, ref) <= VAL_TOL
    for t, g in zip(t_u + [t_g], list(g_u) + [g_g]):
        assert _rel_err(t.grad, g) <= GRAD_TOL


def test_fuse_features_rejects_what_jax_rejects():
    x = torch.zeros((1, 4, 4, 3))
    with pytest.raises(ValueError, match="must match"):
        t_fusion.fuse_features([x], torch.zeros((1, 4, 4, 2)), fusion_method="add")
    with pytest.raises(ValueError, match="region_to_pixel_map"):
        t_fusion.fuse_features([x], torch.zeros((3, 2)))
    with pytest.raises(NotImplementedError):
        t_fusion.fuse_features([x], torch.zeros((1, 4, 4, 2)), fusion_method="max")


# ---------------------------------------------------------------------------
# The dropout helper (flax semantics; JAX's random bits cannot be matched)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_rate_and_scaling(p):
    x = torch.ones(200_000)
    y = t_layers.dropout(x, p, torch.Generator().manual_seed(3))
    kept = y != 0
    # Binomial: the kept share within 5 standard deviations of 1 − p.
    sd = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - p)) <= 5 * sd
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / (1 - p)), rtol=0, atol=0)
    assert abs(float(y.mean()) - 1.0) <= 5 * sd / (1 - p)
    again = t_layers.dropout(x, p, torch.Generator().manual_seed(3))
    assert torch.equal(y, again) and not torch.equal(y, t_layers.dropout(x, p, torch.Generator().manual_seed(4)))
    half = t_layers.dropout(x.to(torch.bfloat16), p, torch.Generator().manual_seed(3))
    assert half.dtype == torch.bfloat16


def test_dropout_is_the_identity_at_rate_0_and_in_eval():
    x = torch.randn(50, generator=torch.Generator().manual_seed(1))
    assert t_layers.dropout(x, 0.0, torch.Generator()) is x
    assert t_layers.dropout(x, 0.5, None) is x
    with pytest.raises(ValueError, match="dropout rate"):
        t_layers.dropout(x, 1.0, torch.Generator())
