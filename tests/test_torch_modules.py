"""Each ported module of mingraph_unet_tpu_torch against its JAX counterpart
on the same numpy inputs, on the CPU, with the flax weights carried over by
``convert.py``.

Tolerance: f32 results agree to 2e-4 of max |ref| (PARITY.md M5; the two
frameworks sum in other orders). Histogram equalization is integer-valued
and must be bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.models import detection as jax_det
from mingraph_unet_tpu.models import gat as jax_gat
from mingraph_unet_tpu.models import mincut as jax_mincut
from mingraph_unet_tpu.models import unet as jax_unet
from mingraph_unet_tpu.ops import filters as jax_filters
from mingraph_unet_tpu.ops import image as jax_image
from mingraph_unet_tpu.ops import lattice as jax_lattice
from mingraph_unet_tpu.ops import patches as jax_patches
from mingraph_unet_tpu.ops import s2d as jax_s2d
from mingraph_unet_tpu.ops import segment as jax_segment
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.models import detection as t_det
from mingraph_unet_tpu_torch.models import gat as t_gat
from mingraph_unet_tpu_torch.models import mincut as t_mincut
from mingraph_unet_tpu_torch.models import unet as t_unet
from mingraph_unet_tpu_torch.ops import filters as t_filters
from mingraph_unet_tpu_torch.ops import image as t_image
from mingraph_unet_tpu_torch.ops import lattice as t_lattice
from mingraph_unet_tpu_torch.ops import patches as t_patches
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops import segment as t_segment

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


# ---------------------------------------------------------------------------
# ops/s2d.py
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_X = _RNG.standard_normal((2, 8, 12, 6)).astype(np.float32)
_XS = _RNG.standard_normal((2, 4, 6, 24)).astype(np.float32)
_K3 = _RNG.standard_normal((3, 3, 6, 5)).astype(np.float32)
_K2 = _RNG.standard_normal((2, 2, 6, 5)).astype(np.float32)
_K1 = _RNG.standard_normal((1, 1, 6, 5)).astype(np.float32)
_V = _RNG.standard_normal(6).astype(np.float32)

# Each case calls the module ``m`` with arguments converted by ``a``.
S2D_CASES = {
    "space_to_depth": lambda m, a: m.space_to_depth(a(_X)),
    "depth_to_space": lambda m, a: m.depth_to_space(a(_XS)),
    "s2d_conv3x3_kernel": lambda m, a: m.s2d_conv3x3_kernel(a(_K3)),
    "s2d_conv3x3_kernel_groups": lambda m, a: m.s2d_conv3x3_kernel(a(_K3), (2, 4)),
    "s2d_vector": lambda m, a: m.s2d_vector(a(_V)),
    "s2d_convt2x2_kernel": lambda m, a: m.s2d_convt2x2_kernel(a(_K2)),
    "s2d_1x1_kernel": lambda m, a: m.s2d_1x1_kernel(a(_K1)),
    "windowed_down_kernel": lambda m, a: m.windowed_down_kernel(a(_K3)),
    "phase_max_pool": lambda m, a: m.phase_max_pool(a(_XS)),
    "patch_reduce_mean_s2d": lambda m, a: m.patch_reduce_mean_s2d(a(_XS), 4),
    "conv3x3_s2d": lambda m, a: m.conv3x3_s2d(a(_XS), m.s2d_conv3x3_kernel(a(_K3))),
    "conv3x3_s2d_const": lambda m, a: m.conv3x3_s2d_const(
        m.s2d_vector(a(_V)), m.s2d_conv3x3_kernel(a(_K3)), 4, 3
    ),
    "conv3x3_windowed_down": lambda m, a: m.conv3x3_windowed_down(a(_X), m.windowed_down_kernel(a(_K3))),
}


@pytest.mark.parametrize("name", sorted(S2D_CASES))
def test_s2d_op_matches_jax(name):
    with jax.default_matmul_precision("highest"):
        ref = S2D_CASES[name](jax_s2d, jnp.asarray)
    _assert_close_rel(S2D_CASES[name](t_s2d, _t), ref, 1e-5)


def test_s2d_round_trip_and_pool_is_maxpool():
    x = _t(_X)
    torch.testing.assert_close(t_s2d.depth_to_space(t_s2d.space_to_depth(x)), x, rtol=0, atol=0)
    pooled = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    torch.testing.assert_close(t_s2d.phase_max_pool(t_s2d.space_to_depth(x)), pooled, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# models/unet.py
# ---------------------------------------------------------------------------


def _perturb_stats(tree, seed=1):
    """Random running means and positive variances, so the BN fold is real."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = str(path[-1].key)
        if name == "mean":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.2, jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


# (H, W, s2d): level 0 and 1 in s2d; level 0 in s2d and level 1 standard
# (H/2 odd); all standard (H, W odd). The port picks the s2d levels from the
# shape; the JAX side is asked for them (its CPU auto keeps level 1 off).
@pytest.mark.parametrize("h,w,s2d", [(32, 32, True), (34, 20, True), (25, 23, False)])
def test_unet_matches_jax(h, w, s2d):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    jm = jax_unet.UNet(init_features=16, depth=2, s2d_level0=s2d, s2d_level1=s2d)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"])}
    with jax.default_matmul_precision("highest"):
        logits, skips, f_u = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = t_unet.UNet(_gen(), init_features=16, depth=2).eval()
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        out = tm(_t(x), full_res_outputs=True)
    assert (0 in out["skip_s2d"]) == s2d and (1 in out["skip_s2d"]) == (h % 4 == 0 and w % 4 == 0)
    _assert_close_rel(out["logits"], logits)
    for i in range(2):
        _assert_close_rel(out["skips"][i], skips[i])
        _assert_close_rel(out["f_u"][i], f_u[i])


def test_unet_lazy_full_res_outputs():
    tm = t_unet.UNet(_gen(), init_features=16, depth=2).eval()
    with torch.no_grad():
        out = tm(torch.randn(1, 16, 16, 3, generator=_gen()))
    assert out["skips"][:2] == [None, None] and out["f_u"][0] is None
    assert out["f_u"][1] is not None  # level 1's output feeds level 0


# ---------------------------------------------------------------------------
# ops/filters.py, ops/patches.py, ops/segment.py
# ---------------------------------------------------------------------------


def test_sobel_patch_mean_matches_jax():
    rgb = np.random.default_rng(3).uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    ref = jax_filters.sobel_patch_mean(jnp.asarray(rgb), 8)
    _assert_close_rel(t_filters.sobel_patch_mean(_t(rgb), 8), ref)


@pytest.mark.parametrize("kind", ["uniform", "low_contrast", "constant"])
def test_histeq_bit_exact(kind):
    rng = np.random.default_rng(4)
    if kind == "uniform":
        img = rng.integers(0, 256, (2, 64, 64, 3))
    elif kind == "low_contrast":
        img = rng.integers(90, 140, (2, 64, 48, 3))
    else:
        img = np.full((1, 16, 16, 3), 77)
    img = img.astype(np.uint8)
    ref = np.asarray(jax_filters.equalize_histogram_rgb_batched(jnp.asarray(img)))
    got = t_filters.equalize_histogram_rgb_batched(_t(img)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_image_ops_match_jax():
    x = np.random.default_rng(12).standard_normal((2, 5, 7, 3)).astype(np.float32)
    mean, std = t_image.IMAGENET_MEAN, t_image.IMAGENET_STD
    assert (mean, std) == (jax_image.IMAGENET_MEAN, jax_image.IMAGENET_STD)
    _assert_close_rel(t_image.denormalize(_t(x), mean, std), jax_image.denormalize(jnp.asarray(x), mean, std), 1e-6)
    _assert_close_rel(t_image.rgb_to_gray(_t(x)), jax_image.rgb_to_gray(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("direction", range(4))
def test_lattice_ops_match_jax(direction):
    assert t_lattice.DIRECTIONS == jax_lattice.DIRECTIONS
    dr, dc = t_lattice.DIRECTIONS[direction]
    x = np.random.default_rng(13).standard_normal((2, 4, 5, 3)).astype(np.float32)
    _assert_close_rel(t_lattice.shift(_t(x), dr, dc), jax_lattice.shift(jnp.asarray(x), dr, dc), 0.0)
    _assert_close_rel(t_lattice.neighbor_mask(4, 5, dr, dc), jax_lattice.neighbor_mask(4, 5, dr, dc), 0.0)


def test_patch_ops_match_jax():
    x = np.random.default_rng(5).standard_normal((2, 16, 24, 3)).astype(np.float32)
    _assert_close_rel(t_patches.patch_reduce_mean(_t(x), 8), jax_patches.patch_reduce_mean(jnp.asarray(x), 8))
    p = x[:, :2, :3]
    _assert_close_rel(t_patches.broadcast_patch_to_pixels(_t(p), 4),
                      jax_patches.broadcast_patch_to_pixels(jnp.asarray(p), 4), 0.0)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(6)
    vals = rng.standard_normal((2, 10, 5)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 10)).astype(np.int32)
    labels[1] = 0  # segments 1 and 2 empty in image 1
    rm, rc = jax_segment.segment_mean(jnp.asarray(vals), jnp.asarray(labels), 3)
    tm, tc = t_segment.segment_mean(_t(vals), _t(labels).long(), 3)
    _assert_close_rel(tm, rm)
    _assert_close_rel(tc, rc, 0.0)
    labels[0, 0] = -1  # negative label → zeros
    _assert_close_rel(t_segment.gather_rows(tm, _t(labels).long()),
                      jax_segment.gather_rows(rm, jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# models/gat.py, models/mincut.py, models/detection.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("concat", [True, False])
def test_lattice_gat_matches_jax(concat):
    x = np.random.default_rng(7).standard_normal((2, 5, 6, 12)).astype(np.float32)
    jm = jax_gat.LatticeGAT(out_features=16, num_heads=4, concat=concat)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    tm = t_gat.LatticeGAT(12, 16, 4, _gen(), concat=concat)
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        _assert_close_rel(tm(_t(x)), ref)


@pytest.mark.parametrize("concat", [True, False])
def test_dense_gat_matches_jax(concat):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 6, 10)).astype(np.float32)
    adj = (rng.uniform(size=(6, 6)) < 0.5).astype(np.float32)
    adj[2] = 0  # a node with no incoming edges aggregates to zero
    jm = jax_gat.DenseGAT(out_features=8, num_heads=2, concat=concat)
    v = jm.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(adj))
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(adj))
    tm = t_gat.DenseGAT(10, 8, 2, _gen(), concat=concat)
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        _assert_close_rel(tm(_t(x), _t(adj)), ref)


@pytest.mark.parametrize("backend", ["lattice", "dense"])
def test_gat_network_two_layers_matches_jax(backend):
    """Two layers: a concat layer at hidden_dim, then an averaging layer."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 4, 5, 6) if backend == "lattice" else (2, 5, 6)).astype(np.float32)
    adj = np.ones((5, 5), np.float32) - np.eye(5, dtype=np.float32)
    jm = jax_gat.GATNetwork(hidden_dim=8, output_dim=4, num_heads=2, num_layers=2, backend=backend)
    jargs = (jnp.asarray(x),) if backend == "lattice" else (jnp.asarray(x), jnp.asarray(adj))
    v = jm.init(jax.random.key(5), *jargs)
    ref = jm.apply(v, *jargs)
    tm = t_gat.GATNetwork(6, 8, 4, 2, _gen(), num_layers=2, backend=backend)
    load_jax_variables(tm, _np_tree(v))
    targs = (_t(x),) if backend == "lattice" else (_t(x), _t(adj))
    with torch.no_grad():
        _assert_close_rel(tm(*targs), ref)


def test_mincut_refinement_matches_jax():
    x = np.random.default_rng(9).standard_normal((2, 4, 5, 16)).astype(np.float32) * 0.5
    jm = jax_mincut.MinCutRefinement(num_segments=3, predictor_hidden=8, predictor_heads=2)
    v = jm.init(jax.random.key(3), jnp.asarray(x))
    loss, soft = jm.apply(v, jnp.asarray(x))
    tm = t_mincut.MinCutRefinement(16, 3, _gen(), predictor_hidden=8, predictor_heads=2)
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        t_loss, t_soft = tm(_t(x))
    _assert_close_rel(t_loss, loss)
    _assert_close_rel(t_soft, soft)


def test_detection_head_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 8, 8, 24)).astype(np.float32)
    jm = jax_det.DetectionHead(fc_hidden_dim=32)
    v = jm.init(jax.random.key(4), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"], 5)}
    with jax.default_matmul_precision("highest"):
        bb, conf = jm.apply(v, jnp.asarray(x))
    tm = t_det.DetectionHead(24, _gen(), fc_hidden_dim=32).eval()
    load_jax_variables(tm, _np_tree(v))
    with torch.no_grad():
        t_bb, t_conf = tm(_t(x))
    _assert_close_rel(t_bb, bb)
    _assert_close_rel(t_conf, conf)


# ---------------------------------------------------------------------------
# convert.py
# ---------------------------------------------------------------------------


def test_convert_is_strict():
    tm = t_gat.LatticeGAT(4, 8, 2, _gen())
    tree = {"params": {"heads": {k: np.asarray(p.detach()) for k, p in tm.heads.named_parameters()}}}
    load_jax_variables(tm, tree)
    assert set(variables_from_jax(tree)) == {"heads.W", "heads.a_src", "heads.a_dst"}
    missing = {"params": {"heads": {"W": tree["params"]["heads"]["W"]}}}
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(tm, missing)
    extra = {"params": {"heads": dict(tree["params"]["heads"], extra=np.zeros(1))}}
    with pytest.raises(ValueError, match="unused"):
        load_jax_variables(tm, extra)
    bad = {"params": {"heads": dict(tree["params"]["heads"], W=np.zeros((2, 4, 3)))}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tm, bad)


@pytest.mark.parametrize("name", [("gat", "GATNetwork"), ("mincut", "SegmentPredictor"),
                                  ("mincut", "MinCutRefinement")])
def test_dropout_defaults_match_flax(name):
    """Each module's default ``dropout_rate`` is the flax field's."""
    import inspect

    module, cls = name
    flax_cls = getattr({"gat": jax_gat, "mincut": jax_mincut}[module], cls)
    port_cls = getattr({"gat": t_gat, "mincut": t_mincut}[module], cls)
    want = flax_cls.__dataclass_fields__["dropout_rate"].default
    assert want == 0.1
    assert inspect.signature(port_cls.__init__).parameters["dropout_rate"].default == want
