"""The helper functions of the port's ops and losses against their JAX
counterparts on the CPU, on the same seeded numpy inputs: ``ops/image.py``
(resizes, preprocessing, the three random transforms), ``ops/filters.py``
(unbatched hist-eq, Gaussian smoothing), ``ops/patches.py``,
``ops/lattice.py::neighbor_stack``, ``ops/segment.py``, ``ops/s2d.py``,
``models/losses.py::elliptical_shape_loss_from_probs`` and
``data/native_loader.py::available``.

Tolerance: f32 results agree to 2e-4 of max |ref| (PARITY.md M5); integer
and label outputs are equal. The random transforms draw from a
``torch.Generator`` where JAX draws from a key, so the JAX function is
given the port's draws: ``jax.random.bernoulli`` and ``jax.random.uniform``
are patched to return the values the generator yields, in the port's
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.data import native_loader as j_nl
from mingraph_unet_tpu.models import losses as j_losses
from mingraph_unet_tpu.ops import filters as j_filters
from mingraph_unet_tpu.ops import image as j_image
from mingraph_unet_tpu.ops import lattice as j_lattice
from mingraph_unet_tpu.ops import patches as j_patches
from mingraph_unet_tpu.ops import s2d as j_s2d
from mingraph_unet_tpu.ops import segment as j_segment
from mingraph_unet_tpu_torch.data import native_loader as t_nl
from mingraph_unet_tpu_torch.models import losses as t_losses
from mingraph_unet_tpu_torch.ops import filters as t_filters
from mingraph_unet_tpu_torch.ops import image as t_image
from mingraph_unet_tpu_torch.ops import lattice as t_lattice
from mingraph_unet_tpu_torch.ops import patches as t_patches
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops import segment as t_segment

REL_TOL = 2e-4

_RNG = np.random.default_rng(21)
_IMG = _RNG.random((20, 24, 3)).astype(np.float32)
_IMGS = _RNG.random((2, 12, 10, 3)).astype(np.float32)
_U8 = _RNG.integers(0, 256, (20, 24, 3)).astype(np.uint8)
_U8[3:9, 5:14] = 200  # a flat block beside the noise
_GRAY = _RNG.integers(40, 120, (18, 22)).astype(np.uint8)
_MASK = np.zeros((20, 24), np.int32)
_MASK[4:15, 6:19] = 1
_MASK[8:11, 9:12] = 2
_MASKS = _RNG.integers(0, 3, (2, 12, 10)).astype(np.int32)
_GRID = _RNG.standard_normal((2, 3, 5, 4)).astype(np.float32)
_X6 = _RNG.standard_normal((2, 10, 13, 3)).astype(np.float32)
_S2D = _RNG.standard_normal((2, 4, 6, 24)).astype(np.float32)
_VALS = _RNG.standard_normal((2, 9, 5)).astype(np.float32)
_LABELS = _RNG.integers(-1, 5, (2, 9)).astype(np.int32)  # -1: outside every bucket
_WEIGHTS = _RNG.random((2, 9)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _check(got, ref):
    """Floats within REL_TOL of max |ref|; integers, bools and labels equal."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.floating):
        err = np.abs(got.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err <= REL_TOL, f"max error {err:.3g} of max |ref| > {REL_TOL}"
    else:
        np.testing.assert_array_equal(got, ref)


def _both(got, ref):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _check(g, r)
    else:
        _check(got, ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# Each case: (port call, JAX call), each taking its module(s) and an array
# converter. Deterministic functions only; the random ones follow.
CASES = {
    "resize_bilinear_down": lambda m, a: m.resize_bilinear(a(_IMG), (7, 11)),
    "resize_bilinear_up": lambda m, a: m.resize_bilinear(a(_IMG), (31, 37)),
    "resize_bilinear_mixed_batch": lambda m, a: m.resize_bilinear(a(_IMGS), (5, 17)),
    "resize_bilinear_no_antialias": lambda m, a: m.resize_bilinear(a(_IMG), (9, 5), antialias=False),
    "resize_bilinear_same": lambda m, a: m.resize_bilinear(a(_IMG), (20, 24)),
    "resize_nearest_hw": lambda m, a: m.resize_nearest(a(_MASK), (13, 31)),
    "resize_nearest_nhw": lambda m, a: m.resize_nearest(a(_MASKS), (5, 23)),
    "preprocess_image": lambda m, a: m.preprocess_image(a(_U8), (16, 12)),
    "preprocess_image_mean_std": lambda m, a: m.preprocess_image(a(_U8), (25, 30), (0.5, 0.4, 0.3), (0.2, 0.3, 0.4)),
    "preprocess_mask": lambda m, a: m.preprocess_mask(a(_MASK), (11, 13), 2),
    "preprocess_mask_three": lambda m, a: m.preprocess_mask(a(_MASKS), (24, 20), 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_image_helper_matches_jax(name):
    ref = CASES[name](j_image, jnp.asarray)
    got = CASES[name](t_image, _t)
    _check(got, ref)


FILTER_CASES = {
    "equalize_histogram_gray": lambda m, a: m.equalize_histogram_gray(a(_GRAY)),
    "equalize_histogram_rgb": lambda m, a: m.equalize_histogram_rgb(a(_U8)),
    "gaussian_blur_float": lambda m, a: m.gaussian_blur(a(_IMG)),
    "gaussian_blur_batch_3x7": lambda m, a: m.gaussian_blur(a(_IMGS), (3, 7), 1.7),
    "gaussian_blur_u8": lambda m, a: m.gaussian_blur(a(_U8), (5, 5), 1.2),
}


@pytest.mark.parametrize("name", sorted(FILTER_CASES))
def test_filter_helper_matches_jax(name):
    ref = FILTER_CASES[name](j_filters, jnp.asarray)
    got = FILTER_CASES[name](t_filters, _t)
    assert got.dtype == (torch.uint8 if ref.dtype == jnp.uint8 else torch.float32)
    _check(got, ref)


@pytest.mark.parametrize("ksize,sigma", [(5, 1.0), (3, 0.0), (7, 2.5)])
def test_gaussian_kernel_1d_matches_jax(ksize, sigma):
    np.testing.assert_allclose(t_filters.gaussian_kernel_1d(ksize, sigma),
                               j_filters.gaussian_kernel_1d(ksize, sigma), rtol=1e-12)
    with pytest.raises(ValueError, match="odd"):
        t_filters.gaussian_kernel_1d(4, 1.0)


# Structure helpers: (port, JAX) over (module, converter).
STRUCT_CASES = {
    "patch_grid_dims": (lambda a: t_patches.patch_grid_dims(13, 16, 4), lambda a: j_patches.patch_grid_dims(13, 16, 4)),
    "pad_to_multiple_nhwc": (lambda a: t_patches.pad_to_multiple(a(_X6), 4),
                             lambda a: j_patches.pad_to_multiple(a(_X6), 4)),
    "pad_to_multiple_nhw": (lambda a: t_patches.pad_to_multiple(a(_MASKS), 8),
                            lambda a: j_patches.pad_to_multiple(a(_MASKS), 8)),
    "patchify": (lambda a: t_patches.patchify(a(_X6), 4), lambda a: j_patches.patchify(a(_X6), 4)),
    "unpatchify": (lambda a: t_patches.unpatchify(t_patches.patchify(a(_X6), 5)),
                   lambda a: j_patches.unpatchify(j_patches.patchify(a(_X6), 5))),
    "neighbor_stack": (lambda a: t_lattice.neighbor_stack(a(_GRID)), lambda a: j_lattice.neighbor_stack(a(_GRID))),
    "segment_sum_matmul": (lambda a: t_segment.segment_sum_matmul(a(_VALS), a(_LABELS).long(), 5),
                           lambda a: j_segment.segment_sum_matmul(a(_VALS), a(_LABELS), 5)),
    "bincount_fixed": (lambda a: t_segment.bincount_fixed(a(_LABELS).long(), 6),
                       lambda a: j_segment.bincount_fixed(a(_LABELS), 6)),
    "bincount_fixed_weights": (lambda a: t_segment.bincount_fixed(a(_LABELS).long(), 4, a(_WEIGHTS)),
                               lambda a: j_segment.bincount_fixed(a(_LABELS), 4, a(_WEIGHTS))),
    "phase_mean": (lambda a: t_s2d.phase_mean(a(_S2D)), lambda a: j_s2d.phase_mean(a(_S2D))),
    "depth_to_space_grouped": (lambda a: t_s2d.depth_to_space_grouped(a(_S2D), (2, 4)),
                               lambda a: j_s2d.depth_to_space_grouped(a(_S2D), (2, 4))),
    "depth_to_space_grouped_one": (lambda a: t_s2d.depth_to_space_grouped(a(_S2D), (6,)),
                                   lambda a: j_s2d.depth_to_space_grouped(a(_S2D), (6,))),
}


@pytest.mark.parametrize("name", sorted(STRUCT_CASES))
def test_structure_helper_matches_jax(name):
    port, ref = STRUCT_CASES[name]
    got, want = port(_t), ref(jnp.asarray)
    if name == "patch_grid_dims":
        assert got == want
        return
    _both(got, want)


def _probs(seed, classes=2):
    """Softmax maps (B, H, W, C) whose argmax draws a few blobs."""
    rng = np.random.default_rng(seed)
    b, h, w = 2, 24, 20
    yy, xx = np.mgrid[:h, :w]
    logits = rng.standard_normal((b, h, w, classes)).astype(np.float32) * 0.3
    logits[0, ..., 1] += 3.0 * (((yy - 10) / 6.0) ** 2 + ((xx - 8) / 4.0) ** 2 < 1)
    logits[1, ..., 1] += 3.0 * (((yy - 14) / 3.0) ** 2 + ((xx - 12) / 7.0) ** 2 < 1)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("classes,fg,min_pixels", [(2, 1, 10), (3, 1, 10), (2, 1, 500), (2, 2, 10)])
def test_elliptical_shape_loss_from_probs_matches_jax(classes, fg, min_pixels):
    p = _probs(5, classes)
    ref = j_losses.elliptical_shape_loss_from_probs(jnp.asarray(p), fg, min_pixels)
    got = t_losses.elliptical_shape_loss_from_probs(_t(p), fg, min_pixels)
    assert got.shape == () and got.dtype == torch.float32
    _check(got, ref)


def test_native_loader_available(tmp_path):
    """The port's loader builds here (g++ and zlib), as the JAX one does."""
    assert t_nl.available() is True
    assert j_nl.available() in (True, False)  # JAX's depends on `make`; only its signature is held


# ---------------------------------------------------------------------------
# Random transforms: the JAX functions given the port's draws
# ---------------------------------------------------------------------------


def _patched_draws(monkeypatch, gen):
    """Make JAX's bernoulli / uniform return what the port draws from a copy
    of ``gen``: the next ``torch.rand`` value, as ``u < p`` or scaled to
    [minval, maxval)."""
    replay = torch.Generator().set_state(gen.get_state())

    def next_u():
        return float(torch.rand(1, generator=replay))

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(next_u() < p)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.float32(next_u())
        return jnp.asarray(minval, jnp.float32) + (jnp.asarray(maxval, jnp.float32) - minval) * u

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax.random, "uniform", uniform)


RANDOM_CASES = {
    # name: (JAX function, port function, kwargs, with mask)
    "flip": ("random_horizontal_flip", dict(prob=0.5), True),
    "flip_image_only": ("random_horizontal_flip", dict(prob=0.9), False),
    "rotation": ("random_rotation", dict(degrees=25.0), True),
    "rotation_image_only": ("random_rotation", dict(degrees=15.0), False),
    "crop": ("random_resized_crop", dict(prob=1.0), True),
    "crop_coin": ("random_resized_crop", dict(prob=0.5, scale=(0.5, 0.9), ratio=(0.5, 2.0)), True),
}


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transform_matches_jax_with_the_same_draws(monkeypatch, name, seed):
    fn, kwargs, with_mask = RANDOM_CASES[name]
    gen = torch.Generator().manual_seed(seed)
    args = (_IMG, _MASK) if with_mask else (_IMG,)
    with monkeypatch.context() as mp:
        _patched_draws(mp, gen)
        with jax.default_matmul_precision("highest"):
            ref = getattr(j_image, fn)(jax.random.key(seed), *map(jnp.asarray, args), **kwargs)
    got = getattr(t_image, fn)(gen, *map(_t, args), **kwargs)
    _both(got, ref)
    if with_mask:
        assert got[1].dtype == torch.int32


def test_random_transforms_draw_from_the_generator():
    """The same seed gives the same output; the draws advance the generator."""
    img = _t(_IMG)
    a = t_image.random_rotation(torch.Generator().manual_seed(3), img)
    b = t_image.random_rotation(torch.Generator().manual_seed(3), img)
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    first, second = t_image.random_rotation(gen, img), t_image.random_rotation(gen, img)
    assert not torch.equal(first, second)
