"""The ported slice as a whole: mingraph_unet_tpu_torch's MinGraphUNet
against the JAX package's, on the CPU, with the flax weights carried over
by ``convert.py``.

Configuration: the serving path (s2d U-Net levels 0 and 1, pooled
detection with ``detection_pre_pool = H / patch_size``) cut to init 32,
depth 2 (so the 128- and 256-channel s2d widths both appear) at 64² b2.
The BN running statistics are perturbed so that the fold is exercised.

Tolerances: f32 outputs agree to 2e-4 of max |ref| (PARITY.md M5) and the
hard patch labels are equal; the inputs are chosen so that the top-2
segment margin of every patch exceeds 1e-3, far above that bar, and both
segments are populated. bf16 outputs agree to 5e-2 of max |ref|: the two
frameworks round the bf16 activations at different points (cuDNN/oneDNN
fuse the bias into the conv, XLA does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingraph_unet_tpu.models.pipeline import MinGraphUNet as JaxMinGraphUNet
from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.convert import load_jax_variables
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.train.common import TrainState, make_optimizer
from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet, make_e2e_train_step

B, H = 2, 64
CONFIG = dict(init_features=32, depth=2, detection_pre_pool=H // 16)
# The JAX model's CPU auto keeps U-Net level 1 out of s2d; the port's choice
# follows from the shape (on at 64²).
JAX_CONFIG = dict(CONFIG, unet_s2d_level1=True)
COMPARED = ("logits", "pred_bboxes", "pred_confidence", "l_partition",
            "soft_assignments", "gat_feats", "region_embeddings")
JAX_KEY, IMAGE_SEED = 7, 6


def _images(seed: int) -> np.ndarray:
    """Normalized NHWC images: a disc of one colour on another, with noise
    (not constant: constant images tie the argmax and flatten hist-eq)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (B, 1, 1, 3))
    yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    cy, cx = H * rng.uniform(0.2, 0.8, (2, B, 1, 1))
    disc = ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.3 * H) ** 2)[..., None]
    img = np.where(disc, rng.uniform(0, 1, (B, 1, 1, 3)), base) + 0.05 * rng.standard_normal((B, H, H, 3))
    img = np.clip(img, 0, 1)
    return ((img - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])).astype(np.float32)


def _perturb_stats(tree):
    rng = np.random.default_rng(11)

    def f(path, leaf):
        if str(path[-1].key) == "mean":
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.2, jnp.float32)
        return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def jax_side():
    x = _images(IMAGE_SEED)
    jm32 = JaxMinGraphUNet(dtype=jnp.float32, **JAX_CONFIG)
    v = jax.jit(jm32.init)(jax.random.key(JAX_KEY), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": _perturb_stats(v["batch_stats"])}
    with jax.default_matmul_precision("highest"):
        out32 = jax.jit(jm32.apply)(v, jnp.asarray(x))
    out16 = jax.jit(JaxMinGraphUNet(dtype=jnp.bfloat16, **JAX_CONFIG).apply)(v, jnp.asarray(x))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return x, to_np(v), to_np(out32), to_np(out16)


def _port(variables, dtype):
    model = MinGraphUNet(dtype=dtype, device="cpu", **CONFIG)
    return load_jax_variables(model, variables)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)


def test_slice_matches_jax_f32(jax_side):
    x, variables, ref, _ = jax_side
    soft = ref["soft_assignments"]
    top2 = np.sort(soft, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3, "argmax margin too small for a stable label test"
    assert (ref["region_counts"] > 0).all(axis=-1).any(), "both segments must be populated in some image"
    out = _port(variables, torch.float32)(torch.from_numpy(x), full_res_outputs=True)
    for k in COMPARED:
        assert _rel_err(out[k], ref[k]) <= 2e-4, k
    np.testing.assert_array_equal(out["hard_patch_labels"].numpy(), ref["hard_patch_labels"])
    np.testing.assert_array_equal(out["region_counts"].numpy(), ref["region_counts"])
    assert _rel_err(out["f_g_pixel"], ref["f_g_pixel"]) <= 2e-4
    for i in range(2):
        assert _rel_err(out["encoder_skips"][i], ref["encoder_skips"][i]) <= 2e-4
        assert _rel_err(out["f_u"][i], ref["f_u"][i]) <= 2e-4


def test_slice_matches_jax_bf16(jax_side):
    x, variables, _, ref = jax_side
    out = _port(variables, torch.bfloat16)(torch.from_numpy(x))
    for k in ("logits", "pred_bboxes", "pred_confidence", "l_partition"):
        assert np.isfinite(out[k].numpy()).all(), k
        assert _rel_err(out[k], ref[k]) <= 5e-2, k
    assert "f_g_pixel" not in out and "encoder_skips" not in out


def test_entry_point_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card rule cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MinGraphUNet(**CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MinGraphUNet(device="cuda", **CONFIG)


@pytest.mark.parametrize("section,key,value", [
    ("fusion_detection", "use_dense_detection", True), (None, "num_detection_classes", 2),
    ("ablation", "use_patch_gat", False), ("ablation", "use_partition", False),
    ("ablation", "use_region_gat", False), ("ablation", "use_fusion", False)],
    ids=["dense_head", "class_scores", "no_patch_gat", "no_partition", "no_region_gat", "no_fusion"])
def test_each_config_trains_one_step(section, key, value):
    """A config that asks for the dense head, class scores or an ablation
    switch builds its model, serves on the reference-exact (non-pooled)
    path and takes one end-to-end train step with finite terms."""
    cfg = PipelineConfig()
    cfg.preprocessing.resize_dim = (32, 32)
    cfg.model.unet.init_features, cfg.model.unet.depth = 8, 2
    setattr(cfg.dataset if section is None else getattr(cfg.model, section), key, value)
    model = build_mingraph_unet(cfg, device="cpu")
    assert getattr(model, key) == value
    out = model.eval()(torch.zeros(1, 32, 32, 3), full_res_outputs=True)
    width = cfg.model.unet.init_features + (cfg.model.gat.output_dim if model.use_fusion else 0)
    assert out["fused"].shape == (1, 32, 32, width) and torch.isfinite(out["pred_bboxes"]).all()
    model.train()
    opt, sched = make_optimizer(model.parameters(), cfg.training, 1)
    state = TrainState(model, opt, sched)
    imgs = torch.from_numpy(np.clip(_images(IMAGE_SEED)[:, :32, :32] * 60 + 120, 0, 255).astype(np.uint8))
    masks = (imgs[..., 0] > 120).to(torch.uint8)
    aux = make_e2e_train_step(model, opt, cfg, augment=False)(state, imgs, masks, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in aux.values()) and state.step == 1
