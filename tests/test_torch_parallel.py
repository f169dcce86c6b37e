"""The port's parallel layer (``mingraph_unet_tpu_torch/parallel/*``) and the
trainers' data parallelism, on the CPU.

The multi-process checks run in ``gloo`` processes spawned by
``tests/torch_parallel_workers.py`` (torch, numpy and the port only): one
module-scoped fixture starts three groups, of 4, 2 and 1 ranks, each with
a hard time limit, and hands every check's result to its own test here.
The references are computed in this process: the JAX functions on the
virtual 8-device CPU mesh of ``tests/conftest.py`` (Pallas in interpret
mode) and the port's unsharded functions.

Tolerances: sharded convs against the unsharded conv 1e-5 (f32, another
summation order at the shard borders for cuDNN-style convs); against JAX's
``sharded_psconv`` 5e-5, as ``tests/test_parallel.py``. Data-parallel steps
against the one-process port step: every loss, gradient, parameter and BN
statistic at 1e-5 of the leaf's largest value, a leaf whose gradient is
zero in exact arithmetic against the model's largest gradient. That
equality is held in f64 (model and parameters): in f32 the other
summation order of the ranks' sums is amplified by ill-conditioned
leaves (flax's variance E[z²] − E[z]², gradients that are sums of
cancelling terms such as the lattice GAT's ``a_dst``) to 3e-5 of a leaf
and more. The f32 data-parallel step is held against JAX's step on a
data-4 virtual mesh at ``tests/test_torch_train.py``'s tolerances, and the
trainers' f32 runs at world size 1 against the runs without a group.

Spatial-parallel training has its own fixture and groups (4 and 2 ranks,
each with its own time limit): the halo exchange under autograd against
its transpose and against ``jax.vjp`` of JAX's ``halo_exchange_rows``; the
sharded convs' gradients; the train-mode sharded U-Net; both train steps
with a spatial axis against the one-process steps in f64 at ``DP_TOL``
(the cuDNN-style sites sum a shard's two edge rows in another order, so
they are not bit-equal), the f32 segmentation step against JAX's H-sharded
step; and both trainers under ``spatial_parallel: 2``. The model options:
the e2e step with the dense detection head on data 2 (on connected
components and on annotated instances) and on spatial 2, and the
segmentation step with the rematerialized U-Net on spatial 2,
each against the plain one-process step in f64.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax import shard_map
from jax.sharding import PartitionSpec as P

from mingraph_unet_tpu.config import PipelineConfig as JaxPipelineConfig
from mingraph_unet_tpu.ops import s2d as jax_s2d
from mingraph_unet_tpu.ops.pallas.psconv import psconv_weights
from mingraph_unet_tpu.parallel import halo as jax_halo
from mingraph_unet_tpu.parallel import mesh as jax_mesh
from mingraph_unet_tpu.parallel import spatial as jax_spatial
from mingraph_unet_tpu.train import common as jax_common
from mingraph_unet_tpu.train import end_to_end as jax_e2e
from mingraph_unet_tpu.train import segmentation as jax_seg
from mingraph_unet_tpu.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.convert import load_jax_variables, variables_from_jax
from mingraph_unet_tpu_torch.models import losses as t_losses
from mingraph_unet_tpu_torch.models import unet as t_unet
from mingraph_unet_tpu_torch.models.unet import UNet
from mingraph_unet_tpu_torch.ops import cc as t_cc
from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc
from mingraph_unet_tpu_torch.ops import s2d as t_s2d
from mingraph_unet_tpu_torch.ops.kernels import psconv as t_psconv
from mingraph_unet_tpu_torch.parallel import data as t_data
from mingraph_unet_tpu_torch.parallel import mesh as t_mesh
from mingraph_unet_tpu_torch.parallel import spatial as t_spatial
from mingraph_unet_tpu_torch.train import end_to_end as t_e2e
from mingraph_unet_tpu_torch.train import segmentation as t_seg
from mingraph_unet_tpu_torch.data.dataset import BatchLoader
from test_torch_e2e import _start_variables, _zero_in_exact_arithmetic
from torch_parallel_workers import e2e_cfg, run_checks, seg_cfg, train_step

DP_TOL = 1e-5
VAL_TOL, GRAD_TOL = 2e-4, 1e-3  # against JAX (tests/test_torch_train.py)
JOB_TIMEOUT = {4: 150, 2: 120, 1: 90}  # seconds each group of ranks may take
SPATIAL_TIMEOUT = {4: 150, 2: 120}  # the spatial-training groups' own limits
F64_TOL = 1e-9  # the f64 train-mode sharded U-Net against the unsharded one, of each leaf's largest value


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# Inputs, made from seeds, for the workers and the references.
# ---------------------------------------------------------------------------

HALO_X = np.random.default_rng(1).standard_normal((2, 16, 5, 3)).astype(np.float32)
_r11 = np.random.default_rng(11)
CONV3 = (_r11.random((2, 32, 16, 3)).astype(np.float32), _r11.random((3, 3, 3, 5)).astype(np.float32))
_r12 = np.random.default_rng(12)
CONV5 = (_r12.random((1, 16, 8, 2)).astype(np.float32), _r12.random((5, 5, 2, 4)).astype(np.float32))


def _psconv_case(hh, seed=0, b=4):
    """tests/test_parallel.py::TestShardedPsconv's inputs (an s2d height of
    ``hh``): x (B, 2·hh, 8, 8) in s2d layout, a 3×3 kernel, a bias."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, 2 * hh, 8, 8)).astype(np.float32)
    k = (r.standard_normal((3, 3, 8, 8)) * 0.2).astype(np.float32)
    bias = r.standard_normal(8).astype(np.float32)
    return np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))), k, bias


PSCONV_MESHES = [(1, 4), (2, 2)]
PSCONV_X, PSCONV_K, PSCONV_B = _psconv_case(16)
ODD_X, ODD_K, ODD_B = _psconv_case(12, seed=3, b=2)  # s2d shards of 3 rows: not a multiple of the 4-row tile

UNET_CASES = {"depth2": (dict(in_channels=3, num_classes=2, init_features=4, depth=2), (2, 32, 16, 3)),
              "depth3": (dict(in_channels=3, num_classes=2, init_features=4, depth=3), (1, 64, 16, 3)),
              "depth2_no_bn": (dict(in_channels=3, num_classes=2, init_features=4, depth=2, use_batchnorm=False),
                               (2, 32, 16, 3))}
_r7, _r6 = np.random.default_rng(7), np.random.default_rng(6)
JAX_CONV_SCENE = _r7.random((1, 64, 64, 3)).astype(np.float32)
JAX_CONV_K = _r6.random((3, 3, 3, 2)).astype(np.float32)


def _unet(args, seed):
    """A U-Net with seeded weights and perturbed BN statistics (so the folds
    are real), in eval mode."""
    model = UNet(torch.Generator().manual_seed(seed), **args)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.2)
            else:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model.eval()


def _scene(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


SEG_CFG = dict(size=64, init=8, batch=8)
# The 4 ranks' mesh (data, dcn), augmentation, dtype.
SEG_CASES = {"f64_data4": (4, 1, True, "float64"), "f64_dcn2_data2": (2, 2, True, "float64"),
             "f32_data4_jax": (4, 1, False, "float32")}


def _seg_batch(seed=5):
    r = np.random.default_rng(seed)
    s, b = SEG_CFG["size"], SEG_CFG["batch"]
    return r.integers(0, 256, (b, s, s, 3)).astype(np.uint8), r.integers(0, 2, (b, s, s)).astype(np.uint8)


def _seg_start():
    """The JAX U-Net's init as the port's state."""
    jcfg = JaxPipelineConfig()
    jcfg.model.unet = dataclasses.replace(jcfg.model.unet, init_features=SEG_CFG["init"], depth=2)
    variables = jax_seg.build_unet(jcfg).init(jax.random.key(2), jnp.zeros((1, 64, 64, 3)))
    model = load_jax_variables(t_seg.build_unet(seg_cfg(**SEG_CFG), device="cpu"), _np_tree(variables))
    return _state(model), variables


E2E_B, E2E_S = 4, 32


def _e2e_batch(empty_rank1: bool, seed=46, instances: bool = False):
    """Orchard-like images with fruit discs; with ``empty_rank1`` the second
    rank's two images are bare ground (no object, no positive image); with
    ``instances`` also each disc as an annotated instance, (B, 2, S, S)
    uint8 (the same draws either way)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:E2E_S, :E2E_S]
    mask = np.zeros((E2E_B, E2E_S, E2E_S), np.uint8)
    inst = np.zeros((E2E_B, 2, E2E_S, E2E_S), np.uint8)
    for i in range(E2E_B):
        if empty_rank1 and i >= E2E_B // 2:
            continue
        for k in range(1 + i % 2):
            cy, cx = rng.uniform(0.25 * E2E_S, 0.75 * E2E_S, 2)
            r = rng.uniform(0.12 * E2E_S, 0.2 * E2E_S)
            inst[i, k] = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            mask[i] |= inst[i, k]
    img = np.where(mask[..., None] == 1, np.array([230, 140, 30]), np.array([40, 110, 35]))
    img = img + rng.normal(0, 25, (E2E_B, E2E_S, E2E_S, 3))
    batch = np.clip(img, 0, 255).astype(np.uint8), mask
    return batch + (inst,) if instances else batch


def _e2e_start(dense: bool = False):
    """The JAX model's start (``_start_variables``) as the port's state;
    ``dense``: with the dense detection head."""
    jcfg = JaxPipelineConfig()
    jcfg.preprocessing = dataclasses.replace(jcfg.preprocessing, resize_dim=(E2E_S, E2E_S))
    jcfg.model.unet = dataclasses.replace(jcfg.model.unet, init_features=4, depth=2)
    jcfg.model.gat = dataclasses.replace(jcfg.model.gat, hidden_dim=8, output_dim=4, num_heads=2)
    jcfg.model.graph_construction = dataclasses.replace(jcfg.model.graph_construction, patch_size=8,
                                                        unet_patch_feature_dim=4)
    jcfg.model.fusion_detection = dataclasses.replace(jcfg.model.fusion_detection, use_dense_detection=dense)
    jcfg.training = dataclasses.replace(jcfg.training, loss_balance="uncertainty")
    jm = jax_e2e.build_mingraph_unet(jcfg, dtype=jnp.float32)
    model = t_e2e.build_mingraph_unet(e2e_cfg(dense=dense), device="cpu")
    return _state(load_jax_variables(model, _np_tree(_start_variables(jm, jcfg))))


E2E_CASES = {"f64_equal": False, "f64_rank1_empty": True}


def _dummy_runs(root):
    """Two identical ``make_dummy_run`` directories (SGD, one worker) for
    the world-size-1 trainer runs, each with its own checkpoints and logs."""
    dirs = {}
    for key in ("seg", "e2e"):
        for side in ("gloo", "none"):
            d = os.path.join(root, f"{key}_{side}")
            cfg_dir = make_dummy_run(d, num_images=4, image_size=(32, 32), batch_size=2, num_epochs=1,
                                     patch_size=8, init_features=4, depth=2)
            path = os.path.join(cfg_dir, "training.yaml")
            text = open(path).read().replace("optimizer: adam", "optimizer: sgd")
            open(path, "w").write(re.sub(r"num_workers: \d+", "num_workers: 0", text))
            dirs[key, side] = cfg_dir
    return dirs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process check, in three spawned groups (4, 2, 1 ranks)."""
    seg_state, seg_vars = _seg_start()
    seg_imgs, seg_masks = _seg_batch()
    e2e_state, dense_state = _e2e_start(), _e2e_start(dense=True)
    unets = {k: _unet(args, seed=3) for k, (args, _) in UNET_CASES.items()}
    four = [("mesh_layout", {}), ("halo_rows", {"x": HALO_X}), ("sharded_conv", {"x": CONV3[0], "k": CONV3[1]}),
            ("sharded_psconv", {"cases": [(m, PSCONV_X, PSCONV_K, PSCONV_B) for m in PSCONV_MESHES]
                                + [((1, 4), ODD_X, ODD_K, ODD_B)]}),
            ("all_reduce_grad", {})]
    for k in sorted(UNET_CASES):
        args, shape = UNET_CASES[k]
        four.append(("spatial_apply", {"unet_state": _state(unets[k]), "unet_args": args,
                                       "scene": _scene(shape, 9), "conv_scene": JAX_CONV_SCENE,
                                       "conv_k": JAX_CONV_K}))
    for k in sorted(SEG_CASES):
        dp, dcn, augment, dtype = SEG_CASES[k]
        four.append(("train_step", dict(kind="seg", state=seg_state, cfg_args=SEG_CFG, imgs=seg_imgs, masks=seg_masks,
                                        dtype=dtype, seed=4, dp=dp, dcn=dcn, augment=augment)))
    two = [("sharded_conv", {"x": CONV5[0], "k": CONV5[1]})]
    for k in sorted(E2E_CASES):
        imgs, masks = _e2e_batch(E2E_CASES[k])
        two.append(("train_step", dict(kind="e2e", state=e2e_state, cfg_args={}, imgs=imgs, masks=masks,
                                       dtype="float64", seed=7)))
    imgs, masks = _e2e_batch(True)
    two.append(("train_step", dict(kind="e2e", state=dense_state, cfg_args={"dense": True}, imgs=imgs, masks=masks,
                                   dtype="float64", seed=7)))
    imgs, masks, inst = _e2e_batch(True, instances=True)
    two.append(("train_step", dict(kind="e2e", state=dense_state, cfg_args={"dense": True}, imgs=imgs, masks=masks,
                                   instances=inst, dtype="float64", seed=7)))
    dirs = _dummy_runs(str(tmp_path_factory.mktemp("dummy")))
    one = [("trainers", {"seg_dir": dirs["seg", "gloo"], "e2e_dir": dirs["e2e", "gloo"]})]
    results = {w: run_checks(checks, w, JOB_TIMEOUT[w]) for w, checks in ((4, four), (2, two), (1, one))}

    def pick(world, name, index=0):
        """Each rank's result of the ``index``-th run of check ``name``."""
        position = [i for i, (n, _) in enumerate({4: four, 2: two, 1: one}[world]) if n == name][index]
        out = [rank_results[position] for rank_results in results[world]]
        for res in out:
            if isinstance(res, dict) and "error" in res:
                pytest.fail(f"{name} failed on a rank:\n{res['error']}")
        return out

    return dict(pick=pick, seg_state=seg_state, seg_vars=seg_vars, seg_batch=(seg_imgs, seg_masks),
                e2e_state=e2e_state, dense_state=dense_state, unets=unets, dirs=dirs)


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------


def test_make_mesh_data_parallel_4(runs):
    for r, got in enumerate(runs["pick"](4, "mesh_layout")):
        assert got["data4"] == dict(shape=(1, 4, 1), coords=(0, r, 0), batch_ranks=(0, 1, 2, 3), spatial_ranks=(r,),
                                    batch_index=r)


def test_make_mesh_data_0_takes_the_remaining_ranks(runs):
    for r, got in enumerate(runs["pick"](4, "mesh_layout")):
        assert got["data0_spatial2"]["shape"] == (1, 2, 2)
        assert got["data0_spatial2"]["spatial_ranks"] == (2 * (r // 2), 2 * (r // 2) + 1)


def test_make_mesh_refuses_more_or_fewer_ranks_than_exist(runs):
    for got in runs["pick"](4, "mesh_layout"):
        assert "needs 8 ranks, only 4 available" in got["too_many"]
        assert "uses 2 of the 4 ranks" in got["too_few"]


def test_make_mesh_dcn_data_spatial(runs):
    """(dcn 2, data 1, spatial 2) on 4 ranks: the batch axis is dcn × data,
    rank r at (r // 2, 0, r % 2), as JAX's devices.reshape(2, 1, 2)."""
    x = np.arange(4 * 8).reshape(4, 8, 1, 1)
    for r, got in enumerate(runs["pick"](4, "mesh_layout")):
        m = got["dcn2_spatial2"]
        b, s = r // 2, r % 2
        assert m["shape"] == (2, 1, 2) and m["coords"] == (b, 0, s) and m["batch_index"] == b
        assert m["batch_ranks"] == (s, 2 + s) and m["spatial_ranks"] == (2 * b, 2 * b + 1)
        np.testing.assert_array_equal(m["shard"], x[2 * b : 2 * b + 2, 4 * s : 4 * s + 4])


def test_make_mesh_without_a_process_group():
    mesh = t_mesh.make_mesh()
    assert mesh.trivial and not mesh.distributed and mesh.batch_index == 0
    x = torch.arange(6.0)
    assert t_mesh.shard_batch(x, mesh, spatial=True) is x and t_mesh.replicate(x, mesh) is x
    with pytest.raises(ValueError, match="needs 2 ranks, only 1 available"):
        t_mesh.make_mesh(2)


# ---------------------------------------------------------------------------
# parallel/halo.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_rows(runs, halo):
    """Each shard of 4 receives its neighbours' rows, None at the borders."""
    h = HALO_X.shape[1] // 4
    for r, got in enumerate(runs["pick"](4, "halo_rows")):
        top, bottom = got[halo]
        assert (top is None) == (r == 0) and (bottom is None) == (r == 3)
        if top is not None:
            np.testing.assert_array_equal(top, HALO_X[:, r * h - halo : r * h])
        if bottom is not None:
            np.testing.assert_array_equal(bottom, HALO_X[:, (r + 1) * h : (r + 1) * h + halo])


def _conv_same(x, k):
    from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc

    return conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(k), padding=k.shape[0] // 2).numpy()


CONV_CASES = {"3x3_on_4": (4, CONV3), "5x5_on_2": (2, CONV5)}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_sharded_conv2d_same_matches_unsharded(runs, case):
    world, (x, k) = CONV_CASES[case]
    for got in runs["pick"](world, "sharded_conv"):
        np.testing.assert_allclose(got, _conv_same(x, k), atol=1e-5)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_sharded_conv2d_same_matches_jax(runs, case):
    world, (x, k) = CONV_CASES[case]
    with jax.default_matmul_precision("highest"):
        ref = jax_halo.sharded_conv2d_same(jnp.asarray(x), jnp.asarray(k), jax_mesh.make_mesh(1, world))
    for got in runs["pick"](world, "sharded_conv"):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("mesh_shape", PSCONV_MESHES)
def test_sharded_psconv_matches_jax(runs, mesh_shape):
    """The port's sharded_psconv (the plain K9 per shard) against JAX's
    (halo ppermute + the Pallas kernel in interpret mode) and the port's
    unsharded conv."""
    with jax.default_matmul_precision("highest"):
        ref = jax_halo.sharded_psconv(jnp.asarray(PSCONV_X), psconv_weights(jnp.asarray(PSCONV_K)),
                                      jax_s2d.s2d_vector(jnp.asarray(PSCONV_B)), jax_mesh.make_mesh(*mesh_shape),
                                      relu=True, interpret=True)
    whole = t_psconv.psel_conv3x3_plain(*(torch.from_numpy(a.copy()) for a in (PSCONV_X, PSCONV_K, PSCONV_B))).numpy()
    for got in runs["pick"](4, "sharded_psconv"):
        got = got[PSCONV_MESHES.index(mesh_shape)]
        np.testing.assert_allclose(got, np.asarray(ref), atol=5e-5)
        np.testing.assert_allclose(got, whole, atol=1e-5)


def test_sharded_psconv_odd_shard_height(runs):
    """s2d shards of 3 rows (not a multiple of the kernel's 4-row tile)."""
    whole = t_psconv.psel_conv3x3_plain(*(torch.from_numpy(a) for a in (ODD_X, ODD_K, ODD_B))).numpy()
    for got in runs["pick"](4, "sharded_psconv"):
        np.testing.assert_allclose(got[-1], whole, atol=1e-5)


def _shards(t, cuts):
    """(shard, top row, bottom row, first row) of each shard of ``t`` (the
    exchange done by hand), None at the borders."""
    h = t.shape[1]
    return [(t[:, a:e], t[:, a - 1 : a] if a > 0 else None, t[:, e : e + 1] if e < h else None, a)
            for a, e in zip(cuts[:-1], cuts[1:])]


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("cuts", [[0, 3, 6, 9, 12], [0, 1, 5, 12]])
def test_plain_halo_forms_stitch_to_the_unsharded_forms(cuts):
    """K9's and K2's sharded plain forms, stitched, equal the unsharded plain
    forms; K2 with local border rows (row0 0 on every shard) does not: an
    inner shard's first row would take the upsample above it for padding."""
    g = torch.Generator().manual_seed(0)
    c = 16
    x = torch.randn((2, 12, 5, 4 * c), generator=g)
    k, bias = torch.randn((3, 3, c, c), generator=g) * 0.2, torch.randn(c, generator=g)
    got = torch.cat([t_psconv.psel_conv3x3_halo(s, top, bot, k, bias) for s, top, bot, _ in _shards(x, cuts)], 1)
    assert _rel(got, t_psconv.psel_conv3x3_plain(x, k, bias)) <= 1e-6

    skip, prev = torch.randn((2, 12, 5, 4 * c), generator=g), torch.randn((2, 12, 5, 2 * c), generator=g)
    kernel, kt = torch.randn((3, 3, 2 * c, c), generator=g) * 0.2, torch.randn((2, 2, 2 * c, c), generator=g) * 0.2
    bias_up = torch.randn(c, generator=g) * 3.0
    k_skip, k_prev = t_psconv.dec_conv1_weights(kernel, c, t_s2d.s2d_convt2x2_kernel(kt))
    t9 = t_psconv.dec_conv1_bias_table(kernel, c, bias_up, bias)
    whole = t_psconv.dec_conv1_fused_plain(skip, prev, k_skip, k_prev, t9)
    parts = list(zip(_shards(skip, cuts), _shards(prev, cuts)))
    sharded = torch.cat([t_psconv.dec_conv1_halo(s, st, sb, p, pt, pb, k_skip, k_prev, t9, row0, 12)
                         for (s, st, sb, row0), (p, pt, pb, _) in parts], 1)
    local = torch.cat([t_psconv.dec_conv1_halo(s, st, sb, p, pt, pb, k_skip, k_prev, t9, 0, s.shape[1])
                       for (s, st, sb, _), (p, pt, pb, _) in parts], 1)
    assert _rel(sharded, whole) <= 1e-6
    assert _rel(local, whole) > 1e-2


# ---------------------------------------------------------------------------
# parallel/spatial.py: the sharded U-Net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_spatial_sharded_unet_matches_unsharded(runs, case):
    """The U-Net's eval forward on 4 H-shards (depth 2: every level in s2d
    but the bottleneck; depth 3: a standard encoder level and decoder block
    too) equals the unsharded forward."""
    args, shape = UNET_CASES[case]
    with torch.no_grad():
        ref = runs["unets"][case](torch.from_numpy(_scene(shape, 9)))
    got = runs["pick"](4, "spatial_apply", sorted(UNET_CASES).index(case))
    for g in got:
        for key, r in (("logits", ref["logits"]), ("f_u_s2d0", ref["f_u_s2d"][0])):
            r = r.numpy()
            assert g[key].shape == r.shape
            assert np.abs(g[key] - r).max() <= 1e-5 * np.abs(r).max(), key


def _folded_conv_block(x, w1, s1, b1, w2, s2, b2):
    """``fused_conv_block``'s function with each scale folded into its
    kernel, through ``conv2d_nhwc``: what a standard ConvBlock's convs
    compute on an H-shard (``ConvBlock.folded``)."""
    for w, s, b in ((w1, s1, b1), (w2, s2, b2)):
        x = torch.relu(conv2d_nhwc(x, w * s, b, padding=1))
    return x


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_spatial_sharded_unet_on_one_shard_is_the_unsharded_forward(case, monkeypatch):
    """On a spatial axis of one rank no row is exchanged and every conv site
    runs its unsharded op (the cuDNN convs with their own padding, BN
    folded into the standard blocks' kernels), so the sharded forward is
    bit for bit the unsharded one with its standard blocks in that folded
    form; and within 1e-5 of max |logits| of the unsharded forward itself,
    whose f32 standard blocks run ``fused_conv_block`` (BN applied after
    each conv)."""
    args, shape = UNET_CASES[case]
    model = _unet(args, seed=3)
    x = torch.from_numpy(_scene(shape, 9))
    with torch.no_grad():
        fused = model(x)["logits"]
        monkeypatch.setattr(t_unet, "fused_conv_block", _folded_conv_block)
        ref = model(x)["logits"]
        got = t_spatial.spatial_sharded_apply(lambda xl, spatial: model(xl, spatial=spatial)["logits"], x,
                                              t_mesh.make_mesh())
    assert torch.equal(got, ref)
    torch.testing.assert_close(fused, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def test_spatial_sharded_apply_conv_matches_jax(runs):
    """JAX's ``spatial_sharded_apply(conv, ...)`` case (tests/test_parallel.py)."""
    k = jnp.asarray(JAX_CONV_K)

    def conv(x):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    with jax.default_matmul_precision("highest"):
        ref = jax_spatial.spatial_sharded_apply(conv, jnp.asarray(JAX_CONV_SCENE), jax_mesh.make_mesh(1, 4))
    for g in runs["pick"](4, "spatial_apply"):
        np.testing.assert_allclose(g["conv"], np.asarray(ref), atol=1e-5)


def test_sharded_forward_refuses_what_it_cannot_shard():
    """Shard heights off the rule raise, in eval and in train mode; a train
    forward on one shard (no row exchanged, every site its unsharded op) is
    the unsharded train forward bit for bit."""
    mesh = t_mesh.make_mesh()
    model = _unet(UNET_CASES["depth2"][0], seed=3)
    for train in (False, True):
        model.train(train)
        with pytest.raises(ValueError, match="multiple of 2\\^\\(depth \\+ 1\\)"):
            model(torch.zeros((1, 12, 16, 3)), spatial=t_spatial.SpatialShard(mesh, 0, 12))
        with pytest.raises(ValueError, match="do not make the scene"):
            model(torch.zeros((1, 16, 16, 3)), spatial=t_spatial.SpatialShard(mesh, 0, 32))
    x = torch.from_numpy(_scene((2, 16, 16, 3), 9))
    assert model.training
    assert torch.equal(model(x, spatial=t_spatial.SpatialShard(mesh, 0, 16))["logits"], model(x)["logits"])
    spatial2 = t_mesh.Mesh((1, 1, 2), (0, 0, 0))
    with pytest.raises(ValueError, match="equal shards"):
        t_spatial.spatial_sharded_apply(lambda x, spatial: x, torch.zeros((1, 9, 4, 3)), spatial2)


# ---------------------------------------------------------------------------
# parallel/data.py and the trainers
# ---------------------------------------------------------------------------


def test_all_reduce_sum_backward_sums_the_cotangents(runs):
    """The loss rule: each rank's loss is its contribution and the gradients
    are summed. Rank r's loss (r + 1)·Σx gives every x_r the gradient
    1 + 2 + 3 + 4."""
    for got in runs["pick"](4, "all_reduce_grad"):
        assert got == {"y": 10.0, "grad": 10.0}


def _feeds_bn(name):
    return re.search(r"(^|\.)conv[12]\.bias$", name) is not None and "detection_head" not in name


def _check_leaves(got, ref, exact_zero, lr):
    """Gradients and BN statistics at DP_TOL of each leaf's largest value, a
    gradient that is zero in exact arithmetic at DP_TOL of the model's
    largest gradient ``top``; parameters after the SGD update at DP_TOL of
    their largest value plus lr·DP_TOL·top, what the update adds."""
    top = max(np.abs(v).max() for k, v in ref.items() if k.startswith("grad:"))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        if k == "metrics":
            for m, v in r.items():
                assert abs(got[k][m] - v) <= DP_TOL * max(abs(v), 1e-6), m
            continue
        kind, name = k.split(":", 1)
        if kind == "grad" and exact_zero(name):
            tol = DP_TOL * top
        else:
            tol = DP_TOL * np.abs(r).max() + (lr * DP_TOL * top if kind == "param" else 0.0)
        assert np.abs(got[k] - r).max() <= tol, k


def _one_process(kind, state, imgs, masks, case_args):
    """The one-process step on the whole batch (the port, no group)."""
    return train_step(kind, state, imgs=imgs, masks=masks, mesh=None, **case_args)


@pytest.mark.parametrize("case", [c for c in sorted(SEG_CASES) if c.startswith("f64")])
def test_data_parallel_segmentation_step_matches_one_process(runs, case):
    """One step on 4 ranks (data 4, or dcn 2 × data 2) of a global batch of
    8 equals the one-process step on the batch: augmentation, BN over the
    global batch, CE + Dice, gradients, SGD update and running statistics."""
    dp, dcn, augment, dtype = SEG_CASES[case]
    imgs, masks = runs["seg_batch"]
    ref = _one_process("seg", runs["seg_state"], imgs, masks,
                       dict(cfg_args=SEG_CFG, dtype=dtype, seed=4, augment=augment))
    for got in runs["pick"](4, "train_step", sorted(SEG_CASES).index(case)):
        _check_leaves(got, ref, _feeds_bn, seg_cfg(**SEG_CFG).training.learning_rate)


def _check_against_jax_step(runs, mesh, imgs, masks, spatial, got, exact=None):
    """Each rank's f32 step without augmentation (``got``) against the JAX
    trainer's step on the virtual ``mesh`` (the batch sharded over H too
    with ``spatial``), at tests/test_torch_train.py's tolerances. With
    ``exact`` (the parameters after the f64 one-process step), a leaf's
    tolerance also takes JAX's own distance from it: the port is not held
    closer to JAX's f32 step than that step is to the exact one."""
    jcfg = JaxPipelineConfig()
    jcfg.model.unet = dataclasses.replace(jcfg.model.unet, init_features=SEG_CFG["init"], depth=2)
    jcfg.training = dataclasses.replace(jcfg.training, optimizer="sgd")
    jm = jax_seg.build_unet(jcfg)
    tx, _ = jax_common.make_optimizer(jcfg.training, 1)
    variables = runs["seg_vars"]
    with mesh, jax.default_matmul_precision("highest"):
        jstate, jmetrics = jax.jit(jax_seg.make_train_step(jm, tx, jcfg, augment=False))(
            jax_common.TrainState.create(variables, tx), jax_mesh.shard_batch(jnp.asarray(imgs), mesh, spatial),
            jax_mesh.shard_batch(jnp.asarray(masks), mesh, spatial), jax.random.key(0))
    ref_p = variables_from_jax({"params": _np_tree(jstate.params)})
    start = variables_from_jax({"params": _np_tree(variables["params"])})
    ref_s = variables_from_jax({"batch_stats": _np_tree(jstate.batch_stats)})
    for res in got:
        for k in ("loss", "ce", "dice"):
            assert abs(res["metrics"][k] - float(jmetrics[k])) <= VAL_TOL * abs(float(jmetrics[k])), k
        top = max(np.abs(r.numpy() - start[n].numpy()).max() for n, r in ref_p.items())
        for n, r in ref_p.items():
            upd, upd_ref = res[f"param:{n}"] - start[n].numpy(), r.numpy() - start[n].numpy()
            # A bias that feeds BN has a zero gradient in exact arithmetic:
            # its update is rounding noise, held to the largest update.
            scale = top if _feeds_bn(n) else np.abs(upd_ref).max()
            tol = GRAD_TOL * scale + 2 * np.spacing(np.abs(r.numpy())).max()
            if exact is not None:
                tol += np.abs(r.numpy() - exact[f"param:{n}"]).max()
            assert np.abs(upd - upd_ref).max() <= tol, n
        for n, r in ref_s.items():
            assert np.abs(res[f"stat:{n}"] - r.numpy()).max() <= VAL_TOL * np.abs(r.numpy()).max(), n


def test_data_parallel_segmentation_step_matches_jax(runs):
    """The data-4 step (no augmentation) against the JAX trainer's step on a
    data-4 virtual mesh, at tests/test_torch_train.py's tolerances."""
    imgs, masks = runs["seg_batch"]
    _check_against_jax_step(runs, jax_mesh.make_mesh(4, 1), imgs, masks, spatial=False,
                            got=runs["pick"](4, "train_step", sorted(SEG_CASES).index("f32_data4_jax")))


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_data_parallel_e2e_step_matches_one_process(runs, case, monkeypatch):
    """One end-to-end step on 2 ranks of a global batch of 4 (augmentation,
    dropout, the uncertainty balancer, detection trained) equals the
    one-process step. In ``rank1_empty`` the second rank has no positive
    image and other valid L_shape objects than the first, so a per-rank
    mean in L_shape or L_bbox would show."""
    imgs, masks = _e2e_batch(E2E_CASES[case])
    valid = []
    terms = t_losses._masked_shape_terms

    def record(*args, **kwargs):
        per_obj, v = terms(*args, **kwargs)
        valid.append(v.sum(-1).numpy())
        return per_obj, v

    monkeypatch.setattr(t_losses, "_masked_shape_terms", record)
    ref = _one_process("e2e", runs["e2e_state"], imgs, masks, dict(cfg_args={}, dtype="float64", seed=7))
    assert ref["metrics"]["l_shape"] > 0.0 and "bal_s_l_shape" in ref["metrics"]
    if E2E_CASES[case]:
        assert masks[2:].sum() == 0 and masks[:2].sum() > 0
        assert valid[0][:2].sum() != valid[0][2:].sum(), valid
    for got in runs["pick"](2, "train_step", sorted(E2E_CASES).index(case)):
        _check_leaves(got, ref, _zero_in_exact_arithmetic, e2e_cfg().training.learning_rate)


def test_data_parallel_e2e_step_with_the_dense_head_matches_one_process(runs):
    """One end-to-end step with the dense detection head on 2 ranks of a
    global batch of 4, the second rank's images without an object, equals
    the one-process step: the dense loss's BCE is the mean over every
    image's cells and its L1 is over every rank's instances (a per-rank
    mean or count would differ here)."""
    imgs, masks = _e2e_batch(True)
    ref = _one_process("e2e", runs["dense_state"], imgs, masks, dict(cfg_args={"dense": True}, dtype="float64",
                                                                     seed=7))
    assert ref["metrics"]["l_dense_obj"] > 0.0 and ref["metrics"]["l_dense_box"] > 0.0
    assert any(k.startswith("grad:dense_detection_head.") for k in ref)
    for got in runs["pick"](2, "train_step", len(E2E_CASES)):
        _check_leaves(got, ref, _zero_in_exact_arithmetic, e2e_cfg().training.learning_rate)


def test_data_parallel_annotated_e2e_step_matches_one_process(runs, monkeypatch):
    """One end-to-end step on annotated instances (each disc one; the dense
    head on, augmentation, the uncertainty balancer) on 2 ranks of a global
    batch of 4, the second rank's images without an object, equals the
    one-process step. L_shape on the instances has no gradient into the
    model, but its value reaches ``log_vars``: its sum over valid objects
    and their count must be global (a per-rank mean would differ here,
    every valid object being on the first rank)."""
    imgs, masks, inst = _e2e_batch(True, instances=True)
    monkeypatch.setattr(t_cc, "label_components_stencil", lambda *a, **k: pytest.fail("an annotated step ran CC"))
    ref = _one_process("e2e", runs["dense_state"], imgs, masks, dict(cfg_args={"dense": True}, dtype="float64",
                                                                     seed=7, instances=inst))
    assert ref["metrics"]["l_shape"] > 0.0 and ref["metrics"]["l_dense_box"] > 0.0
    assert inst[2:].sum() == 0 and inst[:2].sum() > 0
    got = runs["pick"](2, "train_step", len(E2E_CASES) + 1)
    for res in got:
        _check_leaves(res, ref, _zero_in_exact_arithmetic, e2e_cfg().training.learning_rate)
    assert got[0]["param:loss_balance.log_vars"][0] != runs["dense_state"]["loss_balance.log_vars"][0]


@pytest.mark.parametrize("trainer", ["seg", "e2e"])
def test_trainers_at_world_size_1_equal_the_trainers_without_a_group(runs, trainer):
    """``train_unet_segmentation`` and ``train_end_to_end`` (two SGD steps)
    under a one-rank gloo group, every collective of the data-parallel path
    running, end where they end without one."""
    got = runs["pick"](1, "trainers")[0][trainer]
    cfg_dir = runs["dirs"][trainer, "none"]
    if trainer == "seg":
        state, _ = t_seg.train_unet_segmentation(cfg_dir, max_epochs=1, max_steps_per_epoch=2, device="cpu")
    else:
        state, _ = t_e2e.train_end_to_end(cfg_dir, max_epochs=1, max_steps_per_epoch=2, device="cpu")
    ref = _state(state.model)
    assert sorted(got) == sorted(ref) and state.step == 2
    largest = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        # A leaf whose gradient is zero in exact arithmetic holds rounding
        # noise after the steps: held to the model's largest value.
        scale = largest if (_feeds_bn if trainer == "seg" else _zero_in_exact_arithmetic)(k) else np.abs(r).max()
        assert np.abs(got[k] - r).max() <= DP_TOL * scale, k


def test_train_steps_refuse_a_spatial_mesh():
    """A spatial axis without process groups has no one to exchange rows
    with: both step factories raise, never running the unsharded step."""
    spatial2 = t_mesh.Mesh((1, 1, 2), (0, 0, 0))
    cfg = seg_cfg(**SEG_CFG)
    with pytest.raises(ValueError, match="needs the mesh's process groups"):
        t_seg.make_train_step(cfg, mesh=spatial2)
    ecfg = e2e_cfg(balance="none")
    model = t_e2e.build_mingraph_unet(ecfg, device="cpu")
    with pytest.raises(ValueError, match="needs the mesh's process groups"):
        t_e2e.make_e2e_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), ecfg, mesh=spatial2)


def test_helpers_outside_data_parallel_are_the_one_process_ops():
    x = torch.arange(6.0).reshape(2, 3)
    assert t_data.active() is None
    assert t_data.batch_mean(x) == x.mean() and t_data.global_batch(2) == 2
    assert t_data.replicated(0.5) == 0.5 and t_data.local_rows(x) is x
    with t_data.data_parallel(t_mesh.make_mesh(), 2) as shard:
        assert shard is None and t_data.active() is None


def test_reductions_refuse_the_data_parallel_context():
    """Inside data_parallel a loss is one rank's contribution: summing the
    step's metrics or gradients there is refused (before any collective)."""
    mesh = t_mesh.Mesh((1, 2, 1), (0, 0, 0), batch_group=object(), spatial_group=object(), batch_ranks=(0, 1))
    with t_data.data_parallel(mesh, 2) as shard:
        assert shard.count == 2 and t_data.batch_mean(torch.ones(2, 3)) == 0.5
        with pytest.raises(RuntimeError, match="after the data_parallel context"):
            t_data.all_reduce_metrics({"loss": torch.ones(())}, mesh)
        with pytest.raises(RuntimeError, match="after the data_parallel context"):
            t_data.all_reduce_gradients([], mesh)
    assert t_data.active() is None


def test_batch_loader_gives_each_rank_its_slice_in_epoch_order():
    class Items:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return np.full((1,), i), np.zeros((1,), np.int32)

    whole = [b[0][:, 0] for b in BatchLoader(Items(), 4, seed=3).epoch(1)]
    parts = [[b[0][:, 0] for b in BatchLoader(Items(), 4, seed=3, shard=(i, 2)).epoch(1)] for i in range(2)]
    for n, batch in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([parts[0][n], parts[1][n]]), batch)
    with pytest.raises(ValueError, match="equal full slices"):
        BatchLoader(Items(), 3, shard=(0, 2))


# ---------------------------------------------------------------------------
# Spatial-parallel training
# ---------------------------------------------------------------------------

_r21 = np.random.default_rng(21)
HALO_T = {h: (_r21.standard_normal((2, 16, 5, 3)), _r21.standard_normal((2, 4 * (4 + 2 * h), 5, 3))) for h in (1, 2)}
_r22 = np.random.default_rng(22)
CONV_T = tuple(_r22.standard_normal(s) for s in ((2, 32, 16, 3), (3, 3, 3, 5), (5,), (2, 32, 16, 5)))
_r23 = np.random.default_rng(23)
PS_T = (_r23.standard_normal((2, 16, 5, 64)).astype(np.float32),
        (_r23.standard_normal((3, 3, 16, 16)) * 0.2).astype(np.float32),
        _r23.standard_normal((2, 16, 5, 64)).astype(np.float32))
# (U-Net case, data, spatial): depth 2 on 4 shards of 8 rows and on data 2 x spatial 2; depth 3 (a
# standard encoder level and decoder block too) on 4 shards of 16 rows; depth 2 without BN on 4 shards.
UNET_TRAIN = {"depth2_sp4": ("depth2", 1, 4), "depth2_dp2_sp2": ("depth2", 2, 2), "depth3_sp4": ("depth3", 1, 4),
              "depth2_no_bn_sp4": ("depth2_no_bn", 1, 4)}
UNET_TRAIN_COT = {k: _scene(UNET_CASES[k][1][:3] + (2,), 31) for k in UNET_CASES}
# Spatial segmentation steps on 4 ranks: (data, spatial, augmentation, dtype).
SP_SEG = {"f64_sp4": (1, 4, True, "float64"), "f64_dp2_sp2": (2, 2, True, "float64"),
          "f32_dp2_sp2_jax": (2, 2, False, "float32")}


def _unet64(case):
    """The U-Net of ``UNET_CASES[case]`` in f64, seeded, train mode."""
    return UNet(torch.Generator().manual_seed(3), **UNET_CASES[case][0], dtype=torch.float64).double().train()


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """The spatial-training checks: a 4-rank group and a 2-rank group (the
    trainers under ``spatial_parallel: 2``), each with its own limit."""
    seg_state, seg_vars = _seg_start()
    seg_imgs, seg_masks = _seg_batch()
    e2e_state = _e2e_start()
    four = [("halo_transpose", {"x": x, "cot": c, "halo": h}) for h, (x, c) in sorted(HALO_T.items())]
    four += [("sharded_conv_grad", dict(zip(("x", "k", "bias", "cot"), CONV_T))),
             ("psconv_halo_train", dict(zip(("x", "k", "cot"), PS_T)))]
    for k in sorted(UNET_TRAIN):
        case, dp, sp = UNET_TRAIN[k]
        four.append(("sharded_unet_train", dict(unet_state=_state(_unet64(case)), unet_args=UNET_CASES[case][0],
                                                x=_scene(UNET_CASES[case][1], 9), cot=UNET_TRAIN_COT[case], dp=dp,
                                                sp=sp)))
    for k in sorted(SP_SEG):
        dp, sp, augment, dtype = SP_SEG[k]
        four.append(("train_step", dict(kind="seg", state=seg_state, cfg_args=SEG_CFG, imgs=seg_imgs, masks=seg_masks,
                                        dtype=dtype, seed=4, dp=dp, sp=sp, augment=augment)))
    e2e_imgs, e2e_masks = _e2e_batch(True)
    four.append(("train_step", dict(kind="e2e", state=e2e_state, cfg_args={}, imgs=e2e_imgs, masks=e2e_masks,
                                    dtype="float64", seed=7, dp=2, sp=2)))
    dense_state = _e2e_start(dense=True)
    dirs = _dummy_runs(str(tmp_path_factory.mktemp("spatial")))
    for key in ("seg", "e2e"):
        path = os.path.join(dirs[key, "gloo"], "training.yaml")
        text = open(path).read()
        assert "spatial_parallel: 1" in text
        open(path, "w").write(text.replace("spatial_parallel: 1", "spatial_parallel: 2"))
    two = [("trainers", {"seg_dir": dirs["seg", "gloo"], "e2e_dir": dirs["e2e", "gloo"]}),
           ("train_step", dict(kind="e2e", state=dense_state, cfg_args={"dense": True}, imgs=e2e_imgs,
                               masks=e2e_masks, dtype="float64", seed=7, dp=1, sp=2)),
           ("train_step", dict(kind="seg", state=seg_state, cfg_args=dict(SEG_CFG, remat=True), imgs=seg_imgs,
                               masks=seg_masks, dtype="float64", seed=4, dp=1, sp=2))]
    results = {w: run_checks(checks, w, SPATIAL_TIMEOUT[w]) for w, checks in ((4, four), (2, two))}

    def pick(world, name, index=0):
        position = [i for i, (n, _) in enumerate({4: four, 2: two}[world]) if n == name][index]
        out = [rank_results[position] for rank_results in results[world]]
        for res in out:
            if isinstance(res, dict) and "error" in res:
                pytest.fail(f"{name} failed on a rank:\n{res['error']}")
        return out

    return dict(pick=pick, seg_state=seg_state, seg_vars=seg_vars, seg_batch=(seg_imgs, seg_masks),
                e2e_state=e2e_state, dense_state=dense_state, e2e_batch=(e2e_imgs, e2e_masks), dirs=dirs)


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_rows_backward_is_the_transpose_of_the_exchange(spatial_runs, halo):
    """Over 4 ranks, ⟨A x, c⟩ = ⟨x, Aᵀ c⟩ for the exchange A (each shard
    extended by its neighbours' rows, zeros at the borders) and the
    backward Aᵀ, summed over the ranks."""
    got = spatial_runs["pick"](4, "halo_transpose", halo - 1)
    fwd, bwd = sum(g["fwd"] for g in got), sum(g["bwd"] for g in got)
    assert abs(fwd - bwd) <= 1e-12 * max(abs(fwd), 1.0), (fwd, bwd)


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_rows_matches_jax_vjp_of_halo_exchange_rows(spatial_runs, halo):
    """The extended blocks and the gradient against ``jax.vjp`` of JAX's
    ``halo_exchange_rows`` (``ppermute``) in ``shard_map`` on a spatial-4
    virtual mesh: JAX's transpose is the reverse ``ppermute``."""
    x, cot = HALO_T[halo]
    with jax.enable_x64(True):
        spec = P(None, "spatial", None, None)
        fn = shard_map(lambda xl: jax_halo.halo_exchange_rows(xl, halo), mesh=jax_mesh.make_mesh(1, 4),
                       in_specs=spec, out_specs=spec)
        block, vjp = jax.vjp(fn, jnp.asarray(x))
        (dx,) = vjp(jnp.asarray(cot))
        block, dx = np.asarray(block), np.asarray(dx)
    got = spatial_runs["pick"](4, "halo_transpose", halo - 1)
    np.testing.assert_array_equal(np.concatenate([g["block"] for g in got], axis=1), block)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got], axis=1), dx, rtol=1e-12, atol=1e-12)


def test_sharded_conv2d_same_gradients_match_unsharded(spatial_runs):
    """``sharded_conv2d_same`` + bias on 4 ranks under autograd: output, dx
    (stitched), dK and the bias gradient (summed over the ranks) against
    the unsharded conv's, in f64."""
    from mingraph_unet_tpu_torch.ops.conv import conv2d_nhwc

    x, k, bias, cot = (torch.from_numpy(a.copy()).requires_grad_() for a in CONV_T)
    y = conv2d_nhwc(x, k, bias, padding=1)
    (y * cot).sum().backward()
    got = spatial_runs["pick"](4, "sharded_conv_grad")
    for key, ref, parts in (("y", y.detach(), "cat"), ("dx", x.grad, "cat"), ("dk", k.grad, "sum"),
                            ("db", bias.grad, "sum")):
        g = np.concatenate([r[key] for r in got], axis=1) if parts == "cat" else sum(r[key] for r in got)
        assert _rel_err(g, ref.numpy()) <= F64_TOL, key


def _psconv_whole(x, k, cot):
    """``psconv_train`` (K4's Function, its plain forward and dgrad on the
    CPU) on the whole tensor: y, dx, dK for the cotangent."""
    xx, kk = torch.from_numpy(x).requires_grad_(), torch.from_numpy(k).requires_grad_()
    y = t_psconv.psconv_train(xx, kk)
    (y * torch.from_numpy(cot)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xx.grad.numpy(), "dk": kk.grad.numpy()}


def _check_psconv_shards(parts, ref):
    """Stitched outputs and dx, dK summed over the shards, against the
    whole tensor's, f32 at 1e-5 of max (another summation order at the
    shard edges and in dK)."""
    assert _rel_err(np.concatenate([p["y"] for p in parts], axis=1), ref["y"]) <= 1e-5
    assert _rel_err(np.concatenate([p["dx"] for p in parts], axis=1), ref["dx"]) <= 1e-5
    assert _rel_err(sum(p["dk"] for p in parts), ref["dk"]) <= 1e-5


@pytest.mark.parametrize("cuts", [[0, 4, 8, 12, 16], [0, 1, 5, 11, 16]])
def test_psconv_train_halo_stitches_in_one_process(cuts):
    """K4 on shards (``psconv_train_halo``, the rows exchanged by hand: x's
    in the forward, the cotangent's in the backward) against
    ``psconv_train`` on the whole tensor, equal and uneven shards; and the
    plain form under ordinary autograd with the halo rows' gradients
    handed back by hand."""
    x, k, cot = PS_T
    ref = _psconv_whole(x, k, cot)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cot)
    rows = lambda t, a, e: (t[:, a - 1 : a] if a > 0 else None, t[:, e : e + 1] if e < t.shape[1] else None)  # noqa: E731
    parts = []
    for a, e in zip(cuts[:-1], cuts[1:]):
        xs, kk = xt[:, a:e].clone().requires_grad_(), torch.from_numpy(k).requires_grad_()
        y = t_psconv.psconv_train_halo(xs, *rows(xt, a, e), kk, lambda g, a=a, e=e: rows(ct, a, e))
        (y * ct[:, a:e]).sum().backward()
        parts.append({"y": y.detach().numpy(), "dx": xs.grad.numpy(), "dk": kk.grad.numpy()})
    _check_psconv_shards(parts, ref)

    xx, kk = xt.clone().requires_grad_(), torch.from_numpy(k).requires_grad_()
    y = torch.cat([t_psconv.psconv_halo_plain(xx[:, a:e], *rows(xx, a, e), kk) for a, e in zip(cuts[:-1], cuts[1:])],
                  dim=1)
    (y * ct).sum().backward()
    assert _rel_err(y.detach().numpy(), ref["y"]) <= 1e-5
    assert _rel_err(xx.grad.numpy(), ref["dx"]) <= 1e-5 and _rel_err(kk.grad.numpy(), ref["dk"]) <= 1e-5


@pytest.mark.parametrize("form", ["function", "plain"])
def test_psconv_train_halo_over_4_ranks(spatial_runs, form):
    """K4 on 4 shards over gloo: ``psconv_train_halo`` (its backward
    exchanges the cotangent's rows) and the plain form over the
    differentiable exchange, stitched against ``psconv_train``."""
    x, k, cot = PS_T
    _check_psconv_shards([g[form] for g in spatial_runs["pick"](4, "psconv_halo_train")], _psconv_whole(x, k, cot))


@pytest.mark.parametrize("case", sorted(UNET_TRAIN))
def test_train_mode_sharded_unet_matches_unsharded(spatial_runs, case):
    """The train-mode U-Net in f64 through ``spatial_sharded_unet`` (spatial
    4, or data 2 × spatial 2, BN over batch × spatial) for the loss
    ⟨logits, cot⟩: logits, the input gradient (each spatial rank's rows),
    every parameter gradient and the BN running statistics against the
    one-process train U-Net, at F64_TOL of each leaf's largest value; a
    bias that feeds BN (zero gradient in exact arithmetic) against the
    largest gradient."""
    unet_case, dp, sp = UNET_TRAIN[case]
    model = _unet64(unet_case)
    x = torch.from_numpy(_scene(UNET_CASES[unet_case][1], 9)).requires_grad_()
    logits = model(x)["logits"]
    (logits * torch.from_numpy(UNET_TRAIN_COT[unet_case])).sum().backward()
    ref = {f"grad:{n}": p.grad.numpy() for n, p in model.named_parameters()}
    ref.update({f"stat:{n}": b.numpy() for n, b in model.named_buffers()})
    top = max(np.abs(v).max() for k, v in ref.items() if k.startswith("grad:"))
    got = spatial_runs["pick"](4, "sharded_unet_train", sorted(UNET_TRAIN).index(case))
    nb = x.shape[0] // dp
    for r, g in enumerate(got):
        b = r // sp
        assert _rel_err(g["logits"], logits.detach().numpy()[b * nb : (b + 1) * nb]) <= F64_TOL
        for k, v in ref.items():
            scale = top if _feeds_bn(k.split(":", 1)[1]) and k.startswith("grad:") else np.abs(v).max()
            assert np.abs(g[k] - v).max() <= F64_TOL * scale, k
    for b in range(dp):
        dx = sum(got[b * sp + s]["dx"] for s in range(sp))
        assert _rel_err(dx, x.grad.numpy()[b * nb : (b + 1) * nb]) <= F64_TOL


@pytest.mark.parametrize("case", [c for c in sorted(SP_SEG) if c.startswith("f64")])
def test_spatial_segmentation_step_matches_one_process(spatial_runs, case):
    """One segmentation step on 4 ranks with a spatial axis (spatial 4, or
    data 2 × spatial 2), augmentation on, f64, against the one-process
    step: CE + Dice, every gradient, the SGD update, the BN statistics."""
    dp, sp, augment, dtype = SP_SEG[case]
    imgs, masks = spatial_runs["seg_batch"]
    ref = _one_process("seg", spatial_runs["seg_state"], imgs, masks,
                       dict(cfg_args=SEG_CFG, dtype=dtype, seed=4, augment=augment))
    for got in spatial_runs["pick"](4, "train_step", sorted(SP_SEG).index(case)):
        _check_leaves(got, ref, _feeds_bn, seg_cfg(**SEG_CFG).training.learning_rate)


def test_spatial_segmentation_step_matches_jax(spatial_runs):
    """The f32 data 2 × spatial 2 step (no augmentation) against the JAX
    trainer's step on a ``make_mesh(2, 2)`` virtual mesh with the batch
    sharded over H as well (``shard_batch(..., spatial=True)``), at
    tests/test_torch_train.py's tolerances, each widened by the distance
    of JAX's step from the f64 one-process step. That distance matters at
    one leaf: decoder block0's bn1 bias, whose gradient is a sum of
    cancelling terms, is 3.4e-3 of its update away from f64 in JAX's f32
    step on this mesh (and unsharded), 1.8e-6 in its data-4 step and
    5e-7 in the port's f32 steps."""
    imgs, masks = spatial_runs["seg_batch"]
    exact = _one_process("seg", spatial_runs["seg_state"], imgs, masks,
                         dict(cfg_args=SEG_CFG, dtype="float64", seed=4, augment=False))
    _check_against_jax_step(spatial_runs, jax_mesh.make_mesh(2, 2), imgs, masks, spatial=True,
                            got=spatial_runs["pick"](4, "train_step", sorted(SP_SEG).index("f32_dp2_sp2_jax")),
                            exact=exact)


def test_spatial_e2e_step_matches_one_process(spatial_runs):
    """One end-to-end step on data 2 × spatial 2 (augmentation, dropout,
    the uncertainty balancer, detection trained; the second batch rank's
    images hold no object) in f64 against the one-process step."""
    imgs, masks = spatial_runs["e2e_batch"]
    ref = _one_process("e2e", spatial_runs["e2e_state"], imgs, masks, dict(cfg_args={}, dtype="float64", seed=7))
    assert ref["metrics"]["l_shape"] > 0.0 and "bal_s_l_shape" in ref["metrics"]
    for got in spatial_runs["pick"](4, "train_step", len(SP_SEG)):
        _check_leaves(got, ref, _zero_in_exact_arithmetic, e2e_cfg().training.learning_rate)


def test_spatial_e2e_step_with_the_dense_head_matches_one_process(spatial_runs):
    """One end-to-end step with the dense detection head on spatial 2 (the
    heads and every loss replicated over the group after the gather, the
    dense loss counted once through ``spatial_share``) in f64 against the
    one-process step."""
    imgs, masks = spatial_runs["e2e_batch"]
    ref = _one_process("e2e", spatial_runs["dense_state"], imgs, masks,
                       dict(cfg_args={"dense": True}, dtype="float64", seed=7))
    assert ref["metrics"]["l_dense_obj"] > 0.0 and ref["metrics"]["l_dense_box"] > 0.0
    for got in spatial_runs["pick"](2, "train_step", 0):
        _check_leaves(got, ref, _zero_in_exact_arithmetic, e2e_cfg().training.learning_rate)


def test_spatial_remat_segmentation_step_matches_one_process(spatial_runs):
    """The segmentation step with the rematerialized U-Net on spatial 2, in
    f64, against the plain one-process step: every ConvBlock's recompute
    in the backward restores the batch × spatial BN groups of its forward
    (local statistics there would give other gradients) and sends its halo
    exchanges again, in the same order on both ranks; the BN running
    statistics are updated once."""
    imgs, masks = spatial_runs["seg_batch"]
    ref = _one_process("seg", spatial_runs["seg_state"], imgs, masks,
                       dict(cfg_args=SEG_CFG, dtype="float64", seed=4))
    for got in spatial_runs["pick"](2, "train_step", 1):
        _check_leaves(got, ref, _feeds_bn, seg_cfg(**SEG_CFG).training.learning_rate)


@pytest.mark.parametrize("trainer", ["seg", "e2e"])
def test_trainers_with_spatial_parallel_2_equal_the_trainers_without_a_group(spatial_runs, trainer):
    """``train_unet_segmentation`` and ``train_end_to_end`` (two SGD steps)
    with ``spatial_parallel: 2`` under a 2-rank gloo group end where they
    end without a group."""
    got = spatial_runs["pick"](2, "trainers")
    cfg_dir = spatial_runs["dirs"][trainer, "none"]
    if trainer == "seg":
        state, _ = t_seg.train_unet_segmentation(cfg_dir, max_epochs=1, max_steps_per_epoch=2, device="cpu")
    else:
        state, _ = t_e2e.train_end_to_end(cfg_dir, max_epochs=1, max_steps_per_epoch=2, device="cpu")
    ref = _state(state.model)
    largest = max(np.abs(r).max() for r in ref.values())
    for rank in got:
        res = rank[trainer]
        assert sorted(res) == sorted(ref) and state.step == 2
        for k, r in ref.items():
            scale = largest if (_feeds_bn if trainer == "seg" else _zero_in_exact_arithmetic)(k) else np.abs(r).max()
            assert np.abs(res[k] - r).max() <= DP_TOL * scale, k
