"""The FLOP and roofline arithmetic against shapes worked by hand."""

import pytest
import torch

from port_bench import core
from port_bench.trace import KernelCall, tensor_bytes


def _roof(name):
    return core.roofline_modules()[name]


def test_k1_at_level0_is_38_7_gflop_and_268_mb():
    # K1 at L0 of the 512² b8 forward: x (8, 256, 256, 4·32) bf16, k (3, 3, 32, 32).
    x = torch.empty((8, 256, 256, 128), dtype=torch.bfloat16)
    k = torch.empty((3, 3, 32, 32))
    flops = _roof("psel").flops(x, k, torch.empty(32))
    assert flops == pytest.approx(2 * 8 * 512 * 512 * 9 * 32 * 32)
    assert flops == pytest.approx(38.65e9, rel=1e-3)
    activations = tensor_bytes([x, x])  # in and out, bf16
    assert activations == pytest.approx(268.4e6, rel=1e-3)


def test_k2_counts_the_skip_taps_and_the_live_taps_of_x_prev():
    # L0: skip (8, 256, 256, 4·32), x_prev (…, 64), C_out 32: 17·c² a pixel.
    xs = torch.empty((8, 256, 256, 128))
    xp = torch.empty((8, 256, 256, 64))
    ks = torch.empty((3, 3, 32, 32))
    assert _roof("dec1").flops(xs, xp, ks) == pytest.approx(2 * 8 * 512 * 512 * 17 * 32 * 32)


def test_k4_dgrad_counts_like_the_forward():
    g = torch.empty((16, 128, 128, 256))
    k = torch.empty((3, 3, 64, 64))
    assert _roof("k4_dgrad").flops(g, k) == _roof("k4_fwd").flops(g, k) == 2 * 16 * 256 * 256 * 9 * 64 * 64


def test_bandwidth_kernels_count_no_operations():
    for name in ("pool", "d2s", "histeq"):
        assert _roof(name).flops(torch.empty(1)) == 0.0


def test_bound_is_the_larger_of_bytes_and_operations():
    by_bytes = KernelCall("psel", flops=38.65e9, bytes=268.4e6, dtype="bfloat16")
    assert by_bytes.bound_s == pytest.approx(268.4e6 / 3.35e12)
    by_ops = KernelCall("psel", flops=38.65e9, bytes=268.4e6, dtype="float32")
    assert by_ops.bound_s == pytest.approx(38.65e9 / (989e12 / 3))


def test_unet_forward_is_96_gflop_an_image_at_512():
    flops = core.unet_forward_flops(512, 512, 3, 2, 32, 4)
    # Encoder: level 0 3→32, 32→32; four levels of 2.42 + 4.83 GFLOP; decoder: four levels of 15.6.
    enc = core.conv_flops(512, 512, 3, 3, 32) + core.conv_flops(512, 512, 3, 32, 32) + 4 * (2.416e9 + 4.832e9)
    assert flops == pytest.approx(96.6e9, rel=5e-3)
    assert enc == pytest.approx(34.3e9, rel=5e-3)


def test_pipeline_adds_little_to_the_unet():
    a = {"patch_size": 16, "init_features": 32, "gat_num_heads": 4, "unet_patch_feature_dim": 16,
         "gat_output_dim": 64, "num_segments": 2, "fc_hidden_dim": 256, "depth": 4, "num_classes": 2,
         "detection_pre_pool": 32}
    unet = core.unet_forward_flops(512, 512, 3, 2, 32, 4)
    extra = core.pipeline_forward_flops(512, 512, a) - unet
    # The Sobel filters (9.4 MFLOP), the detection convs on the 32 × 32 patch grid (106 MFLOP), the
    # graph branch on 1024 patches (~20 MFLOP): 0.14% of the U-Net.
    assert extra == pytest.approx(9.437e6 + 84.93e6 + 21.23e6, rel=0.25)


def test_train_step_is_three_forwards():
    from port_bench.drivers import train

    cfg = core.read_json(core.PACKAGE_DIR / "configs" / "unet_f32.json")
    t = {"batch": 16, "height": 512, "width": 512, "checked": 3}
    d = train.Driver(cfg, t, 1, "cpu")
    assert d.flops_per_unit == pytest.approx(3 * 16 * core.unet_forward_flops(512, 512, 3, 2, 32, 4))


def _mgu(**changes):
    c = core.read_json(core.PACKAGE_DIR / "configs" / "mgu_bf16.json")
    c["args"].update(changes)
    return c


def test_forward_flops_of_the_configurations_as_run_are_pinned():
    # The serving cells' figures at 512², to the last digit: counting the head where it runs moves neither.
    assert core.forward_flops(_mgu(), 512, 512) == 96722157824.0
    unet = core.read_json(core.PACKAGE_DIR / "configs" / "unet_f32.json")
    assert core.forward_flops(unet, 512, 512) == 96586432512.0


def test_the_full_resolution_head_is_counted_on_the_full_map():
    # detection_pre_pool None: the head's convs on the fused 512² map, c = 32 + 64 = 96 → 48 → 24, where
    # the pooled serving path runs them on the 32 × 32 patch grid.
    head = 2 * 9 * (96 * 48 + 48 * 24)
    full, pooled = core.forward_flops(_mgu(detection_pre_pool=None), 512, 512), core.forward_flops(_mgu(), 512, 512)
    assert full - pooled == pytest.approx(head * (512 * 512 - 32 * 32), rel=1e-12)
    # detection_pre_pool 64: the head's own average pool (windows of 8) first, its convs on 64 × 64.
    assert core.detection_head_hw(512, 512, _mgu(detection_pre_pool=64)["args"]) == (64, 64)
    assert core.forward_flops(_mgu(detection_pre_pool=64), 512, 512) - pooled == pytest.approx(
        head * (64 * 64 - 32 * 32), rel=1e-12)
    assert core.detection_head_hw(512, 512, _mgu()["args"]) == (32, 32)
    assert core.detection_head_hw(512, 512, _mgu(detection_pre_pool=None)["args"]) == (512, 512)
