"""The plain reference against the port on the CPU at a tiny size, and the
seeded inputs and weights."""

import numpy as np
import pytest
import torch

from port_bench import inputs, program
from port_bench.core import read_json, PACKAGE_DIR
from port_bench.reference import model as ref
from port_bench.reference.numerics import Precision
from port_bench.tests.tiny import TINY_ARGS, TINY_UNET
from port_bench.weights import draw_weights


def _mgu_config(dtype="float32"):
    c = read_json(PACKAGE_DIR / "configs" / "mgu_bf16.json")
    c["args"].update(TINY_ARGS)
    c["precision"] = dtype
    return c


def test_weights_are_drawn_from_the_seed():
    spec = program.spec(_mgu_config())
    a, b, c = (draw_weights(spec, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unet.encoder.block0.conv1.kernel"], c["unet.encoder.block0.conv1.kernel"])
    var = torch.cat([v for k, v in a.items() if k.endswith(".var")])
    assert 0.5 <= float(var.min()) and float(var.max()) <= 1.5


def test_inputs_are_drawn_from_the_seed():
    x1, m1 = inputs.tiles(2**31 + 11, 0, 2, 64, 48)
    x2, m2 = inputs.tiles(2**31 + 11, 0, 2, 64, 48)
    x3, _ = inputs.tiles(2**31 + 11, 1, 2, 64, 48)
    assert x1.shape == (2, 64, 48, 3) and x1.dtype == np.uint8 and m1.shape == (2, 64, 48)
    assert np.array_equal(x1, x2) and np.array_equal(m1, m2) and not np.array_equal(x1, x3)
    assert 0 < m1.mean() < 0.5


def test_pipeline_matches_the_port_in_f32():
    from mingraph_unet_tpu_torch.ops.image import normalize

    cfg = _mgu_config()
    w = program.make_weights(cfg, 2**31 + 21, "cpu")
    model = program.build(cfg, w, "cpu", train=False)
    x = torch.from_numpy(inputs.tiles(2**31 + 21, 0, 2, 64, 64)[0])
    mean, std = program.normalization(cfg)
    with torch.no_grad():
        got = model(normalize(x.float() / 255.0, mean, std))
        want = ref.pipeline(w, x, cfg["args"], mean, std, Precision("f32"))
    for k, v in want.items():
        err = (got[k].float() - v).abs().max() / v.abs().max()
        assert err < 1e-4, k


def test_unet_matches_the_port_in_f32():
    cfg = read_json(PACKAGE_DIR / "configs" / "unet_f32.json")
    cfg["pipeline"]["model"]["unet"].update(TINY_UNET)
    w = program.make_weights(cfg, 2**31 + 22, "cpu")
    model = program.build(cfg, w, "cpu", train=False)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(x)["logits"]
        want = ref.unet(w, x, TINY_UNET["depth"], Precision("f32"))["logits"]
    assert (got - want).abs().max() / want.abs().max() < 1e-5


def test_lower_precisions_round_what_the_products_see():
    x = torch.tensor([1.0 + 2**-12, 3.0, 1000.0])
    assert torch.equal(Precision("tf32").q(x)[1:], x[1:]) and Precision("tf32").q(x)[0] == 1.0
    assert Precision("f32").q(x) is x
    y = Precision("fp8").q(x)
    assert y[2] == 1000.0 and (y - x).abs().max() > 1e-3
    g = torch.ones(3, requires_grad=True)
    Precision("fp8").q(g * 1.01).sum().backward()
    assert torch.allclose(g.grad, torch.full((3,), 1.01))


@pytest.mark.parametrize("mode", ["tf32", "fp8"])
def test_a_lower_precision_moves_the_reference(mode):
    cfg = _mgu_config()
    w = program.make_weights(cfg, 2**31 + 23, "cpu")
    x = torch.from_numpy(inputs.tiles(2**31 + 23, 0, 2, 64, 64)[0])
    mean, std = program.normalization(cfg)
    with torch.no_grad():
        base = ref.pipeline(w, x, cfg["args"], mean, std, Precision("f32"))["logits"]
        low = ref.pipeline(w, x, cfg["args"], mean, std, Precision(mode))["logits"]
    assert (low - base).abs().max() / base.abs().max() > 1e-4
