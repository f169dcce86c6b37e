"""The port's own spans (``utils/profiling.py::span``) on the CPU: the
shared no-op object while no profiler records; the span tree of a tiny
MinGraph-UNet eval forward and of a tiny U-Net train step under
``torch.profiler``; the sync markers, and the state they leave behind once
the profiler has stopped."""

import json
import os
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.train import common as t_common
from mingraph_unet_tpu_torch.train import segmentation as t_seg
from mingraph_unet_tpu_torch.utils import profiling

SYNC_TEXT = "called a synchronizing CUDA operation"  # torch's warning under set_sync_debug_mode("warn")


def _spans(prof, tmp_path):
    """The ``mgu.`` ranges of a finished profile: (name, start, end), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
           if e.get("ph") == "X" and str(e.get("name")).startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _outermost(spans, name):
    mine = [s for s in spans if s[0] == name]
    return [s for s in mine if not any(o is not s and _inside(s, o) for o in mine)]


def _eval_forward():
    torch.manual_seed(0)
    model = MinGraphUNet(device="cpu", init_features=4, depth=2, detection_pre_pool=2, patch_size=16)
    x = torch.randn(2, 32, 32, 3)
    return lambda: model(x)


def _train_step():
    cfg = PipelineConfig()
    cfg.model.unet.init_features = 4
    cfg.model.unet.depth = 2
    model = t_seg.build_unet(cfg, device="cpu")
    opt, sched = t_common.make_optimizer(model.parameters(), cfg.training, steps_per_epoch=2)
    state = t_common.TrainState(model, opt, sched)
    step = t_seg.make_train_step(cfg, augment=True)
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (2, 16, 16)).astype(np.uint8))
    gen = torch.Generator().manual_seed(1)
    return lambda: step(state, imgs, masks, gen)


@pytest.mark.parametrize("args", [None, (torch.zeros(2, 3), None, 4)])
@pytest.mark.parametrize("name", ["unet", "unet.enc0", "weights", "kernel.psel_conv3x3"])
def test_span_without_a_profiler_is_the_shared_no_op(name, args):
    filters, show = list(warnings.filters), warnings.showwarning
    s = profiling.span(name, args)
    assert s is profiling.NO_SPAN
    with s as entered:
        assert entered is None
    assert warnings.filters == filters and warnings.showwarning is show


@pytest.mark.parametrize("record_shapes", [False, True])
def test_a_span_with_inputs_holds_their_dims_and_dtypes(record_shapes, tmp_path):
    x = torch.zeros(2, 3, dtype=torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        with profiling.span("kernel.probe", (x, None, torch.zeros(5), 7)):
            x.sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    event = next(e for e in json.loads(path.read_text())["traceEvents"] if e.get("name") == "mgu.kernel.probe")
    if record_shapes:
        assert event["args"]["Input Dims"] == [[2, 3], [], [5], []]
        assert event["args"]["Input type"][:3] == ["c10::BFloat16", "", "float"]
    else:
        assert "Input Dims" not in event["args"]


# A tiny forward's weight sites, on the CPU (the kernel wrappers' own weight
# spans run on the card only): each s2d encoder level folds conv1 into its
# windowed form and folds conv2; the bottleneck (depth 2: the standard
# path, f32: the fused block) takes both convs' scale and shift; each s2d decoder level lays out its upsample,
# folds conv1 into the fused form and folds conv2; the head lays out the
# 1x1 conv. Levels 0 and 1 run in s2d at 32x32, depth 2.
EVAL_WEIGHT_SITES = 2 + 2 + 2 + 3 + 3 + 1


@pytest.mark.parametrize("path", ["eval_forward", "train_step"])
def test_span_tree_of_a_traced_run(path, tmp_path):
    run = _eval_forward() if path == "eval_forward" else _train_step()
    run()  # the first call allocates; the traced one is a steady call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof, tmp_path)
    names = [s[0] for s in spans]
    unet = _outermost(spans, "mgu.unet")
    assert len(unet) == 1
    levels = ["mgu.unet.enc0", "mgu.unet.enc1", "mgu.unet.bottleneck", "mgu.unet.dec1", "mgu.unet.dec0",
              "mgu.unet.head"]
    for level in levels:
        assert names.count(level) == 1, level
        assert _inside(next(s for s in spans if s[0] == level), unet[0]), level
    starts = [next(s[1] for s in spans if s[0] == level) for level in levels]
    assert starts == sorted(starts)
    if path == "eval_forward":
        for name in ("mgu.aux", "mgu.graph.patch_gat", "mgu.graph.mincut", "mgu.graph.region_gat", "mgu.detection"):
            assert names.count(name) == 1, name
            assert not _inside(next(s for s in spans if s[0] == name), unet[0]), name
        assert names.count("mgu.graph.regions") == 2
        assert set(names) == set(levels) | {"mgu.unet", "mgu.weights", "mgu.aux", "mgu.graph.patch_gat",
                                            "mgu.graph.mincut", "mgu.graph.regions", "mgu.graph.region_gat",
                                            "mgu.detection", "mgu.sync.watch"}
        assert len(_outermost(spans, "mgu.weights")) == EVAL_WEIGHT_SITES
        assert not any(n.startswith("mgu.train.") for n in names)
    else:
        train = [s for s in spans if s[0].startswith("mgu.train.")]
        assert [s[0] for s in train] == ["mgu.train.augment", "mgu.train.forward", "mgu.train.loss",
                                        "mgu.train.backward", "mgu.train.optimizer"]
        assert all(a[2] <= b[1] for a, b in zip(train, train[1:]))  # one after another
        assert _inside(unet[0], train[1])
        assert "mgu.weights" in names
    assert not any(n.startswith(profiling.SYNC_PREFIX) for n in names)  # nothing synchronizes on the CPU


# A stand-in for a call of this package that synchronizes: code whose frame
# lies in the package's folder, raising torch's sync warning from one line
# as many times as asked, then one other warning.
_PROBE_FILE = os.path.join(os.path.dirname(profiling.__file__), "sync_probe.py")
_PROBE = compile("import warnings\n"
                 "def probe(text, other, times):\n"
                 "    for _ in range(times):\n"
                 "        warnings.warn(text)\n"
                 "    warnings.warn(other)\n", _PROBE_FILE, "exec")


def _probe():
    namespace = {}
    exec(_PROBE, namespace)
    return namespace["probe"]


def _sync_mode():
    return torch.cuda.get_sync_debug_mode() if torch.cuda.is_initialized() else None


@pytest.mark.parametrize("ended_by", ["next_span", "next_sync_warning"])
def test_sync_markers_and_the_state_after_the_session(ended_by, tmp_path):
    probe = _probe()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        filters, show, mode = list(warnings.filters), warnings.showwarning, _sync_mode()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("probe"):
                assert warnings.showwarning is not show
                probe(SYNC_TEXT, "another warning", 2)
            warnings.warn(SYNC_TEXT)  # from outside the package: not marked
        if ended_by == "next_span":
            assert profiling.span("unet") is profiling.NO_SPAN
        else:
            probe(SYNC_TEXT, "after the session", 1)
        assert warnings.filters == filters
        assert warnings.showwarning is show
        assert _sync_mode() == mode
        assert profiling._sync_watch is None
    shown = [str(w.message) for w in seen]
    assert SYNC_TEXT not in shown
    assert shown == (["another warning"] if ended_by == "next_span" else ["another warning", "after the session"])
    spans = _spans(prof, tmp_path)
    markers = [s for s in spans if s[0].startswith(profiling.SYNC_PREFIX)]
    assert [s[0] for s in markers] == ["mgu.sync@utils/sync_probe.py:4"] * 2
    assert all(_inside(m, next(s for s in spans if s[0] == "mgu.probe")) for m in markers)


@pytest.mark.parametrize("event, sync, device_call", [
    ({"cat": "cuda_runtime", "name": "cudaStreamSynchronize"}, True, True),
    ({"cat": "cuda_runtime", "name": "cudaDeviceSynchronize"}, True, True),
    ({"cat": "cuda_runtime", "name": "cudaMemcpy"}, True, True),
    ({"cat": "cuda_runtime", "name": "cudaMemcpyAsync"}, False, True),
    ({"cat": "cuda_runtime", "name": "cudaLaunchKernel"}, False, True),
    ({"cat": "cuda_driver", "name": "cuLaunchKernelEx"}, False, True),
    ({"cat": "cuda_runtime", "name": "cudaEventRecord"}, False, False),
    ({"cat": "cpu_op", "name": "aten::copy_"}, False, False),
])
def test_runtime_call_kinds(event, sync, device_call):
    assert profiling.is_sync_runtime_call(event) is sync
    assert profiling.is_device_call(event) is device_call
