"""``utils/profiling.py`` of the port, on the CPU: ``attribute_stages``
against JAX's on the same rows, ``parse_device_trace`` on two committed
Chrome traces, ``trace_if`` writing a trace it reads back, and the step
timer.

The traces: ``tests/fixtures/torch_trace_h100.json`` is ``trace_if``'s
own export on an H100 (the device and launch events of two steps of K1,
``psel_conv3x3``, launched through ``ctypes`` with no aten op around it,
and one cuDNN conv, ``ops/conv.py::conv2d_nhwc``, with the wrappers'
copies); ``tests/fixtures/torch_trace_synthetic.json`` is written by hand
in the same event format to reach what that one lacks: a device copy, a
Python frame closed before the launch and a kernel whose launching thread
recorded no Python frames."""

import gzip
import json
import os
import shutil
import time
from pathlib import Path

import pytest
import torch

from mingraph_unet_tpu.utils import profiling as j_prof
from mingraph_unet_tpu_torch.utils import profiling as t_prof

FIXTURES = Path(__file__).resolve().parent / "fixtures"
FIXTURE = FIXTURES / "torch_trace_synthetic.json"

ROWS = [
    {"op": "psel", "us_per_step": 118.5, "source": "mingraph_unet_tpu_torch/ops/kernels/psconv.py(251): psel_conv3x3"},
    {"op": "conv", "us_per_step": 30.25, "source": "mingraph_unet_tpu_torch/ops/conv.py(31): conv2d_nhwc"},
    {"op": "gat", "us_per_step": 12.0, "source": "mingraph_unet_tpu_torch/models/gat.py(90): forward"},
    {"op": "copy", "us_per_step": 2.0, "source": ""},
    {"op": "histeq", "us_per_step": 7.4, "source": "mingraph_unet_tpu_torch/ops/kernels/histeq.py(52): equalize"},
]

RULES = {
    "bench": [("unet", ("models/unet.py", "ops/kernels/psconv.py", "ops/kernels/pool.py", "ops/s2d.py")),
              ("aux_filters", ("ops/filters.py", "ops/kernels/histeq.py")),
              ("graph_fusion", ("models/gat.py", "models/mincut.py"))],
    "overlapping": [("kernels", ("ops/kernels/",)), ("psel_only", ("psconv.py",)), ("convs", ("conv",))],
    "none": [],
}


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("default", ["other", "rest"])
def test_attribute_stages_matches_jax(rules, default):
    got = t_prof.attribute_stages(ROWS, RULES[rules], default)
    assert got == j_prof.attribute_stages(ROWS, RULES[rules], default)
    # Each stage is rounded to the µs: the sums agree within half a µs a stage.
    assert abs(sum(got.values()) - sum(r["us_per_step"] for r in ROWS) / 1e3) <= 5e-4 * len(got) + 1e-12


def _copy_fixture(tmp_path, gz: bool, fixture=FIXTURE):
    run = tmp_path / "profile" / "run"
    run.mkdir(parents=True)
    if gz:
        with open(fixture, "rb") as f, gzip.open(run / "trace.json.gz", "wb") as g:
            shutil.copyfileobj(f, g)
    else:
        shutil.copy(fixture, run / "trace.json")


def test_parse_device_trace_on_the_card_trace(tmp_path):
    """K1's kernel comes from its wrapper's launch frame; the cuDNN conv
    and a copy from ``conv2d_nhwc``; the weight packing's copies from
    their own frames; the test's own cast from the built-in it called."""
    _copy_fixture(tmp_path, gz=True, fixture=FIXTURES / "torch_trace_h100.json")
    rows = t_prof.parse_device_trace(str(tmp_path), steps=2)
    assert len(rows) == 6 and all(r["launches_per_step"] == 1.0 for r in rows)
    psel = [r for r in rows if "psel_wgmma_kernel" in r["op"]]
    assert len(psel) == 1 and psel[0]["source"] == "mingraph_unet_tpu_torch/ops/kernels/psconv.py(173): _psel_launch"
    assert psel[0]["us_per_step"] == pytest.approx(6.239) and "block [384, 1, 1]" in psel[0]["long_name"]
    conv = [r for r in rows if r["source"] == "mingraph_unet_tpu_torch/ops/conv.py(21): conv2d_nhwc"]
    assert len(conv) == 2 and any("xmma_fprop" in r["op"] for r in conv)
    packing = {r["source"].rsplit(": ", 1)[-1] for r in rows if "ops/kernels/psconv.py" in r["source"]}
    assert packing == {"_psel_launch", "wgmma_b_layout", "_kernel_weights"}
    stages = t_prof.attribute_stages(rows, [("kernels", ("ops/kernels/",)), ("convs", ("ops/conv.py",))])
    assert stages == {"kernels": 0.010, "convs": 0.007, "other": 0.001}


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json_gz"])
def test_parse_device_trace_attributes_ctypes_launches(tmp_path, gz):
    _copy_fixture(tmp_path, gz)
    rows = t_prof.parse_device_trace(str(tmp_path), steps=2)
    by_op = {(r["op"], r["source"]): r for r in rows}
    assert len(rows) == len(by_op) == 4
    psel = by_op[("psel_conv3x3_wgmma_kernel<128, 8>",
                  "mingraph_unet_tpu_torch/ops/kernels/psconv.py(251): psel_conv3x3")]
    assert psel["us_per_step"] == pytest.approx(40.5) and psel["launches_per_step"] == 1.0
    assert psel["category"] == "kernel" and "grid [64, 8, 1] block [384, 1, 1]" in psel["long_name"]
    conv = by_op[("sm90_xmma_fprop_implicit_gemm_bf16", "mingraph_unet_tpu_torch/ops/conv.py(31): conv2d_nhwc")]
    assert conv["us_per_step"] == pytest.approx(30.0)
    copy = by_op[("Memcpy DtoD (Device -> Device)", "bench.py(12): <module>")]
    assert copy["category"] == "gpu_memcpy" and copy["us_per_step"] == pytest.approx(2.0)
    unknown = by_op[("elementwise_kernel", "")]
    assert unknown["launches_per_step"] == 1.0 and unknown["us_per_step"] == pytest.approx(5.0)
    assert [r["us_per_step"] for r in rows] == sorted((r["us_per_step"] for r in rows), reverse=True)
    stages = t_prof.attribute_stages(rows, RULES["bench"])
    assert stages == {"unet": 0.041, "other": 0.037}
    assert abs(sum(stages.values()) - sum(r["us_per_step"] for r in rows) / 1e3) <= 5e-4 * len(stages)


def test_parse_device_trace_reads_the_newest_trace(tmp_path):
    assert t_prof.parse_device_trace(str(tmp_path), steps=1) == []
    _copy_fixture(tmp_path, gz=False)
    newer = tmp_path / "later.json"
    newer.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": 1.0, "dur": 3.0, "args": {}}]}))
    old = time.time() - 100
    os.utime(tmp_path / "profile" / "run" / "trace.json", (old, old))
    rows = t_prof.parse_device_trace(str(tmp_path), steps=3)
    assert rows == [{"op": "k", "us_per_step": 1.0, "category": "kernel", "source": "", "long_name": "k",
                     "launches_per_step": 1 / 3}]


def test_device_ms_by_range_takes_the_innermost_range():
    """Each device event goes to the innermost ``mgu.unet*`` device range
    that holds it (another prefix's ranges and host ranges do not count),
    ``outside`` when none does; ms a step over ``steps``."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1, "ts": ts, "dur": dur}

    events = [ev("gpu_user_annotation", "mgu.unet", 0.0, 1000.0),
              ev("gpu_user_annotation", "mgu.unet.enc2", 100.0, 300.0),
              ev("gpu_user_annotation", "mgu.kernel.fused_conv_block", 150.0, 200.0),
              ev("user_annotation", "mgu.unet.dec2", 500.0, 400.0),
              ev("kernel", "conv_block_kernel", 160.0, 180.0),
              ev("kernel", "pad", 120.0, 20.0),
              ev("gpu_memcpy", "Memcpy HtoD", 600.0, 100.0),
              ev("kernel", "head", 990.0, 20.0),
              ev("kernel", "late", 2000.0, 40.0)]
    by_range, by_op = t_prof.device_ms_by_range(events, "mgu.unet", steps=2)
    assert by_range == pytest.approx({"mgu.unet.enc2": 0.1, "mgu.unet": 0.05, "outside": 0.03})
    assert by_op[("mgu.unet.enc2", "conv_block_kernel")] == pytest.approx(0.09)
    assert by_op[("mgu.unet", "Memcpy HtoD")] == pytest.approx(0.05)
    assert set(by_op) == {("mgu.unet.enc2", "conv_block_kernel"), ("mgu.unet.enc2", "pad"),
                          ("mgu.unet", "Memcpy HtoD"), ("outside", "head"), ("outside", "late")}


def test_trace_if_writes_a_trace_it_reads(tmp_path):
    """On the CPU the trace has Python frames and no device event."""
    with t_prof.trace_if(None):
        torch.ones(3).sum()
    trace_dir = tmp_path / "trace"
    x = torch.randn(32, 32)
    with t_prof.trace_if(str(trace_dir)):
        (x @ x).relu().sum()
    files = list(trace_dir.glob("*.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "python_function" and "test_torch_profiling.py" in e.get("name", "") for e in events)
    assert t_prof.parse_device_trace(str(trace_dir), steps=1) == []


def test_step_timer():
    t = t_prof.StepTimer()
    assert t.last_ms != t.last_ms  # nan before the first stop
    t.start()
    y = torch.randn(64, 64) @ torch.randn(64, 64)
    ms = t.stop(y)
    assert ms >= 0 and t.last_ms == ms
    with t_prof.step_timer() as timer:
        time.sleep(0.01)
    assert timer.stop() >= 10.0
