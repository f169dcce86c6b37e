"""The per-layer metric readers on a small canned trace."""

import json

import pytest

from port_bench import core
from port_bench.run import LayerContext
from port_bench.trace import KernelCall, read_trace

HOST, WORKER = 1, 2  # thread ids: the main thread and autograd's


def _x(cat, name, ts, dur, tid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid, "args": args}


def _trace(tmp_path):
    ev = [
        _x("user_annotation", "pb.window", 1000, 1000),
        _x("user_annotation", "pb.layer:unet", 1000, 400),
        _x("user_annotation", "pb.kernel:psel:0", 1100, 50),
        _x("user_annotation", "pb.layer:graph", 1500, 200),
        _x("cpu_op", "aten::copy_", 1750, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 1110, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1300, 5, correlation=2),
        _x("cuda_driver", "cuLaunchKernelEx", 1510, 5, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1800, 5, tid=WORKER, correlation=4),
        _x("kernel", "psel_wgmma_kernel", 1200, 100, tid=0, correlation=1),
        _x("kernel", "cudnn_conv", 1300, 100, tid=0, correlation=2),
        _x("kernel", "gat_softmax", 1600, 50, tid=0, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 1850, 50, tid=0, correlation=4),
        _x("kernel", "before_the_window", 100, 50, tid=0, correlation=99),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return read_trace(str(path))


def _ctx(trace, kind="serve"):
    # The psel call's bound: 50 µs of bytes at 3.35 TB/s.
    call = KernelCall("psel", flops=0.0, bytes=50e-6 * core.HBM_BYTES_PER_S, dtype="bfloat16")
    return LayerContext(kind=kind, steps=2, issue_ms=[10.0, 12.0], unit_s=0.04, flops_per_unit=3.956e12 * 0.04,
                        peak=989e12, trace=trace, calls=[call])


def _read(name, ctx):
    return core.metric_module(name).read(ctx)


def test_window_busy_and_ranges(tmp_path):
    t = _trace(tmp_path)
    assert t.window == (1000, 2000)
    assert t.busy_us() == pytest.approx(300)
    assert t.device_us("pb.layer:unet") == pytest.approx(200)
    assert t.device_us("pb.kernel:") == pytest.approx(100)
    assert t.device_us(exclude="pb.layer:") == pytest.approx(50)
    assert [o.name for o in t.ops] == ["psel_wgmma_kernel", "cudnn_conv", "gat_softmax", "Memcpy DtoH"]
    assert t.top_ops(2) == [["psel_wgmma_kernel", pytest.approx(1e-4)], ["cudnn_conv", pytest.approx(1e-4)]]
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(300e-6)  # the gaps at 1650–1850 and 1900–2000
    assert gaps["pb.layer:graph"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(700e-6)


def test_serve_readers(tmp_path):
    ctx = _ctx(_trace(tmp_path))
    assert _read("host.issue_ms.serve", ctx) == pytest.approx(11.0)
    assert _read("device.idle_share.serve", ctx) == pytest.approx(70.0)
    assert _read("unet.device_ms.serve", ctx) == pytest.approx(0.1)  # 200 µs over 2 requests
    assert _read("graph.device_ms.serve", ctx) == pytest.approx(0.025)
    assert _read("kernels.roofline.serve", ctx) == pytest.approx(50.0)
    assert _read("step.mfu.serve", ctx) == pytest.approx(100 * 3.956e12 / 989e12)
    for name in ("host.issue_ms.train", "device.idle_share.train", "backward.device_ms.train", "step.mfu.train",
                 "kernels.roofline.train"):
        assert _read(name, ctx) is None


def test_train_readers(tmp_path):
    ctx = _ctx(_trace(tmp_path), kind="train")
    # Outside the forward's range: everything not launched under pb.layer:forward (none here).
    assert _read("backward.device_ms.train", ctx) == pytest.approx(0.15)
    assert _read("device.idle_share.train", ctx) == pytest.approx(70.0)
    assert _read("unet.device_ms.serve", ctx) is None


def test_a_reader_with_nothing_to_read_returns_nothing(tmp_path):
    ctx = _ctx(_trace(tmp_path))
    ctx.calls = []
    assert _read("kernels.roofline.serve", ctx) is None
    ctx.trace.ops = []
    assert _read("graph.device_ms.serve", ctx) is None
    assert _read("unet.device_ms.serve", ctx) is None
