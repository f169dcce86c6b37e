"""The readers of the program's own host spans (``host.syncs.*``,
``host.sync_wait_ms.serve``, ``host.weights_ms.serve``) on a small canned
trace."""

import json

import pytest

from port_bench import core
from port_bench.run import LayerContext
from port_bench.trace import read_trace

READERS = ("host.syncs.serve", "host.syncs.train", "host.sync_wait_ms.serve", "host.weights_ms.serve")


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": 1, "args": args}


def _trace(tmp_path, markers=True, weights=True, program=True):
    ev = [_x("user_annotation", "pb.window", 1000, 2000)]
    if program:
        ev += [_x("user_annotation", "mgu.unet", 1000, 500), _x("user_annotation", "mgu.aux", 1550, 300)]
    if weights:
        ev += [
            _x("user_annotation", "mgu.weights", 1010, 40),
            _x("user_annotation", "mgu.weights", 1020, 10),  # nested: counted once
            _x("user_annotation", "mgu.weights", 1100, 20),
        ]
    ev += [
        # A copy from pageable memory: the outermost op ends last before its marker.
        _x("cpu_op", "aten::to", 1200, 200),
        _x("cpu_op", "aten::_to_copy", 1210, 180),
        _x("cpu_op", "aten::copy_", 1220, 160),
        # .item(), then a harness range that ends later but is not the call.
        _x("cpu_op", "aten::item", 1600, 100),
        _x("cpu_op", "aten::_local_scalar_dense", 1610, 85),
        _x("user_annotation", "pb.layer:graph", 1550, 158),
    ]
    if markers:
        ev += [_x("user_annotation", "mgu.sync@ops/filters.py:98", 1405, 1),
               _x("user_annotation", "mgu.sync@models/gat.py:34", 1710, 1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return read_trace(str(path))


def _read(name, trace, kind="serve"):
    ctx = LayerContext(kind=kind, steps=2, issue_ms=[10.0], unit_s=0.04, flops_per_unit=1e12, peak=989e12,
                       trace=trace)
    return core.metric_module(name).read(ctx)


def test_host_span_readers(tmp_path):
    t = _trace(tmp_path)
    assert _read("host.syncs.serve", t) == pytest.approx(1.0)  # 2 markers over 2 requests
    assert _read("host.sync_wait_ms.serve", t) == pytest.approx((200 + 100) / 1e3 / 2)
    assert _read("host.weights_ms.serve", t) == pytest.approx((40 + 20) / 1e3 / 2)
    assert _read("host.syncs.train", t, kind="train") == pytest.approx(1.0)
    for name in ("host.syncs.serve", "host.sync_wait_ms.serve", "host.weights_ms.serve"):
        assert _read(name, t, kind="train") is None
    assert _read("host.syncs.train", t) is None


@pytest.mark.parametrize("name", READERS)
def test_host_span_readers_without_the_programs_spans_read_nothing(name, tmp_path):
    t = _trace(tmp_path, markers=False, weights=False, program=False)
    assert _read(name, t, kind="train" if name.endswith(".train") else "serve") is None


@pytest.mark.parametrize("name", ["host.syncs.serve", "host.syncs.train", "host.sync_wait_ms.serve"])
def test_spans_without_a_marker_read_no_sync(name, tmp_path):
    t = _trace(tmp_path, markers=False)
    assert _read(name, t, kind="train" if name.endswith(".train") else "serve") == 0.0


def test_weights_without_a_weights_span_read_nothing(tmp_path):
    assert _read("host.weights_ms.serve", _trace(tmp_path, weights=False)) is None


def test_every_reader_has_a_per_layer_entry():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["layer"] == "host" and m["source"] == "device_trace"
        assert m["moves"] == ("train_images_s" if name.endswith(".train") else "serve_mpix_s")
