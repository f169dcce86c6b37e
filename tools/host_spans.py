#!/usr/bin/env python3
"""What the port's own spans (``utils/profiling.py::span``) cost the host,
and what its sync markers find, in one cell of ``BENCHMARK.json``.

    python3 tools/host_spans.py --workload mgu_bf16.tiles_b64 [--units 6] [--rounds 3] [--out DIR]

The cell's driver (``port_bench/drivers/``) is set up as the benchmark sets
it up, then:

- ``off_ns``: ns a ``with span(...)`` block while no profiler records (a
  million blocks, without and with a call's three inputs as ``args``, less
  an empty loop's ns);
- ``spans``: the ``mgu.`` ranges of one traced unit by name (the sync
  markers apart);
- ``unit_ms``: the host time of a unit issued and waited for, the median of
  ``--units`` units in each of ``--rounds`` rounds, in turns: untraced;
  under ``torch.profiler`` (CPU and CUDA) with the spans; under the
  profiler with every span the shared no-op (the program's modules'
  ``span`` swapped for the rounds' length);
- ``syncs``: a traced window of ``--units`` units in a ``pb.window`` range
  (after ``warm_profile``'s warm-up step), read by ``port_bench/trace.py``
  and the four host readers (``port_bench/metrics/host.*``); each marker's
  site with its count and its wait a unit (the reader on that site's
  markers alone); the synchronizing runtime calls of the window
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, a synchronous
  ``cudaMemcpy*``) on each thread, those followed by a marker before the
  thread's next launch or sync, and their summed durations a unit.

The window's Chrome trace is kept gzipped under ``--out``, beside
``host_spans-<workload>.json``, the line this prints.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

READERS = ("host.syncs.serve", "host.syncs.train", "host.sync_wait_ms.serve", "host.weights_ms.serve")


def off_ns(profiling, torch) -> dict:
    span = profiling.span
    x, k, b = torch.zeros(2, 4, 4, 128), torch.zeros(3, 3, 32, 32), torch.zeros(32)

    def empty(n):
        for _ in range(n):
            pass

    def bare(n):
        for _ in range(n):
            with span("unet"):
                pass

    def with_args(n):
        for _ in range(n):
            with span("kernel.psel_conv3x3", (x, k, b)):
                pass

    n = 1_000_000
    out = {}
    for name, fn in (("empty", empty), ("span", bare), ("span_args", with_args)):
        t = time.perf_counter_ns()
        fn(n)
        out[name] = (time.perf_counter_ns() - t) / n
    return {"span": out["span"] - out["empty"], "span_args": out["span_args"] - out["empty"]}


def swapped_spans(profiling):
    """The program's modules' ``span`` → the shared no-op, and back."""
    real = profiling.span
    owners = [m for name, m in list(sys.modules.items())
              if name.startswith("mingraph_unet_tpu_torch") and m is not profiling and getattr(m, "span", None) is real]
    off = lambda name, args=None: profiling.NO_SPAN  # noqa: E731

    class Swap:
        def __enter__(self):
            for m in owners:
                m.span = off

        def __exit__(self, *exc):
            for m in owners:
                m.span = real

    return Swap()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--units", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/host_spans")
    ap.add_argument("--root", default=str(ROOT), help="a tree holding BENCHMARK.json and port_bench's data")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mingraph_unet_tpu_torch.utils import profiling
    from port_bench import core
    from port_bench import trace as tr
    from port_bench.run import LayerContext, use_checkout_caches

    cell = core.load_cell(args.workload, Path(args.root))
    use_checkout_caches(ROOT)
    on_card = args.device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    result = {"workload": args.workload, "units": args.units}
    if on_card:
        result["card"] = torch.cuda.get_device_name(0)
    driver = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, args.seed, args.device)
    driver.setup()
    sync()
    base = 1 << 30
    count = [0]

    def unit() -> float:
        sync()
        t = time.perf_counter()
        driver.wait(driver.issue(base + count[0]))
        sync()
        count[0] += 1
        return (time.perf_counter() - t) * 1e3

    result["off_ns"] = off_ns(profiling, torch)

    times = {"untraced": [], "traced": [], "traced_no_spans": []}
    for _ in range(args.rounds):
        for mode in times:
            prof = profile(activities=acts) if mode != "untraced" else None
            swap = swapped_spans(profiling) if mode == "traced_no_spans" else None
            if swap:
                swap.__enter__()
            if prof:
                prof.start()
            times[mode] += [unit() for _ in range(args.units)]
            if prof:
                prof.stop()
            if swap:
                swap.__exit__()
            profiling.span("unet")  # the first span after a session ends its sync markers
    result["unit_ms"] = {k: statistics.median(v) for k, v in times.items()}

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with profiling.warm_profile(acts) as prof:
        sync()
        with record_function("pb.window"):
            for _ in range(args.units):
                unit()
    fd, raw = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(raw)
        trace = tr.read_trace(raw)
        with open(raw) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        with open(raw, "rb") as f, gzip.open(out / f"trace-{args.workload}.json.gz", "wb") as g:
            shutil.copyfileobj(f, g)
    finally:
        os.remove(raw)
    profiling.span("unet")

    def ctx(host, kind=driver.kind):
        t = tr.Trace(trace.window, trace.ops, host)
        return LayerContext(kind, args.units, [], 0.0, 0.0, 1.0, t, [])

    readers = {name: core.metric_module(name).read(ctx(trace.host)) for name in READERS}
    names = [h["name"] for h in trace.host if h["name"].startswith(profiling.SPAN_PREFIX)]
    markers = [n for n in names if n.startswith(profiling.SYNC_PREFIX)]
    sites = {}
    wait = core.metric_module("host.sync_wait_ms.serve").read  # read as a request's, whatever the unit
    for site in sorted(set(markers)):
        host = [h for h in trace.host if not h["name"].startswith(profiling.SYNC_PREFIX) or h["name"] == site]
        sites[site] = {"per_unit": markers.count(site) / args.units, "wait_ms": wait(ctx(host, "serve"))}
    spans = {}
    for n in names:
        if not n.startswith(profiling.SYNC_PREFIX):
            spans[n] = spans.get(n, 0) + 1 / args.units
    result["spans"] = dict(sorted(spans.items()))
    result["spans_per_unit"] = sum(spans.values())

    w0, w1 = trace.window
    for e in events:
        e["ts"], e["end"] = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
    marker_ev = [e for e in events if str(e["name"]).startswith(profiling.SYNC_PREFIX)]
    spans_ev = [e for e in events if str(e["name"]).startswith(profiling.SPAN_PREFIX) and e not in marker_ev]
    by_thread = {}
    for e in events:
        if w0 <= e["ts"] <= w1 and profiling.is_sync_runtime_call(e):
            by_thread.setdefault(e["tid"], []).append(e)
    runtime = {}
    per_unit = lambda evs: {"calls": len(evs) / args.units,  # noqa: E731
                            "ms": sum(e["end"] - e["ts"] for e in evs) / 1e3 / args.units}
    for tid, syncs in by_thread.items():
        calls = sorted((e for e in events if e.get("tid") == tid and profiling.is_device_call(e)),
                       key=lambda e: e["ts"])
        inside = [s for s in syncs if any(p.get("tid") == tid and p["ts"] <= s["ts"] <= p["end"] for p in spans_ev)]
        marked = []
        for s in inside:
            nxt = min((m["ts"] for m in marker_ev if m.get("tid") == tid and m["ts"] >= s["end"]), default=None)
            if nxt is not None and not any(s["end"] <= o["ts"] < nxt for o in calls):
                marked.append(s)
        runtime[str(tid)] = {"all": per_unit(syncs), "inside_spans": per_unit(inside), "marked": per_unit(marked),
                             "names": sorted({e["name"] for e in syncs})}
    result["syncs"] = {"readers": readers, "sites": sites, "runtime_by_thread": runtime}
    result["idle_gaps"] = trace.idle_gaps()
    line = json.dumps(result)
    (out / f"host_spans-{args.workload}.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
