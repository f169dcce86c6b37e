"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start to the first timed unit): the kernels' build
directories inside the checkout, the model built and its weights drawn on
the card from ``--seed``, the inputs drawn from the seed into pinned host
memory, the warm-up units (every shape the window uses). The window: units
issued one after another for ``--seconds`` (a serving request waits for its
outputs on the host before the next is sent; training steps are issued
back to back, and the window ends when the last is done). ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` runs the same window,
then the host issue steps and the profiled steps, and reports the cell's
per-layer metrics, ``busy_s``, ``window_s`` and a breakdown. Once the
window has closed, the peak device memory is read, the program freed, and
the kept outputs compared with the plain reference (``reference/``); each
number compared is printed beside its limit (``limits/<workload>.json``)
on standard error and last in the result line.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from port_bench import core  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mingraph_unet_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def use_checkout_caches(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    CUDA libraries into its own ``build/`` there)."""
    for var, sub in CACHE_DIRS.items():
        path = root / ".port_bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def card_report(torch) -> Dict[str, object]:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    print(f"[port_bench] card {name}; devices {torch.cuda.device_count()}; nvidia-smi name, power.limit: {limit}",
          file=sys.stderr)
    return {"name": name, "power_limit": limit}


@dataclass
class Window:
    units: int = 0
    seconds: float = 0.0
    latencies_s: List[float] = field(default_factory=list)


def run_window(driver, seconds: float, sync) -> Window:
    """Units back to back for ``seconds``: a unit that waits (a request)
    ends when its outputs are on the host; others are issued, and the
    window ends when the last is done."""
    sync()
    w = Window()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        ts = time.perf_counter()
        if ts >= deadline:
            break
        handle = driver.issue(w.units)
        if driver.sync_each:
            driver.wait(handle)
            w.latencies_s.append(time.perf_counter() - ts)
        w.units += 1
    sync()
    w.seconds = time.perf_counter() - t0
    driver.end_window(w.units)
    return w


def end_to_end(name: str, w: Window, driver, setup_s: float) -> Optional[float]:
    import numpy as np

    if name == "setup_s":
        return setup_s
    if name == "serve_mpix_s":
        return w.units * driver.pixels_per_unit / 1e6 / w.seconds
    if name == "serve_p95_ms":
        return float(np.percentile(np.asarray(w.latencies_s) * 1e3, 95)) if w.latencies_s else None
    if name == "train_images_s":
        return w.units * driver.images_per_unit / w.seconds
    raise KeyError(f"no end-to-end metric {name!r} in port_bench/run.py")


@dataclass
class LayerContext:
    """What a per-layer metric reader (``metrics/<name>.py``) reads."""

    kind: str
    steps: int
    issue_ms: List[float]
    unit_s: float
    flops_per_unit: float
    peak: float
    trace: object = None
    calls: list = field(default_factory=list)


def traced_steps(driver, torch, cell, w: Window):
    """Host issue steps, then the profiled steps after a discarded warm-up
    step; returns the reader's context (the trace is read and deleted)."""
    from port_bench import trace as tr

    tf = cell.traffic
    on_card = torch.cuda.is_available() and driver.dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    base = 1 << 30  # indices past every kept request
    issue_ms = []
    for j in range(tf["issue_steps"]):
        sync()
        t = time.perf_counter()
        handle = driver.issue(base + j)
        issue_ms.append((time.perf_counter() - t) * 1e3)
        driver.wait(handle)
    steps = tf["trace_steps"]
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    prof = torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.record_steps = False
    spans = tr.Spans(driver.layer_modules(), core.roofline_modules())
    prof.start()
    # The warm-up step: the profiler may drop a session's first device records.
    if on_card:
        z = torch.zeros(1, device=driver.dev)
        for _ in range(8):
            z.add_(1)
    sync()
    prof.step()
    with spans:
        sync()
        with torch.profiler.record_function("pb.window"):
            for j in range(steps):
                driver.wait(driver.issue(base + 1000 + j))
            sync()
    prof.step()
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = tr.read_trace(path)
    finally:
        os.remove(path)
    return LayerContext(driver.kind, steps, issue_ms, w.seconds / max(w.units, 1), driver.flops_per_unit,
                        core.PEAK_FLOPS[driver.precision], trace, spans.calls)


def main(argv=None, root: Path = core.ROOT, device: Optional[str] = None, hooks=None) -> int:
    """``device``/``hooks`` serve the tests: ``device="cpu"`` skips the look
    for a card, and ``hooks(driver)`` may break the program under test."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload, root)
    use_checkout_caches(root)

    import torch

    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"[port_bench] {args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
            return 2
        device = "cuda"
        card = card_report(torch)
    else:
        card = {"name": device}
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    driver = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, args.seed, device)
    if hooks is not None:
        hooks(driver)
    before = process_age_s()
    driver.setup()
    sync()
    setup_s = process_age_s()
    phases = ", ".join(f"{k} {v:.2f}" for k, v in driver.setup_phases.items())
    print(f"[port_bench] set-up {setup_s:.2f} s: interpreter, imports and the card {before:.2f}, {phases}",
          file=sys.stderr)
    w = run_window(driver, args.seconds, sync)
    found = forbidden_modules()
    if found:
        print(f"[port_bench] the process holds {found} once the window has closed", file=sys.stderr)
        return 3

    result: Dict[str, object] = {"correct": False, "attempted": w.units, "failed": 0, "metrics": {}}
    metrics: Dict[str, Dict[str, object]] = {}
    device_info: Dict[str, object] = {"platform": "gpu" if on_card else device, "kind": card["name"],
                                      "count": chips if on_card else 0}
    if args.trace:
        ctx = traced_steps(driver, torch, cell, w)
        for m in cell.per_layer:
            value = core.metric_module(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = ctx.trace.busy_us() * 1e-6
        device_info["window_s"] = ctx.trace.window_us * 1e-6
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    else:
        for m in cell.end_to_end:
            value = end_to_end(m["name"], w, driver, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0

    from port_bench.reference.numerics import Precision

    got = driver.program_outputs()
    driver.free()
    want = driver.reference(Precision("f32"), got)
    numbers = driver.compare(got, want)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = bool(w.units) and all(k in numbers for k in cell.limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result.update(correct=correct, metrics=metrics, device=device_info)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"[port_bench] the process holds {found} after the comparison", file=sys.stderr)
        return 3
    print(json.dumps(result))
    for k, c in checks.items():
        print(f"[port_bench] check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
