"""Profiling hooks over ``torch.profiler``. Counterpart of
``mingraph_unet_tpu/utils/profiling.py`` (which wraps ``jax.profiler``).

- :func:`warm_profile` is ``torch.profiler.profile`` after a warm-up step
  that its results leave out, so that no kernel of the block goes missing.
- :func:`trace_if` records CPU and CUDA activity with Python stacks and
  writes a Chrome trace (``trace-<pid>-<ns>.json.gz``) into a directory.
- :func:`parse_device_trace` reads the device events of the newest such
  trace: each kernel, copy and memset, with the Python frame that launched
  it. The port's hand-written kernels are launched through ``ctypes``, not
  an aten op, so a device event is tied to its host launch (the
  ``cuda_runtime`` event with the same ``correlation``) and from there to
  the innermost frame of this package on the Python stack around that
  launch: a kernel's ``source`` is its wrapper
  (``ops/kernels/psconv.py(...)``), a library kernel's the module that
  called the aten op.
- :func:`attribute_stages` folds rows into stages by source substring.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

__all__ = ["warm_profile", "trace_if", "step_timer", "StepTimer", "parse_device_trace", "attribute_stages"]

_PACKAGE = "mingraph_unet_tpu_torch"
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


# Kernels launched in the discarded warm-up step of a profiled session. In
# a process that has used the card and the profiler for a while (a whole
# file of card tests, chip_smoke.py), the profiler drops the device records
# of a session's first kernels (one to three; at times every one of a short
# session; none in a fresh process); kernels launched in a warm-up step take
# that loss, and every later one is recorded.
WARMUP_KERNELS = 8


@contextlib.contextmanager
def warm_profile(activities, **kwargs) -> Iterator[torch.profiler.profile]:
    """``torch.profiler.profile(activities, **kwargs)`` over the block,
    after a warm-up step that its results leave out (where it records CUDA:
    :data:`WARMUP_KERNELS` tiny kernels, synchronized). Yields the profiler;
    after the block its ``key_averages()`` and ``export_chrome_trace`` hold
    the block's events, every kernel it launched among them."""
    prof = torch.profiler.profile(activities=activities,
                                  schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1), **kwargs)
    prof.record_steps = False  # no "ProfilerStep#" range: it would show among the block's device operations
    prof.start()
    if torch.profiler.ProfilerActivity.CUDA in activities:
        z = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_KERNELS):
            z.add_(1)
        torch.cuda.synchronize()
    prof.step()  # the recorded step
    try:
        yield prof
    finally:
        prof.step()  # ends it
        prof.stop()


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into a Chrome trace under ``trace_dir`` (CPU, and
    CUDA where there is a card, with Python stacks; :func:`warm_profile`,
    so that every kernel the block launches is in the trace); nothing for
    None."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with warm_profile(activities, with_stack=True) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json.gz"))


class StepTimer:
    """Wall-clock step timer; :meth:`stop` first waits for the devices of
    the tensors it is given."""

    def __init__(self):
        self._t0 = None
        self.last_ms = float("nan")

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_tensors: torch.Tensor) -> float:
        for dev in {t.device for t in sync_tensors if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self.last_ms = (time.perf_counter() - self._t0) * 1e3
        return self.last_ms


@contextlib.contextmanager
def step_timer() -> Iterator[StepTimer]:
    t = StepTimer()
    t.start()
    yield t


def _frame_source(name: str) -> str:
    """A Python frame's trace name (``/path/to/file.py(123): fn``) with the
    path cut to start at the package."""
    i = name.find(_PACKAGE + "/")
    return name[i:] if i >= 0 else name


def _open_frames(frames: List[dict], times: List[float]) -> List[List[str]]:
    """For each of the sorted ``times``, the names of one thread's Python
    frames open at that time, outermost first. Frames of one thread nest,
    so one sweep over their starts keeps the stack of open ones."""
    frames = sorted(frames, key=lambda f: (float(f["ts"]), -float(f.get("dur", 0))))
    stack: List[tuple] = []  # (end, name)
    out, j = [], 0
    for t in times:
        while j < len(frames) and float(frames[j]["ts"]) <= t:
            f = frames[j]
            start = float(f["ts"])
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((start + float(f.get("dur", 0)), f["name"]))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append([name for _, name in stack])
    return out


def _launch_sources(events: List[dict], launches: Dict[int, dict]) -> Dict[int, str]:
    """correlation → the innermost frame of this package (else the
    innermost frame) on the Python stack of the thread that made that
    host launch."""
    frames = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "python_function":
            frames[(e.get("pid"), e.get("tid"))].append(e)
    by_thread = collections.defaultdict(list)
    for corr, e in launches.items():
        by_thread[(e.get("pid"), e.get("tid"))].append((float(e["ts"]), corr))
    out: Dict[int, str] = {}
    for thread, items in by_thread.items():
        items.sort()
        stacks = _open_frames(frames.get(thread, []), [t for t, _ in items])
        for (_, corr), names in zip(items, stacks):
            own = [n for n in names if _PACKAGE + "/" in n]
            if own or names:
                out[corr] = _frame_source((own or names)[-1])
    return out


def parse_device_trace(trace_dir: str, steps: int):
    """Per-device-op rows ``{op, us_per_step, category, source, long_name,
    launches_per_step}`` from the newest Chrome trace under ``trace_dir``
    (``*.json`` or ``*.json.gz``, searched recursively), most time first.

    Device events are those of category ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset``; rows sum them by (name, source), and ``source`` is the
    launching frame (the module docstring), ``""`` where none was
    recorded. Returns [] when there is no trace."""
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not paths:
        return []
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    wanted = {e.get("args", {}).get("correlation") for e in device}
    sources = _launch_sources(events, {c: e for c, e in launches.items() if c in wanted})
    time_us: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    meta = {}
    for e in device:
        args = e.get("args", {})
        key = (e["name"], sources.get(args.get("correlation"), ""))
        time_us[key] += float(e.get("dur", 0))
        count[key] += 1
        if key not in meta:
            shape = "" if "grid" not in args else f" grid {args['grid']} block {args.get('block')}"
            meta[key] = (e.get("cat", ""), e["name"] + shape)
    rows = []
    for (name, source), us in time_us.most_common():
        cat, long_name = meta[(name, source)]
        rows.append({"op": name, "us_per_step": us / steps, "category": cat, "source": source,
                     "long_name": long_name, "launches_per_step": count[(name, source)] / steps})
    return rows


def attribute_stages(rows, stage_rules, default: str = "other"):
    """Fold per-op rows into per-stage ms/step by source substring.

    ``stage_rules`` is an ordered list of ``(stage_name, (substr, ...))``;
    the first rule whose substring appears in the op's source wins, and an
    op no rule matches goes to ``default``, so the stage sums equal the
    rows' total."""
    out = {}
    for r in rows:
        src = r["source"]
        stage = default
        for name, subs in stage_rules:
            if any(s in src for s in subs):
                stage = name
                break
        out[stage] = out.get(stage, 0.0) + r["us_per_step"] / 1e3
    return {k: round(v, 3) for k, v in out.items()}
