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
- :func:`device_ms_by_range` gives each device event of a trace to the
  innermost device-side range of a prefix that holds it (the U-Net's
  ``mgu.unet*`` spans: its device time by level).
- :func:`span` is the program's own range: ``with span("unet.enc0"):``
  opens ``mgu.unet.enc0`` in the profiler's trace while a profiler
  records, and costs one flag test otherwise. While spans record, each
  call of this package that makes the host wait on the card leaves a
  zero-length range ``mgu.sync@<file>:<line>`` (:data:`SYNC_PREFIX`) at
  the moment the call returns.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import sys
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["warm_profile", "trace_if", "step_timer", "StepTimer", "parse_device_trace", "attribute_stages",
           "device_ms_by_range", "span", "NO_SPAN", "SPAN_PREFIX", "SYNC_PREFIX", "LAUNCH_CATEGORIES",
           "SYNC_RUNTIME_CALLS", "is_sync_runtime_call", "is_device_call"]

_PACKAGE = "mingraph_unet_tpu_torch"
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


# ---------------------------------------------------------------------------
# The program's spans and its sync markers
# ---------------------------------------------------------------------------

SPAN_PREFIX = "mgu."
SYNC_PREFIX = "mgu.sync@"
# The warning torch raises at a synchronizing call under set_sync_debug_mode("warn")
# (c10/cuda/CUDAFunctions.cpp: a copy from pageable memory, .item(), nonzero,
# .cpu(), a stream's synchronize).
_SYNC_WARNING = "called a synchronizing CUDA operation"


class _NoSpan:
    """What :func:`span` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


def span(name: str, args: Optional[tuple] = None):
    """The range ``mgu.<name>`` over a ``with`` block.

    While a torch profiler records: ``torch.profiler.record_function`` (a
    ``user_annotation``, which the profiler also draws over the device
    work it launches), on the clock of the device records; with ``args``,
    a call's inputs as a tuple, a ``cpu_op`` range that holds them, so
    that a profiler that records shapes writes their dims and dtypes
    (``Input Dims``, ``Input type``) into the trace (``record_function``'s
    own text argument never reaches it) at no cost of formatting. The
    first such span also starts the sync markers (:func:`_watch_syncs`).
    Otherwise the shared :data:`NO_SPAN`: no allocation, no dispatcher
    call, no string. ``name`` is a fixed string, so that a trace sums a
    span's calls by name; the first span after the profiler has stopped
    ends the sync markers."""
    if _autograd_profiler._is_profiler_enabled:
        if _sync_watch is None or (_sync_watch and warnings.showwarning is not _on_warning):
            _watch_syncs()
        if args is None:
            return torch.profiler.record_function(SPAN_PREFIX + name)
        return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name, tuple(args))  # aborts on another type
    if _sync_watch is not None:
        _unwatch_syncs()
    return NO_SPAN


# While the markers are on: (the sync debug mode to restore or None, the
# ``warnings.showwarning`` to restore, the filter entry added); () while a
# caller's own sync debug mode is left alone; None while off.
_sync_watch: Optional[tuple] = None
_sync_lock = threading.Lock()


def _watch_syncs() -> None:
    """For the profiler's session: every synchronizing call warns
    (``torch.cuda.set_sync_debug_mode("warn")`` where CUDA is initialized),
    each time (an ``always`` filter), and :func:`_on_warning` turns the
    warning into a marker and prints nothing. A sync debug mode that the
    caller set is left as it is, and nothing is marked. A watch whose
    ``showwarning`` someone else has put back (a ``catch_warnings`` block
    that ended) is ended and begun again."""
    global _sync_watch
    with _sync_lock, torch.profiler.record_function(SPAN_PREFIX + "sync.watch"):
        if _sync_watch is not None:
            if not _sync_watch or warnings.showwarning is _on_warning:
                return
            _end_watch()
        cuda = torch.cuda.is_initialized()
        if cuda and torch.cuda.get_sync_debug_mode() != 0:
            _sync_watch = ()
            return
        if cuda:
            _set_sync_mode("warn")
        warnings.filterwarnings("always", message=_SYNC_WARNING, category=UserWarning)
        _sync_watch = (0 if cuda else None, warnings.showwarning, warnings.filters[0])
        warnings.showwarning = _on_warning


def _set_sync_mode(mode) -> None:
    """``torch.cuda.set_sync_debug_mode`` without its one-time notice that
    the mode is a prototype."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


def _unwatch_syncs() -> None:
    """Restore what :func:`_watch_syncs` changed."""
    with _sync_lock:
        _end_watch()


def _end_watch() -> None:
    """:func:`_unwatch_syncs` with the lock held."""
    global _sync_watch
    watch, _sync_watch = _sync_watch, None
    if not watch:
        return
    mode, show, entry = watch
    if mode is not None:
        _set_sync_mode(mode)
    if warnings.showwarning is _on_warning:
        warnings.showwarning = show
    if any(f is entry for f in warnings.filters):
        warnings.filters[:] = [f for f in warnings.filters if f is not entry]
        warnings._filters_mutated()


def _sync_site(frame) -> Optional[str]:
    """``<file>:<line>`` of the innermost frame of this package, the file
    from the package's folder on; None where no frame is the package's."""
    while frame is not None:
        path = frame.f_code.co_filename
        i = path.find(_PACKAGE + os.sep)
        if i >= 0:
            return f"{path[i + len(_PACKAGE) + 1:]}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def _on_warning(message, category, filename, lineno, file=None, line=None) -> None:
    """``warnings.showwarning`` while the markers are on. A sync warning
    while the profiler records becomes ``mgu.sync@<file>:<line>`` of the
    package's innermost frame (none where the call came from outside the
    package); one after it has stopped ends the markers. Either is not
    shown; every other warning goes on to the previous ``showwarning``."""
    watch = _sync_watch
    if _SYNC_WARNING not in str(message):
        show = watch[1] if watch else warnings._showwarning_orig
        if show is warnings._showwarning_orig:  # the module's own, which a catch_warnings may have redirected
            warnings._showwarnmsg_impl(warnings.WarningMessage(message, category, filename, lineno, file, line))
        else:
            show(message, category, filename, lineno, file, line)
        return
    if not _autograd_profiler._is_profiler_enabled:
        _unwatch_syncs()
        return
    site = _sync_site(sys._getframe(1))
    if site is not None:
        with torch.profiler.record_function(SYNC_PREFIX + site):
            pass


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


# A Chrome trace's host calls into the CUDA runtime and driver.
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SYNC_RUNTIME_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def is_sync_runtime_call(e: dict) -> bool:
    """A Chrome trace event of a runtime call that makes the host wait on
    the card: a stream's or the device's synchronize, or a synchronous
    ``cudaMemcpy*``."""
    name = e["name"]
    return e.get("cat") == "cuda_runtime" and (name in SYNC_RUNTIME_CALLS
                                               or (name.startswith("cudaMemcpy") and "Async" not in name))


def is_device_call(e: dict) -> bool:
    """A Chrome trace event of a launch, copy, memset or synchronize of the
    CUDA runtime or driver."""
    return e.get("cat") in LAUNCH_CATEGORIES and any(w in e["name"]
                                                     for w in ("Launch", "Memcpy", "Memset", "Synchronize"))


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


def device_ms_by_range(events, prefix: str, steps: int):
    """(ms a step by range, ms a step by (range, op)) of the trace
    ``events``: each kernel, copy and memset goes to the innermost device
    range (``gpu_user_annotation``) whose name starts with ``prefix`` and
    that holds it on the device timeline, ``"outside"`` if none does."""
    ranges = sorted((e for e in events if e.get("cat") == "gpu_user_annotation"
                     and str(e.get("name", "")).startswith(prefix)), key=lambda r: r.get("dur", 0))
    by_range: collections.Counter = collections.Counter()
    by_op: collections.Counter = collections.Counter()
    for op in (e for e in events if e.get("cat") in _DEVICE_CATEGORIES):
        t0, dur = op["ts"], op.get("dur", 0)
        name = next((r["name"] for r in ranges if r["ts"] <= t0 and t0 + dur <= r["ts"] + r.get("dur", 0)),
                    "outside")
        by_range[name] += dur / 1e3 / steps
        by_op[(name, op["name"])] += dur / 1e3 / steps
    return by_range, by_op
