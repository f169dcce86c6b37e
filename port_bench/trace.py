"""Spans placed from the benchmark's own code, and the reading of the
profiler's trace.

:class:`Spans` opens a ``torch.profiler.record_function`` range around each
call into a layer (forward pre-hooks and hooks on the model's submodules,
``pb.layer:<layer>``) and around each call of a hand-written kernel's
wrapper (``pb.kernel:<kernel>:<n>``), recording the call's operations and
bytes from its shapes (``roofline/<kernel>.py``). Nothing of the program
is edited: the wrappers are swapped in the modules that bound them for the
traced steps only, and swapped back.

:func:`read_trace` ties each device operation to the host launch with its
``correlation`` and so to the ranges open on the launching thread at that
moment.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from port_bench.core import HBM_BYTES_PER_S, PEAK_FLOPS

PACKAGE = "mingraph_unet_tpu_torch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def tensor_bytes(xs) -> int:
    """Bytes of every tensor among ``xs`` (nested tuples and lists too)."""
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += tensor_bytes(x)
    return total


@dataclass
class KernelCall:
    kernel: str
    flops: float
    bytes: float
    dtype: str

    @property
    def bound_s(self) -> float:
        """The least time: the larger of bytes over HBM bandwidth and
        operations over the peak of the call's precision."""
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / PEAK_FLOPS.get(self.dtype, PEAK_FLOPS["bfloat16"]))


class Spans:
    """Within: layer and kernel ranges on the traced calls."""

    def __init__(self, layers: Dict[str, List[torch.nn.Module]], kernels: Dict[str, object]):
        self.layers, self.kernels = layers, kernels
        self.calls: List[KernelCall] = []
        self._handles, self._swaps = [], []

    def __enter__(self) -> "Spans":
        for layer, modules in self.layers.items():
            for m in modules:
                stack: List[object] = []

                def pre(_mod, _args, _name=f"pb.layer:{layer}", _stack=stack):
                    rf = torch.profiler.record_function(_name)
                    rf.__enter__()
                    _stack.append(rf)

                def post(_mod, _args, _out, _stack=stack):
                    _stack.pop().__exit__(None, None, None)

                self._handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
        for name, mod in self.kernels.items():
            self._swap(name, mod)
        return self

    def _swap(self, name: str, roof) -> None:
        module_name, attr = roof.WRAPPER
        owner = sys.modules.get(module_name)
        if owner is None:
            return
        orig = getattr(owner, attr)
        calls = self.calls

        def shim(*args, **kwargs):
            n = len(calls)
            with torch.profiler.record_function(f"pb.kernel:{name}:{n}"):
                out = orig(*args, **kwargs)
            calls.append(KernelCall(name, float(roof.flops(*args, **kwargs)), float(tensor_bytes(args) + tensor_bytes([out])),
                                    str(args[0].dtype).replace("torch.", "")))
            return out

        shim.launches = getattr(orig, "launches", 0)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith(PACKAGE):
                for key, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, key, shim)
                        self._swaps.append((mod, key, orig, shim))

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        for mod, key, orig, shim in reversed(self._swaps):
            setattr(mod, key, orig)
            orig.launches = shim.launches
        self._handles, self._swaps = [], []


@dataclass
class DeviceOp:
    name: str
    ts: float
    dur: float
    ranges: Tuple[str, ...]


@dataclass
class Trace:
    """The traced window (µs, the trace's clock) and its device operations."""

    window: Tuple[float, float]
    ops: List[DeviceOp]
    host: List[dict] = field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        spans = sorted((max(o.ts, w0), min(o.ts + o.dur, w1)) for o in self.ops)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_us(self, prefix: Optional[str] = None, exclude: Optional[str] = None) -> float:
        """Device time of the operations launched inside a range whose name
        starts with ``prefix`` (every operation for None), leaving out those
        inside one that starts with ``exclude``."""
        total = 0.0
        for o in self.ops:
            if prefix is not None and not any(r.startswith(prefix) for r in o.ranges):
                continue
            if exclude is not None and any(r.startswith(exclude) for r in o.ranges):
                continue
            total += o.dur
        return total

    def top_ops(self, n: int = 10) -> List[List[object]]:
        c: collections.Counter = collections.Counter()
        for o in self.ops:
            c[o.name] += o.dur
        return [[name, us * 1e-6] for name, us in c.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[List[object]]:
        """Idle time between device operations in the window, summed by the
        innermost host operation or range open at each gap's middle."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        c: collections.Counter = collections.Counter()
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a <= 0:
                continue
            mid = (a + b) / 2
            name = "host idle"
            # The latest-starting operation still open at mid is the innermost.
            for j in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 4000), -1):
                if host[j]["ts"] + host[j]["dur"] >= mid:
                    name = host[j]["name"]
                    break
            c[name] += b - a
        return [[name, us * 1e-6] for name, us in c.most_common(n)]


def read_trace(path: str) -> Trace:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = [e for e in (data["traceEvents"] if isinstance(data, dict) else data) if e.get("ph") == "X"]
    ranges = collections.defaultdict(list)
    window = None
    host_ops = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and str(e["name"]).startswith("pb."):
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if e["name"] == "pb.window":
                window = (ts, ts + dur)
            ranges[(e.get("pid"), e.get("tid"))].append((ts, ts + dur, e["name"]))
        if cat in ("cpu_op", "user_annotation"):
            host_ops.append({"ts": float(e["ts"]), "dur": float(e.get("dur", 0)), "name": e["name"]})
    if window is None:
        raise ValueError(f"{path}: no pb.window range")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if ts + dur < window[0] or ts > window[1]:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        open_ranges: Tuple[str, ...] = ()
        if launch is not None:
            t = float(launch["ts"])
            open_ranges = tuple(n for a, b, n in ranges[(launch.get("pid"), launch.get("tid"))] if a <= t <= b)
        ops.append(DeviceOp(e["name"], ts, dur, open_ranges))
    host = [h for h in host_ops if h["ts"] + h["dur"] >= window[0] and h["ts"] <= window[1] and h["name"] != "pb.window"]
    return Trace(window, ops, host)
