#!/usr/bin/env python3
"""Device time of the f32 U-Net train step's standard-layout 3×3 convs
(levels 2–4 and the bottleneck), by level and by pass, on the card.

    python3 tools/train_convs.py [--workload unet_f32.train_b16] [--seed 11] [--steps 3] [--route split|cudnn]

Run from the root of the checkout whose port it should measure. The step
is the benchmark cell's own (``port_bench``'s driver: its configuration,
seeded weights and batches, TF32 as the configuration sets it). After the
driver's set-up, ``--steps`` steps are timed by CUDA events and then
profiled (``utils/profiling.py::warm_profile``, input shapes recorded).
Prints ms a step; the forward's device ms by ``mgu.unet.*`` level; the
device ms a step of every convolution, forward and backward, by input
shape (the backward's ``aten::convolution_backward`` holds dgrad and
wgrad) and of the split-form wrappers' ranges where the port has them;
then each of the ten conv sites alone at the step's shapes on seeded
inputs: forward, dgrad and wgrad through cuDNN (one
``aten::convolution_backward`` call a pass, as autograd makes it), each by
CUDA events, with the kernels each pass launches. ``--route cudnn`` runs
the step with the standard blocks' train convs on cuDNN, as before the
split-form kernel (the dispatch's device check patched to false).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity

sys.path.insert(0, os.getcwd())

from mingraph_unet_tpu_torch.utils.profiling import device_ms_by_range, warm_profile  # noqa: E402
from port_bench import core  # noqa: E402

LEVELS = ("mgu.unet.enc2", "mgu.unet.enc3", "mgu.unet.bottleneck", "mgu.unet.dec3", "mgu.unet.dec2")


def sites(cfg: dict, b: int, h: int):
    """(name, (B, H, W, Cin), Cout) of the ten standard-layout convs of a
    depth-4 U-Net at h², levels 2 and 3, the bottleneck, then the decoder
    at levels 3 and 2 (its conv1 over [skip ‖ up])."""
    u = cfg["pipeline"]["model"]["unet"] if "pipeline" in cfg else cfg["unet"]
    f, depth = u["init_features"], u["depth"]
    out = []
    for lvl in range(2, depth + 1):
        name = f"enc{lvl}" if lvl < depth else "bottleneck"
        cin, c, s = f * 2 ** (lvl - 1), f * 2 ** lvl, h >> lvl
        out += [(f"{name} conv1", (b, s, s, cin), c), (f"{name} conv2", (b, s, s, c), c)]
    for lvl in range(depth - 1, 1, -1):
        c, s = f * 2 ** lvl, h >> lvl
        out += [(f"dec{lvl} conv1", (b, s, s, 2 * c), c), (f"dec{lvl} conv2", (b, s, s, c), c)]
    return out


def events_of(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def dev_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0))


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_names(fn) -> list:
    fn()
    torch.cuda.synchronize()
    with warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = collections.Counter()
    for e in events_of(prof):
        if e.get("cat") == "kernel":
            names[e["name"].replace("void ", "")[:70]] += e.get("dur", 0) / 1e3
    return [f"{n} {ms:.3f}" for n, ms in names.most_common()]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="unet_f32.train_b16")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--route", default="split", choices=("split", "cudnn"))
    ap.add_argument("--sites", type=int, default=1, help="0: leave out the sites timed alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_convs: needs a CUDA card")
    from mingraph_unet_tpu_torch.ops.kernels import conv3x3

    if args.route == "cudnn":
        conv3x3.split_conv = lambda x: False
    cell = core.load_cell(args.workload)
    drv = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, args.seed, "cuda")
    drv.setup()
    b, h = cell.traffic["batch"], cell.traffic["height"]
    step_ms = time_ms(lambda: drv.wait(drv.issue(0)), args.steps)
    with warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for j in range(args.steps):
            drv.wait(drv.issue(100 + j))
    card = torch.cuda.get_device_name(0)
    print(f"{card}; {args.workload} seed {args.seed}, route {args.route}: {step_ms:.3f} ms a step (events, "
          f"{args.steps} steps)")
    levels, _ = device_ms_by_range(events_of(prof), "mgu.unet.", args.steps)
    fwd = sum(levels[lv] for lv in LEVELS)
    print(f"forward device ms a step, levels 2-4: {fwd:.3f} ({', '.join(f'{lv[9:]} {levels[lv]:.3f}' for lv in LEVELS)})")
    rows = collections.defaultdict(float)
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key in ("aten::convolution", "aten::convolution_backward") or evt.key.startswith("mgu.kernel.conv3x3"):
            rows[(evt.key, str(evt.input_shapes)[:90])] += dev_us(evt) / 1e3 / args.steps
    for (key, shapes), ms in sorted(rows.items(), key=lambda r: -r[1]):
        if ms >= 0.01:
            print(f"  {ms:9.3f} ms  {key} {shapes}")
    if not args.sites:
        return
    print("sites alone (cuDNN f32, TF32 as configured): forward / dgrad / wgrad ms by events")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    totals = [0.0, 0.0, 0.0]
    for name, shape, cout in sites(cell.config, b, h):
        x = torch.randn(shape, generator=g, device="cuda").permute(0, 3, 1, 2)
        w = torch.randn((cout, shape[3], 3, 3), generator=g, device="cuda") * 0.05
        y = torch.nn.functional.conv2d(x, w, padding=1)
        dy = torch.randn(y.shape, generator=g, device="cuda").contiguous(memory_format=torch.channels_last)

        def bwd(mask):
            return lambda: torch.ops.aten.convolution_backward(dy, x, w, [cout], [1, 1], [1, 1], [1, 1], False,
                                                               [0, 0], 1, mask)

        passes = [lambda: torch.nn.functional.conv2d(x, w, padding=1), bwd([True, False, False]),
                  bwd([False, True, True])]
        ms = [time_ms(p, 3) for p in passes]
        totals = [t + m for t, m in zip(totals, ms)]
        print(f"  {name} {shape} -> {cout}: {ms[0]:.3f} / {ms[1]:.3f} / {ms[2]:.3f}")
        for label, p in zip(("fwd", "dgrad", "wgrad"), passes):
            print(f"      {label}: {'; '.join(kernel_names(p)[:4])}")
    print(f"  sum: {totals[0]:.3f} / {totals[1]:.3f} / {totals[2]:.3f}")


if __name__ == "__main__":
    main()
