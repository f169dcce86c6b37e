#!/usr/bin/env python3
"""Device time of an eval U-Net forward by level and kernel, on the card.

    python3 tools/unet_levels.py [--dtype float32] [--batch 16] [--size 512] [--iters 3] [--trace FILE]

Run from the root of the checkout whose port it should measure. The U-Net
is the serving one (init 32, depth 4, seeded weights), in eval mode, TF32
off; after three warm forwards ``--iters`` forwards are profiled
(``utils/profiling.py::warm_profile``), and each device operation is given
to the innermost ``mgu.unet*`` range that holds it on the device timeline
(``outside`` if none; ``utils/profiling.py::device_ms_by_range``). Prints
ms a forward: the total, each level, and each level's operations of 0.05 ms
or more. ``--trace`` keeps the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity

sys.path.insert(0, os.getcwd())

from mingraph_unet_tpu_torch.models.unet import UNet  # noqa: E402
from mingraph_unet_tpu_torch.utils.profiling import device_ms_by_range, warm_profile  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", help="keep the Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("unet_levels: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = UNet(torch.Generator().manual_seed(0), dtype=getattr(torch, args.dtype)).cuda().eval()
    x = torch.randn((args.batch, args.size, args.size, 3), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with warm_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                model(x)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    levels, ops = device_ms_by_range(events, "mgu.unet", args.iters)
    print(f"{torch.cuda.get_device_name(0)}; U-Net {args.dtype} eval, {args.size}² b{args.batch}: "
          f"{sum(levels.values()):.3f} device ms a forward")
    for level, ms in sorted(levels.items()):
        print(f"{level:22s} {ms:9.3f}")
        for (lv, name), op_ms in ops.most_common():
            if lv == level and op_ms >= 0.05:
                print(f"    {op_ms:9.3f}  {name.replace('void ', '').replace('(anonymous namespace)::', '')[:80]}")


if __name__ == "__main__":
    main()
