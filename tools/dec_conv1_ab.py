#!/usr/bin/env python3
"""Time K2 (``dec_conv1_fused``) of several checkouts of this repository on one
CUDA card, in turns, on the same seeded inputs.

    python3 tools/dec_conv1_ab.py PARENT . . PARENT

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``). For
each, in the order given, a fresh process imports that checkout's port and
builds its kernels, then takes ``chip_smoke.py``'s K2 cases (this
checkout's script: the serving U-Net's two s2d levels, 512² b8 bf16, skip
(8, 256, 256, 128) + x_prev (…, 64) and (8, 128, 128, 256) + (…, 128)),
holds K2 against its plain version within ``CONV_TOL`` and prints one JSON
line a level: CUDA-event µs a launch (wrapper included), the device µs of
the kernel alone and of the whole call (torch.profiler), and the same
function by cuDNN (``conv_transpose2d``, ``cat``, ``conv2d``) by events and
device time. Naming the checkouts as parent, change, change, parent
compares two versions on one card. It prints the card's name and power
limit first and exits non-zero if any check or process fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OWN = ("conv_bf16_kernel", "dec1_wgmma_kernel")  # K2's kernel before and after its Hopper redesign


def _device_us(fn, iters: int = 10):
    """(µs of the whole call, µs of K2's kernel) on the card, torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / e.count * max(1, round(e.count / iters)))
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
    return sum(t for _, t in kernels), sum(t for k, t in kernels if any(o in k for o in OWN))


def one(tree: str) -> int:
    """Time the K2 of the checkout at ``tree`` (this process imports it)."""
    import importlib.util

    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from mingraph_unet_tpu_torch.ops.kernels import build, psconv

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")  # this checkout's
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("[dec_conv1_ab] no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    with torch.no_grad():
        for case in cs._kernel_cases(torch.device("cuda", 0)):
            if case["kind"] != "dec1":
                continue
            args = case["args"]
            tag = f"{tree} L{case['level']}"
            ref = psconv.dec_conv1_fused_plain(args[0].float(), args[1].float(), *args[2:])
            err = cs._check_close(tag, psconv.dec_conv1_fused(*args), ref, cs.CONV_TOL)
            cudnn = cs._dec1_cudnn(args[0], args[1], *case["unfolded"])
            cs._check_close(f"{tag} cuDNN route", cs._s2d_of(cudnn().relu()), ref, cs.CONV_TOL)
            call_us, kernel_us = _device_us(lambda: psconv.dec_conv1_fused(*args))
            print(json.dumps({
                "tree": tree, "level": case["level"], "shape": list(args[0].shape), "max_abs_err": err,
                "us": cs._time_ms(lambda: psconv.dec_conv1_fused(*args), cs.KERNEL_ITERS) * 1e3,
                "device_us": kernel_us, "call_device_us": call_us,
                "cudnn_us": cs._time_ms(cudnn, cs.KERNEL_ITERS) * 1e3, "cudnn_device_us": _device_us(cudnn)[0],
            }), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        return one(sys.argv[2])
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi gave nothing", flush=True)
    for tree in sys.argv[1:]:
        rc = subprocess.run([sys.executable, __file__, "--one", tree], timeout=900).returncode
        if rc != 0:
            print(f"[dec_conv1_ab] {tree}: exit code {rc}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
