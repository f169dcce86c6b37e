#!/usr/bin/env python3
"""Probe builds of K2's f32 split kernel (``csrc/dec_conv1.cu``,
``dec1_split_kernel``): variants of the source, each made by a textual
patch, built side by side with ``nvcc`` and timed on one CUDA card in one
process, so that a design question is answered by device time on the same
card and inputs.

    python3 tools/dec1_variants.py [--variants base,loads_only,...]

Each variant is ``csrc/dec_conv1.cu`` with the replacements of ``VARIANTS``
applied (a replacement that does not match is an error), built into
``outputs/dec1_variants/<name>.so``. Cases (f32, ``chip_smoke.py``'s K2
inputs at 512² b8 with the model's strided weights): the whole tensor at
L0 (skip (8, 256, 256, 128), x_prev (..., 64)) and L1 ((8, 128, 128, 256),
(..., 128)), and the sharded entry on the inner shard of four at each
level with its neighbours' rows. A variant that changes what the kernel
computes (``loads_only``, ``products_only``) is timed, not checked; the
others must equal ``base`` bit for bit. Prints the card's name and power
limit, then one JSON line a variant and case: the device µs of the kernel
(torch.profiler, ``chip_smoke._device_ops``), and for each variant
ptxas's registers and spills of the split kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "mingraph_unet_tpu_torch" / "csrc"
OUT = ROOT / "outputs" / "dec1_variants"

_WAIT = "sm90::mbar_wait(&full[s], ph);"
# name -> [(old, new, count), ...] applied to csrc/dec_conv1.cu (count: the
# matches expected, all replaced).
VARIANTS = {
    "base": [],
    # The consumers take each stage and give it back at once: the loads
    # alone (the ring, its barriers and the TMA copies; in a cluster the
    # multicast and its hand-over), what the products hide behind.
    "loads_only": [(_WAIT, _WAIT + " if (a.b > 0) { sm90::mbar_arrive(&empty[s]); next(); continue; }", 2)],
    # The producer fills no stage (its arrival completes each one): the
    # products alone, on whatever shared memory holds. A block of a cluster
    # would run ahead of the others' releases, so L0 only.
    "products_only": [("        sm90::mbar_arrive_expect_tx(&full[s], 2 * nr * P::ROW_BYTES);",
                       "        sm90::mbar_arrive(&full[s]);", 1),
                      ("        if (rank == 0) {\n          unsigned char* dst = ring",
                       "        if (a.b < 0) {\n          unsigned char* dst = ring", 1)],
    # Fewer ring stages than shared memory holds: what the bytes in flight buy.
    "stages3": [("constexpr int SPLIT_MAX_STAGES = 8;", "constexpr int SPLIT_MAX_STAGES = 3;", 1)],
    "stages2": [("constexpr int SPLIT_MAX_STAGES = 8;", "constexpr int SPLIT_MAX_STAGES = 2;", 1)],
}
TIMED_ONLY = ("loads_only", "products_only")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]


def build(names):
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "dec_conv1.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new, count in VARIANTS[name]:
            if text.count(old) != count:
                raise SystemExit(f"variant {name}: {text.count(old)} matches, not {count}, for {old!r}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(["/usr/local/cuda/bin/nvcc", *FLAGS, "-I", str(CSRC), "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed:\n{out[-3000:]}")
        kernel = None  # ptxas's report of each split kernel: registers and spills
        for line in out.splitlines():
            if "Compiling entry" in line or "Function properties" in line:
                kernel = line.split("dec1_split_kernel")[1][:6] if "dec1_split_kernel" in line else None
            elif kernel and ("Used" in line or "spill" in line):
                print(f"[dec1_variants] {name} split{kernel}: {line.split(':', 1)[-1].strip()[:120]}", flush=True)
        lib = ctypes.CDLL(str(so))
        libs[name] = {}
        for entry, n_ptr, n_int in (("mgu_dec_conv1", 6, 15), ("mgu_dec_conv1_halo", 10, 17)):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[name][entry] = fn
    return libs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args()
    names = args.variants.split(",")
    sys.path.insert(0, str(ROOT))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("[dec1_variants] no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = build(names)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    for case in cs._kernel_cases(dev):
        if case["kind"] != "dec1":
            continue
        xs, xp, ks, kp, t9 = (a.float() for a in case["args"])
        lvl, c, hh = case["level"], xs.shape[-1] // 4, xs.shape[1]
        strides = (*ks.stride()[:3], *kp.stride()[:3], *t9.stride()[:2])
        (s, st, sb, row0), (q, qt, qb, _) = (cs._shard_views(xs, cs._shard_cuts(hh)[0])[1],
                                             cs._shard_views(xp, cs._shard_cuts(hh)[0])[1])
        cases = {"whole": (xs, None, None, xp, None, None, 0), "shard": (s, st, sb, q, qt, qb, row0)}
        ref = {}
        for name in names:
            if name == "products_only" and lvl > 0:
                continue
            for cname, (x, xt, xb, xq, xqt, xqb, r0) in cases.items():
                y = torch.empty_like(x)
                b, h, w = x.shape[:3]

                def call(x=x, xt=xt, xb=xb, xq=xq, xqt=xqt, xqb=xqb, r0=r0, y=y, b=b, h=h, w=w, fns=libs[name]):
                    if xt is None and xb is None:
                        rc = fns["mgu_dec_conv1"](x.data_ptr(), xq.data_ptr(), ks.data_ptr(), kp.data_ptr(),
                                                  t9.data_ptr(), y.data_ptr(), b, h, w, c, 2 * c, c, *strides, 0,
                                                  stream)
                    else:
                        rc = fns["mgu_dec_conv1_halo"](x.data_ptr(), ptr(xt), ptr(xb), xq.data_ptr(), ptr(xqt),
                                                       ptr(xqb), ks.data_ptr(), kp.data_ptr(), t9.data_ptr(),
                                                       y.data_ptr(), b, h, w, c, 2 * c, c, r0, hh, *strides, 0,
                                                       stream)
                    if rc:
                        raise RuntimeError(f"{name}: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                same = None
                if name == "base":
                    ref[cname] = y.clone()
                elif name not in TIMED_ONLY and cname in ref:
                    same = bool(torch.equal(y, ref[cname]))
                    if not same:
                        print(f"[dec1_variants] {name} {cname} L{lvl}: differs from base", file=sys.stderr)
                ops = cs._device_ops(call, 10)
                us = sum(t_ * n for key, t_, n in ops if "dec1_split_kernel" in key)
                print(json.dumps({"variant": name, "level": lvl, "case": cname, "shape": list(x.shape),
                                  "device_us": us, "equal_to_base": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
