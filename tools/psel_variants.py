#!/usr/bin/env python3
"""Probe builds of the psel kernel (``csrc/psel_conv.cu``): variants of the
source, each made by a textual patch, built side by side with ``nvcc`` and
timed on one CUDA card in one process, so that a design question is
answered by device time on the same card and inputs.

    python3 tools/psel_variants.py [--variants base,no_layout,...]

Each variant is ``csrc/psel_conv.cu`` with the replacements of
``VARIANTS`` applied (a replacement that does not match is an error),
built into ``outputs/psel_variants/<name>.so``. Cases (bf16, seeded,
the raw f32 HWIO kernel as a parameter lies): ``chip_smoke.py`` phase 14's
inner shards of four (L0 (8, 64, 256, 128) at C = 32, L1 (8, 32, 128, 256)
at C = 64) forward with their two rows and with none, with the kernel in
bf16, the dgrad (adjoint) with rows, and the whole tensor's forward. A variant that changes what the kernel computes (for
example ``no_layout``, which skips the weights' layout) is timed, not
checked; the others must equal ``base`` bit for bit. Prints the card's
name and power limit, then one JSON line a variant and case: the device µs
of the kernel (torch.profiler, ``chip_smoke._device_ops``).

    python3 tools/psel_variants.py --f32 [--variants base,abuf2,...]

builds the variants of ``F32_VARIANTS`` instead (the f32 split kernel's
design choices) and times the f32 forward and dgrad on the whole 512² b8
tensors (L0 (8, 256, 256, 128), L1 (8, 128, 128, 256)), each held bit for
bit against ``base`` and, for each variant, ptxas's report of the split
kernel's registers and any wgmma serialization.
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
OUT = ROOT / "outputs" / "psel_variants"

# name -> [(old, new), ...] applied to csrc/psel_conv.cu.
VARIANTS = {
    "base": [],
    # The consumers skip the weights' layout (the products read whatever
    # shared memory holds): what the prologue costs.
    "no_layout": [("  const bool lead = threadIdx.x == 0;\n",
                   "  const bool lead = threadIdx.x == 0;\n  if (a.b > 0) {\n"
                   "    sm90::bar_sync(WEIGHTS_BAR, CONSUMERS);\n    if (lead) sm90::mbar_arrive(wready);\n"
                   "    return;\n  }\n")],
    # The consumer threads read the raw planes straight from global memory
    # (every SM the same lines at once) instead of staging them by TMA; no
    # ring stage is held.
    "ldg_gather": [("  if (lead)\n    for (int p = 0; p < 9 && p < sl.ns; ++p) {",
                    "  if (lead && a.b < 0)\n    for (int p = 0; p < 9 && p < sl.ns; ++p) {"),
                   ("    sm90::mbar_wait(&sbar[j], (p / sl.ns) & 1);\n    lay(smem + sl.at(j), p);\n"
                    "    if (p + sl.ns < 9) {",
                    "    lay(w + size_t(p) * sl.pb, p);\n    if (a.b < 0) {"),
                   ("  const int blocked = RawSlots<P>(a.w_f32).first_blocked;", "  const int blocked = P::STAGES;")],
}
# The f32 split kernel's choices: two fragment buffers at C = 32 as at 64
# (ptxas's 168 registers a thread of 288), TH = 4 tiles at C = 32 (with two
# buffers), and a producer warpgroup that hands its registers to the
# consumers by setmaxnreg (384 threads).
_AB2 = ("  static constexpr int ABUF = C <= 32 ? 1 : 2;", "  static constexpr int ABUF = 2;")
F32_VARIANTS = {
    "base": [],
    "abuf2": [_AB2],
    "th4": [_AB2, ("  static constexpr int TH = C <= 32 ? 8 : 4;  // s2d rows a tile, as the bf16 plan's",
                   "  static constexpr int TH = 4;")],
    "wg384": [("constexpr int SPLIT_THREADS = 288; ", "constexpr int SPLIT_THREADS = 384; "),
              ("    if (threadIdx.x == CONSUMERS) produce<P>(a, maps, smem + P::RING, full, empty, wready);\n"
               "  } else {\n    lay_weights<P>(a, smem, sbar, wready, [&]",
               "    sm90::setmaxnreg_dec<PRODUCER_REGS>();\n"
               "    if (threadIdx.x == CONSUMERS) produce<P>(a, maps, smem + P::RING, full, empty, wready);\n"
               "  } else {\n    sm90::setmaxnreg_inc<CONSUMER_REGS>();\n    lay_weights<P>(a, smem, sbar, wready, [&]")],
}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]


def build(names, variants=VARIANTS):
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "psel_conv.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in variants[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: no match for {old!r}")
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
        kernel = None  # ptxas's report of each split kernel: registers, and any wgmma serialization
        for line in out.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("psel_split_kernel")[1][:13] if "psel_split_kernel" in line else None
            elif "C7512" in line and "psel_split_kernel" in line:  # printed before its entry's line
                print(f"[psel_variants] {name} split{line.split('psel_split_kernel')[1][:13]}: wgmma serialized "
                      f"({line.split('serialized', 1)[1].split(' for ')[0].strip()})", flush=True)
            elif kernel and "Used" in line and "registers" in line:
                print(f"[psel_variants] {name} split{kernel}: {line.split(':', 1)[1].strip()[:120]}", flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.mgu_psel_conv3x3_halo
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _f32(cs, libs, dev, stream):
    """The f32 forward and dgrad of each variant on the whole 512² b8
    tensors, bit for bit against ``base``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(23)
    for lvl, c in ((0, 32), (1, 64)):
        hh = cs.SIZE // 2 ** (lvl + 1)
        x = torch.randn((cs.BATCH, hh, hh, 4 * c), generator=g, device=dev)
        k = torch.randn((3, 3, c, c), generator=g, device=dev) * (1.0 / (9 * c)) ** 0.5
        ref = {}
        for name, fn in libs.items():
            for adj in (0, 1):
                y = torch.empty_like(x)

                def call(y=y, fn=fn, adj=adj):
                    rc = fn(x.data_ptr(), None, None, k.data_ptr(), None, y.data_ptr(), cs.BATCH, hh, hh, c, c, 0, 0,
                            1, adj, stream)
                    if rc:
                        raise RuntimeError(f"{name}: cudaError {rc}")
                call()
                torch.cuda.synchronize()
                if name == "base":
                    ref[adj] = y.clone()
                ops = cs._device_ops(call, 10)
                print(json.dumps({"variant": name, "level": lvl, "case": "dgrad" if adj else "fwd",
                                  "shape": list(x.shape), "device_us": sum(t * n for key, t, n in ops
                                                                           if "psel_split_kernel" in key),
                                  "equal_to_base": bool(torch.equal(y, ref[adj]))}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default=None)
    p.add_argument("--f32", action="store_true", help="the f32 split kernel's variants (F32_VARIANTS)")
    args = p.parse_args()
    variants = F32_VARIANTS if args.f32 else VARIANTS
    names = (args.variants or ",".join(variants)).split(",")
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("[psel_variants] no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = build(names, variants)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(17)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if args.f32:
        _f32(cs, libs, dev, stream)
        return 0
    for lvl, c in ((0, 32), (1, 64)):
        hh = cs.SIZE // 2 ** (lvl + 1)
        x = torch.randn((cs.BATCH, hh, hh, 4 * c), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((3, 3, c, c), generator=g, device=dev) * (1.0 / (9 * c)) ** 0.5
        kb = k.to(torch.bfloat16)
        xs, top, bot, _ = cs._shard_views(x, cs._shard_cuts(hh)[0])[1]
        cases = {"shard": (xs, top, bot), "shard_norows": (xs, None, None), "whole": (x, None, None),
                 "shard_bf16_kernel": (xs, top, bot), "shard_dgrad": (xs, top, bot)}
        ref = {}
        for name in names:
            fn = libs[name]
            for case, (t, tp, bt) in cases.items():
                y = torch.empty_like(t)

                kk = kb if case == "shard_bf16_kernel" else k
                adj = int(case == "shard_dgrad")

                def call(t=t, tp=tp, bt=bt, y=y, fn=fn, kk=kk, adj=adj):
                    rc = fn(t.data_ptr(), None if tp is None else tp.data_ptr(), None if bt is None else bt.data_ptr(),
                            kk.data_ptr(), None, y.data_ptr(), t.shape[0], t.shape[1], t.shape[2], c, c, 1, 0,
                            int(kk.dtype == torch.float32), adj, stream)
                    if rc:
                        raise RuntimeError(f"{name}: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                same = None
                if name == "base":
                    ref[case] = y.clone()
                elif case in ref:
                    same = bool(torch.equal(y, ref[case]))
                    if not same and VARIANTS[name] and name != "no_layout":
                        print(f"[psel_variants] {name} {case} L{lvl}: differs from base", file=sys.stderr)
                ops = cs._device_ops(call, 10)
                us = sum(t_ * n for key, t_, n in ops if "psel_wgmma_kernel" in key)
                print(json.dumps({"variant": name, "level": lvl, "case": case, "shape": list(t.shape),
                                  "device_us": us, "equal_to_base": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
