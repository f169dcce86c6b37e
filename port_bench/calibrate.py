"""Readings that set a cell's limits: the program against the reference
on many seeds, and the control (the reference in the configuration's
``control`` precision, in the program's place) or a planted fault on a
few, all at the cell's own size, in one process.

    python -m port_bench.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 5,6,7] [--fault half_batch --fault-seeds 8,9,10]

Each seed runs set-up and ``units`` units (a serving cell: every request
below its check's ``within``), then the comparison; one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import core, faults
from port_bench.reference.numerics import Precision


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def reading(cell, seed: int, device: str, fault=None, control=None) -> dict:
    driver = core.driver_module(cell.traffic["entry"]).make(cell.config, cell.traffic, seed, device)
    if fault:
        faults.plant(driver, fault)
    t0 = time.perf_counter()
    try:
        driver.setup()
        n = cell.traffic["check"]["within"] if "check" in cell.traffic else 1
        for i in range(n):
            driver.wait(driver.issue(i))
        driver.end_window(n)
    finally:
        faults.lift(driver)
    got = driver.program_outputs()
    driver.free()
    if control:
        got = driver.reference(Precision(control))
    want = driver.reference(Precision("f32"), got)
    numbers = driver.compare(got, want)
    row = {"seed": seed, "what": control and f"control {control}" or fault and f"fault {fault}" or "program",
           "numbers": numbers, "seconds": time.perf_counter() - t0}
    if getattr(driver, "worst", None):
        row["worst_leaf"] = dict(driver.worst)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    print(f"# {torch.cuda.get_device_name(0)}", flush=True)
    for s in _seeds(args.seeds):
        print(json.dumps(reading(cell, s, "cuda")), flush=True)
    for s in _seeds(args.control_seeds):
        print(json.dumps(reading(cell, s, "cuda", control=cell.config["control"])), flush=True)
    for s in _seeds(args.fault_seeds):
        print(json.dumps(reading(cell, s, "cuda", fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
