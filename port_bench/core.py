"""What every part of the harness shares: the cell's files found by name,
the table of peaks, and the model FLOPs of a configuration.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``configs/<config>.json`` (the entry's ``file``),
``traffic/<mix>.json`` and ``limits/<workload>.json`` under the folder of
the benchmark, and loads ``drivers/<entry>.py`` (the entry the traffic file
names), ``metrics/<metric>.py`` and ``roofline/<kernel>.py`` from this
package by file name, so a later cell, mix, metric or kernel is a new file
and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent

# Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W). f32
# is counted at a third of bf16: the port computes f32 products as three
# bf16 products of a hi/lo split on the tensor cores, and against the
# published 67 TFLOP/s of f32 outside the tensor cores one kernel alone
# already reads above 100%.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 989e12 / 3}


def load_module(path: Path) -> ModuleType:
    """Import a file by path (its name may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(f"port_bench._loaded.{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = workloads[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / "port_bench"
    return Cell(name, bench, w, read_json(root / conf["file"]), read_json(base / "traffic" / f"{w['traffic']}.json"),
                read_json(base / "limits" / f"{name}.json"))


def driver_module(entry: str) -> ModuleType:
    return load_module(PACKAGE_DIR / "drivers" / f"{entry}.py")


def metric_module(name: str) -> ModuleType:
    return load_module(PACKAGE_DIR / "metrics" / f"{name}.py")


def roofline_modules() -> Dict[str, ModuleType]:
    return {p.stem: load_module(p) for p in sorted((PACKAGE_DIR / "roofline").glob("*.py"))}


# ---------------------------------------------------------------------------
# Model FLOPs: 2 × the multiply-adds of the model's own mathematics
# ---------------------------------------------------------------------------


def conv_flops(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def unet_forward_flops(h: int, w: int, in_ch: int, classes: int, init: int, depth: int) -> float:
    """One image: every 3×3 conv, each ConvTranspose 2×2 (one multiply-add
    per output pixel and channel pair) and the final 1×1 conv."""
    total, cin, f = 0.0, in_ch, init
    for i in range(depth + 1):  # the encoder's levels, then the bottleneck
        hi, wi = h >> i, w >> i
        total += conv_flops(hi, wi, 3, cin, f) + conv_flops(hi, wi, 3, f, f)
        cin, f = f, 2 * f
    prev = init * 2**depth
    for i in reversed(range(depth)):
        hi, wi, out = h >> i, w >> i, init * 2**i
        total += 2.0 * hi * wi * prev * (prev // 2)
        total += conv_flops(hi, wi, 3, out + prev // 2, out) + conv_flops(hi, wi, 3, out, out)
        prev = out
    return total + conv_flops(h, w, 1, prev, classes)


def detection_head_hw(h: int, w: int, a: dict) -> Tuple[int, int]:
    """The map the single-box detection head's convs run on, as
    ``models/pipeline.py`` and ``models/detection.py`` decide it: the patch
    grid on the pooled serving path (``detection_pre_pool`` equal to H and W
    over the patch size); otherwise the full-resolution fused map, after
    the head's own average pool down to ``detection_pre_pool`` (windows of
    H // S, 'VALID') where that is set and smaller than H."""
    p, s = a["patch_size"], a.get("detection_pre_pool")
    if s is not None and h > s and h % s == 0 and w % s == 0 and h // s == p and w // s == p:
        return h // p, w // p
    if s is not None and h > s:
        sh, sw = max(1, h // s), max(1, w // s)
        return h // sh, w // sw
    return h, w


def pipeline_forward_flops(h: int, w: int, a: dict) -> float:
    """One image of the MinGraph-UNet forward (one GAT layer a stage): the
    U-Net, the Sobel conv's two 3×3 filters, the patch projections, the
    lattice GATs (projection, both attention scores, the 4-neighbour
    aggregation), the segment pooling and gathering as one-hot products,
    the region GAT, and the detection head's convs where they run
    (:func:`detection_head_hw`) and its dense layers. Average pools and
    means are not counted."""
    p, init, heads = a["patch_size"], a["init_features"], a["gat_num_heads"]
    d_in, d_out, k = a["unet_patch_feature_dim"] + 4, a["gat_output_dim"], a["num_segments"]
    n = (h // p) * (w // p)

    def gat(nodes: int, din: int, dout: int, nh: int, neighbours: int) -> float:
        return 2.0 * nodes * nh * (din * dout + 2 * dout + neighbours * dout)

    c = init + d_out
    fc = a["fc_hidden_dim"]
    hh, wh = detection_head_hw(h, w, a)
    return (unet_forward_flops(h, w, a.get("in_channels", 3), a["num_classes"], init, a["depth"])
            + conv_flops(h, w, 3, 1, 2)
            + 2.0 * n * init * a["unet_patch_feature_dim"] + 2.0 * n * init * d_out
            + gat(n, d_in, d_out, heads, 4) + gat(n, d_out, k, max(1, heads // 2), 4)
            + 2 * 2.0 * n * k * d_out + gat(k, d_out, d_out, heads, k - 1)
            + conv_flops(hh, wh, 3, c, c // 2) + conv_flops(hh, wh, 3, c // 2, c // 4)
            + 2.0 * (c // 4 * fc + fc * fc // 2 + fc // 2 * 5))


def forward_flops(config: dict, h: int, w: int) -> float:
    if config["model"] == "MinGraphUNet":
        return pipeline_forward_flops(h, w, config["args"])
    u = config["pipeline"]["model"]["unet"]
    return unet_forward_flops(h, w, u["in_channels"], u["out_channels"], u["init_features"], u["depth"])

