"""A copy of the benchmark's tree at sizes a CPU test can hold: the same
cells, configurations with fewer channels and levels, small tiles."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from port_bench.core import ROOT, read_json

TINY_ARGS = {"init_features": 8, "depth": 2, "gat_hidden_dim": 16, "gat_output_dim": 16, "gat_num_heads": 2,
             "fc_hidden_dim": 32, "detection_pre_pool": 4}
TINY_UNET = {"init_features": 4, "depth": 2}
TINY_SIZE = {"tiles_b64": (4, 64), "infer_b16": (2, 32), "train_b16": (4, 32)}


def tiny_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and the cells' data files, shrunk."""
    bench = read_json(ROOT / "BENCHMARK.json")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    src = ROOT / "port_bench"
    for sub in ("configs", "traffic", "limits"):
        (tmp / "port_bench" / sub).mkdir(parents=True, exist_ok=True)
    for conf in bench["configs"]:
        c = read_json(ROOT / conf["file"])
        if c["model"] == "MinGraphUNet":
            c["args"].update(TINY_ARGS)
        else:
            c = copy.deepcopy(c)
            c["pipeline"]["model"]["unet"].update(TINY_UNET)
        (tmp / conf["file"]).write_text(json.dumps(c))
    for w in bench["workloads"]:
        t = read_json(src / "traffic" / f"{w['traffic']}.json")
        b, hw = TINY_SIZE[w["traffic"]]
        t.update(batch=b, height=hw, width=hw, pool=min(t["pool"], 4), issue_steps=2, trace_steps=2)
        if "check" in t:
            t["check"] = {"sample": 2, "within": 4}
        (tmp / "port_bench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        (tmp / "port_bench" / "limits" / f"{w['name']}.json").write_text(
            (src / "limits" / f"{w['name']}.json").read_text())
    return tmp
