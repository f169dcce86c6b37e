"""A copy of the benchmark's tree at sizes a CPU test can hold: the same
cells, configurations with fewer channels and levels, small tiles.

Each configuration and each traffic mix brings its CPU test size as files
of its own under ``port_bench/tiny/``, found by name:

- ``tiny/configs/<config>.json``: ``overrides``, a map from a key path of
  the configuration file (``args``, ``pipeline.model.unet``; dots between
  keys) to the values that replace those under it;
- ``tiny/traffic/<mix>.json``: ``batch``, ``height`` and ``width``, and
  optionally ``pool``, ``issue_steps``, ``trace_steps`` and ``check``, which
  otherwise take :data:`STEPS`, at most :data:`POOL` batches and
  :data:`CHECK` (the last where the mix has a check).

A new cell needs no edit here: its files are all that :func:`tiny_root`
reads besides ``BENCHMARK.json`` and the cell's own full-size files.
"""

from __future__ import annotations

import json
from pathlib import Path

from port_bench.core import ROOT, read_json

POOL = 4
STEPS = {"issue_steps": 2, "trace_steps": 2}
CHECK = {"sample": 2, "within": 4}


def tiny_file(kind: str, name: str, src: Path = ROOT) -> dict:
    """``tiny/<kind>/<name>.json`` of the tree at ``src``."""
    path = src / "port_bench" / "tiny" / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: each configuration and traffic mix of BENCHMARK.json "
                                "brings its CPU test size under port_bench/tiny/")
    return read_json(path)


def __getattr__(name: str) -> dict:
    """``TINY_ARGS`` and ``TINY_UNET``: the overrides of ``mgu_bf16``'s
    ``args`` and ``unet_f32``'s U-Net, read from their tiny files when
    first asked for."""
    if name == "TINY_ARGS":
        return tiny_file("configs", "mgu_bf16")["overrides"]["args"]
    if name == "TINY_UNET":
        return tiny_file("configs", "unet_f32")["overrides"]["pipeline.model.unet"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def tiny_root(tmp: Path, src: Path = ROOT) -> Path:
    """``tmp`` holding the ``BENCHMARK.json`` of the tree at ``src`` and its
    cells' data files, shrunk by their tiny files."""
    bench = read_json(src / "BENCHMARK.json")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "traffic", "limits"):
        (tmp / "port_bench" / sub).mkdir(parents=True, exist_ok=True)
    for conf in bench["configs"]:
        c = read_json(src / conf["file"])
        for path, values in tiny_file("configs", conf["name"], src)["overrides"].items():
            node = c
            for key in path.split("."):
                node = node[key]
            node.update(values)
        (tmp / conf["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp / conf["file"]).write_text(json.dumps(c))
    for w in bench["workloads"]:
        t = read_json(src / "port_bench" / "traffic" / f"{w['traffic']}.json")
        t.update(pool=min(t["pool"], POOL), **STEPS)
        if "check" in t:
            t["check"] = dict(CHECK)
        t.update(tiny_file("traffic", w["traffic"], src))
        (tmp / "port_bench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        (tmp / "port_bench" / "limits" / f"{w['name']}.json").write_text(
            (src / "port_bench" / "limits" / f"{w['name']}.json").read_text())
    return tmp
