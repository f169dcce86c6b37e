"""A cell is its own files: every cell of ``BENCHMARK.json`` brings each
file the harness and its CPU tests look for, and a cell that exists nowhere
in the repository runs sound, and fails under a planted fault, from files
added beside the others alone."""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench import core, faults, run
from port_bench.tests.tiny import tiny_root

BENCH = core.read_json(core.ROOT / "BENCHMARK.json")
CELLS = tuple(w["name"] for w in BENCH["workloads"])
SEED = 2_200_000_033


def missing_files(root: Path, cell: str) -> list:
    """What ``cell`` of the tree at ``root`` lacks: its configuration,
    traffic, limits and tiny files, its driver, the reader of each metric
    that names it, and each end-to-end metric's arithmetic in ``run.py``."""
    bench = core.read_json(root / "BENCHMARK.json")
    w = {x["name"]: x for x in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / "port_bench"
    paths = [root / conf["file"], base / "traffic" / f"{w['traffic']}.json", base / "limits" / f"{cell}.json",
             base / "tiny" / "configs" / f"{w['config']}.json", base / "tiny" / "traffic" / f"{w['traffic']}.json"]
    if paths[1].is_file():
        paths.append(core.PACKAGE_DIR / "drivers" / f"{core.read_json(paths[1])['entry']}.py")
    paths += [core.PACKAGE_DIR / "metrics" / f"{m['name']}.py" for m in bench["per_layer"]
              if cell in m.get("workloads", [cell])]
    missing = [str(p) for p in paths if not p.is_file()]
    window = run.Window(units=1, seconds=1.0, latencies_s=[0.5])
    unit = SimpleNamespace(pixels_per_unit=1, images_per_unit=1)
    for m in bench["end_to_end"]:
        if cell in m.get("workloads", [cell]):
            try:
                run.end_to_end(m["name"], window, unit, 1.0)
            except KeyError:
                missing.append(f"run.end_to_end({m['name']!r})")
    return missing


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_brings_its_files(cell):
    assert missing_files(core.ROOT, cell) == []


def test_a_missing_tiny_file_is_named(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(core.PACKAGE_DIR, src / "port_bench", ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", src)
    gone = src / "port_bench" / "tiny" / "traffic" / "tiles_b64.json"
    gone.unlink()
    assert missing_files(src, "mgu_bf16.tiles_b64") == [str(gone)]
    with pytest.raises(FileNotFoundError, match="tiles_b64.json is missing: each configuration and traffic mix"):
        tiny_root(tmp_path / "tiny", src=src)


# The tiny tree as it was written before the sizes were files of their own.
BEFORE_ARGS = {"init_features": 8, "depth": 2, "gat_hidden_dim": 16, "gat_output_dim": 16, "gat_num_heads": 2,
               "fc_hidden_dim": 32, "detection_pre_pool": 4}
BEFORE_UNET = {"init_features": 4, "depth": 2}
BEFORE_SIZE = {"tiles_b64": (4, 64), "infer_b16": (2, 32), "train_b16": (4, 32)}


@pytest.mark.parametrize("cell", ["mgu_bf16.tiles_b64", "unet_f32.train_b16", "unet_f32.infer_b16"])
def test_the_tiny_tree_of_the_first_cells_is_unchanged(tmp_path, cell):
    root = tiny_root(tmp_path)
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    c = core.read_json(core.ROOT / conf["file"])
    if c["model"] == "MinGraphUNet":
        c["args"].update(BEFORE_ARGS)
    else:
        c["pipeline"]["model"]["unet"].update(BEFORE_UNET)
    t = core.read_json(core.PACKAGE_DIR / "traffic" / f"{w['traffic']}.json")
    b, hw = BEFORE_SIZE[w["traffic"]]
    t.update(batch=b, height=hw, width=hw, pool=min(t["pool"], 4), issue_steps=2, trace_steps=2)
    if "check" in t:
        t["check"] = {"sample": 2, "within": 4}
    assert (root / conf["file"]).read_text() == json.dumps(c)
    assert (root / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text() == json.dumps(t)
    assert (root / "port_bench" / "limits" / f"{cell}.json").read_text() == \
        (core.PACKAGE_DIR / "limits" / f"{cell}.json").read_text()


# A cell that exists nowhere in the repository: an existing configuration
# under a new mix, with its own traffic, limits and tiny files.
NEW = {
    "serve": {"like": "unet_f32.infer_b16",
              "traffic": {"batch": 4, "warmup": 2, "check": {"sample": 2, "within": 24}},
              "tiny": {"batch": 3, "height": 32, "width": 32, "check": {"sample": 1, "within": 3}}},
    "train": {"like": "unet_f32.train_b16", "traffic": {"batch": 8, "pool": 3, "checked": 2},
              "tiny": {"batch": 2, "height": 32, "width": 32, "pool": 2}},
}


def _add_cell(repo: Path, entry: str) -> str:
    """Copy the benchmark's data files into ``repo`` and add one cell there."""
    shutil.copytree(core.PACKAGE_DIR, repo / "port_bench", ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    bench = core.read_json(core.ROOT / "BENCHMARK.json")
    like = {w["name"]: w for w in bench["workloads"]}[NEW[entry]["like"]]
    mix = f"new_{entry}"
    name = f"{like['config']}.{mix}"
    base = repo / "port_bench"
    traffic = core.read_json(base / "traffic" / f"{like['traffic']}.json")
    traffic.update(NEW[entry]["traffic"])
    (base / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    (base / "tiny" / "traffic" / f"{mix}.json").write_text(json.dumps(NEW[entry]["tiny"]))
    shutil.copy(base / "limits" / f"{like['name']}.json", base / "limits" / f"{name}.json")
    bench["workloads"].append({**like, "name": name, "traffic": mix, "why": f"a new {entry} mix"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like["name"] in m.get("workloads", []):
            m["workloads"].append(name)
    (repo / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return name


@pytest.mark.parametrize("entry", sorted(NEW))
def test_a_new_cell_runs_from_its_own_files(tmp_path, entry, capsys):
    name = _add_cell(tmp_path / "repo", entry)
    assert name not in CELLS and not (core.PACKAGE_DIR / "limits" / f"{name}.json").exists()
    assert missing_files(tmp_path / "repo", name) == []
    root = tiny_root(tmp_path / "tiny", src=tmp_path / "repo")
    cell = core.load_cell(name, root)
    assert cell.traffic["batch"] == NEW[entry]["tiny"]["batch"] and cell.config["precision"] == "float32"
    argv = ["--workload", name, "--seed", str(SEED), "--seconds", "0.3", "--trace", "0"]
    assert run.main(argv, root=root, device="cpu") == 0
    results = [json.loads(capsys.readouterr().out.strip().splitlines()[-1])]
    planted = []
    try:
        assert run.main(argv, root=root, device="cpu",
                        hooks=lambda d: (faults.plant(d, faults.FAULTS[entry][0]), planted.append(d))) == 0
    finally:
        for d in planted:
            faults.lift(d)
    results.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    sound, broken = results
    assert sound["correct"] is True, sound["checks"]
    assert set(sound["metrics"]) == {m["name"] for m in cell.end_to_end} and "setup_s" in sound["metrics"]
    assert broken["correct"] is False, broken["checks"]
