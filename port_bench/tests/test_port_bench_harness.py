"""The harness end to end on the CPU at a tiny size (the look for a card
skipped): a sound run, each fault planted under the timed path, and the
control in the program's place, each judged by the committed limits.
Every cell of ``BENCHMARK.json`` is covered by being listed there."""

import json
import math

import pytest
import torch

from port_bench import calibrate, core, faults, run
from port_bench.reference.numerics import Precision
from port_bench.tests.tiny import tiny_root

CELLS = tuple(w["name"] for w in core.read_json(core.ROOT / "BENCHMARK.json")["workloads"])
SEED = 3_000_000_019  # over 32 bits: a run may be given any seed up to a little over 2**31
# Precisions whose tiny model is held to the full-size limits: a bf16 model's
# rounding at a few channels is not the full model's.
HELD = ("float32",)


def kind(cell: str) -> str:
    """The cell's kind, as its driver module (``drivers/<entry>.py``) states it."""
    return core.driver_module(core.load_cell(cell).traffic["entry"]).Driver.kind


def held(cell: str) -> bool:
    return core.load_cell(cell).config["precision"] in HELD


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, capsys, trace=0, hooks=None):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5", "--trace", str(trace)], root=root,
                  device="cpu", hooks=hooks)
    out = capsys.readouterr()
    assert rc == 0, out.err
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    names = [line.split()[2] for line in out.err.strip().splitlines()[-len(result["checks"]):]]
    assert names == list(result["checks"])  # the last lines of stderr: each number beside its limit
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(root, cell, capsys):
    r = _run(root, cell, capsys)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(math.isfinite(c["value"]) for c in r["checks"].values())
    if held(cell):
        assert r["correct"], r["checks"]
    want = {m["name"] for m in core.load_cell(cell, root).end_to_end}
    assert set(r["metrics"]) == want


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_host_metrics(root, cell, capsys):
    r = _run(root, cell, capsys, trace=1)
    k = kind(cell)
    assert f"host.issue_ms.{k}" in r["metrics"] and f"step.mfu.{k}" in r["metrics"]
    assert "window_s" in r["device"] and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS[kind(c)]])
def test_a_planted_fault_is_not_correct(root, cell, fault, capsys):
    planted = []
    try:
        r = _run(root, cell, capsys, hooks=lambda d: (faults.plant(d, fault), planted.append(d)))
    finally:
        for d in planted:  # a patched class outlives the run
            faults.lift(d)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    c = core.load_cell(cell, root)
    row = calibrate.reading(c, SEED, "cpu", control=c.config["control"])
    assert any(v > c.limits[k] for k, v in row["numbers"].items()), row


@pytest.mark.parametrize("cell", [c for c in CELLS if "check" in core.load_cell(c).traffic])
def test_a_sampled_last_request_is_judged_on_its_own_outputs(root, cell):
    c = core.load_cell(cell, root)
    d = core.driver_module(c.traffic["entry"]).make(c.config, c.traffic, SEED, "cpu")
    d.setup()
    n = c.traffic["check"]["within"]
    d.sample = [0, n - 1]
    d.kept_bufs = {i: {k: torch.empty_like(v) for k, v in d.ring.items()} for i in d.sample}
    for i in range(n):
        d.wait(d.issue(i))
    d.end_window(n)
    got = d.program_outputs()
    d.free()
    numbers = d.compare(got, d.reference(Precision("f32"), got))
    assert all(v <= c.limits[k] or not held(cell) for k, v in numbers.items()), numbers
    assert numbers["logits"] < 0.1
