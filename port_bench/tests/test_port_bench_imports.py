"""What the harness loads: never JAX or the JAX package, compared by whole
top-level module name (the port's name begins with the JAX package's),
and the reference nothing of the port either."""

import json
import subprocess
import sys

from port_bench.core import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mingraph_unet_tpu"}


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    mods = _top_level("import port_bench.run, port_bench.reference.model, port_bench.reference.train")
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    mods = _top_level("import port_bench.reference.model, port_bench.reference.train")
    assert "mingraph_unet_tpu_torch" not in mods and not mods & FORBIDDEN


def test_a_whole_run_loads_no_jax(tmp_path):
    code = ("from pathlib import Path\nfrom port_bench import run\nfrom port_bench.tests.tiny import tiny_root\n"
            f"root = tiny_root(Path({str(tmp_path)!r}))\n"
            "assert run.main(['--workload', 'unet_f32.infer_b16', '--seed', '7', '--seconds', '0.2'], root=root,"
            " device='cpu') == 0")
    mods = _top_level(code)
    assert "mingraph_unet_tpu_torch" in mods and not mods & FORBIDDEN


def test_the_prefix_is_not_the_package():
    assert "mingraph_unet_tpu_torch".split(".")[0] not in FORBIDDEN
