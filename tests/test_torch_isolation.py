"""The port stands alone: importing mingraph_unet_tpu_torch and every module
in it (and the chip smoke script) loads neither JAX nor any module of the JAX
package ``mingraph_unet_tpu``, nor OpenCV or PyYAML (the card machine need
not have them; the port imports them only where it reads images or config
files), and loads no kernel library."""

import os
import pkgutil
import subprocess
import sys

import mingraph_unet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import mingraph_unet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # the card script imports only torch and the port
from mingraph_unet_tpu_torch.ops.kernels import build
assert build._loaded == {}, "importing the port loaded a kernel library"
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "flax", "mingraph_unet_tpu", "cv2", "yaml")
             or m.startswith(("jax.", "jaxlib.", "flax.", "mingraph_unet_tpu.", "cv2.", "yaml.")))
print(len(names), bad)
"""


# The data and evaluation modules and the command-line entry points, which
# the walk must reach.
DATA_AND_EVAL_MODULES = ("data.annotations", "data.synthetic", "data.native_loader", "data.raster", "data.collection",
                   "experiments.segmentation_performance", "experiments.yield_estimation_performance",
                   "experiments.ablation_study", "utils.bootstrap")
CLI_MODULES = ("data.png", "utils.env", "utils.profiling", "scripts.train_segmentation", "scripts.train_end_to_end",
               "scripts.infer_segmentation", "scripts.graph_refinement", "scripts.run_results",
               "scripts.run_value_study")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    walked = {m.name for m in pkgutil.walk_packages(mingraph_unet_tpu_torch.__path__, "mingraph_unet_tpu_torch.")}
    assert int(count) == len(walked) > 10
    assert {f"mingraph_unet_tpu_torch.{m}" for m in DATA_AND_EVAL_MODULES + CLI_MODULES} <= walked
    assert bad == "[]", f"the port pulled in {bad}"
