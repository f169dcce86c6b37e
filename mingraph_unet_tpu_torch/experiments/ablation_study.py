"""Ablation study harness (Table 3). Counterpart of
``mingraph_unet_tpu/experiments/ablation_study.py``.

Maps the paper's Table-3 variant names to ablated architectures (stage
switches of ``MinGraphUNet``) and evaluates each with the yield harness.
The mapping, as in the JAX package:

- "Min-Cut Only"            — partition without GAT refinement:
                              patch_gat=off, partition=on, region_gat=off
- "Graph U-Net Only"        — U-Net + patch GAT, no partition/region stages:
                              patch_gat=on, partition=off
- "Graph Construction"      — raw patch-graph features fused, no message
                              passing or partition: all graph stages off
- "Graph Traversal"         — GAT + partition without the region GAT:
                              patch_gat=on, partition=on, region_gat=off
- "Combined (Full Method)"  — the full MinGraph-UNet (all stages on)

Missing weights are reported as such; the reference's mock numbers
(``U(80, 95)`` / ``U(5, 15)``) come only with ``allow_mock=True`` and carry
``"mocked": True``. :func:`run_ablation_study_trained` trains every variant
on a synthetic annotated dataset and evaluates it: no mock anywhere. Runs
on the CUDA card unless ``device="cpu"`` is passed; :func:`main` (``python
-m mingraph_unet_tpu_torch.experiments.ablation_study``) unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from mingraph_unet_tpu_torch.config import load_yaml, write_yaml
from mingraph_unet_tpu_torch.experiments.yield_estimation_performance import evaluate_yield_model
from mingraph_unet_tpu_torch.utils.env import setup_host

__all__ = [
    "ABLATION_VARIANTS",
    "VARIANT_TOGGLES",
    "apply_variant",
    "run_ablation_experiment",
    "run_ablation_study",
    "run_ablation_study_trained",
    "main",
]

ABLATION_VARIANTS: Dict[str, str] = {
    "Min-Cut Only": "mincut_only",
    "Graph U-Net Only": "graph_unet_only",
    "Graph Construction": "graph_construction",
    "Graph Traversal": "graph_traversal",
    "Combined (Full Method)": "combined",
}

Device = Optional[Union[str, torch.device]]

# Stage switches per variant slug (see the module docstring).
VARIANT_TOGGLES: Dict[str, Dict[str, bool]] = {
    "mincut_only": {"use_patch_gat": False, "use_partition": True, "use_region_gat": False},
    "graph_unet_only": {"use_patch_gat": True, "use_partition": False, "use_region_gat": False},
    "graph_construction": {
        "use_patch_gat": False,
        "use_partition": False,
        "use_region_gat": False,
    },
    "graph_traversal": {"use_patch_gat": True, "use_partition": True, "use_region_gat": False},
    "combined": {"use_patch_gat": True, "use_partition": True, "use_region_gat": True},
}


def apply_variant(cfg, variant_slug: str):
    """Return a copy of ``cfg`` with the variant's stage toggles applied to
    ``cfg.model.ablation`` (the config consumed by ``build_mingraph_unet``)."""
    toggles = VARIANT_TOGGLES[variant_slug]
    cfg = dataclasses.replace(cfg)
    cfg.model = dataclasses.replace(
        cfg.model, ablation=dataclasses.replace(cfg.model.ablation, **toggles)
    )
    return cfg


def run_ablation_experiment(
    variant_name: str,
    config_dir: Optional[str],
    weights_path: Optional[str],
    num_images: int = 8,
    allow_mock: bool = False,
    seed: int = 0,
    device: Device = None,
) -> Dict[str, float]:
    """One Table-3 row: the yield metrics of ``variant_name``'s weights, or
    with ``allow_mock`` and no weights the reference's labelled mock row."""
    if variant_name not in ABLATION_VARIANTS:
        raise ValueError(
            f"Unknown variant {variant_name!r}; choices: {list(ABLATION_VARIANTS)}"
        )
    have_weights = weights_path is not None and os.path.isdir(weights_path)
    if not have_weights:
        if not allow_mock:
            raise FileNotFoundError(
                f"No weights for variant {variant_name!r} at {weights_path!r}. "
                "Pass allow_mock=True for reference-style mock numbers."
            )
        rng = np.random.default_rng(seed + hash(variant_name) % 1000)
        return {
            "variant": variant_name,
            "count_accuracy_perc": float(rng.uniform(80, 95)),
            "yield_estimation_error_perc": float(rng.uniform(5, 15)),
            "mocked": True,
        }
    results = evaluate_yield_model(
        config_dir,
        weights_path,
        model_type="mingraph-unet",
        num_images=num_images,
        seed=seed,
        ablation=VARIANT_TOGGLES[ABLATION_VARIANTS[variant_name]],
        device=device,
    )
    return {"variant": variant_name, **results, "mocked": False}


def run_ablation_study(
    config_dir: Optional[str] = None,
    weights_root: Optional[str] = None,
    num_images: int = 8,
    allow_mock: bool = True,
    device: Device = None,
) -> List[Dict[str, float]]:
    """Run all Table-3 variants; weights expected under
    ``{weights_root}/{variant_slug}/``."""
    rows = []
    for name, slug in ABLATION_VARIANTS.items():
        weights = os.path.join(weights_root, slug) if weights_root else None
        try:
            rows.append(
                run_ablation_experiment(name, config_dir, weights, num_images, allow_mock, device=device)
            )
        except FileNotFoundError as e:
            print(f"[ablation] {name}: {e}")
    print("\n--- Ablation Study (Table-3 format) ---")
    print(f"{'Variant':<26} {'Count Acc. (%)':>15} {'Yield Err. (%)':>15} {'mocked':>8}")
    for r in rows:
        print(
            f"{r['variant']:<26} {r['count_accuracy_perc']:>15.2f} "
            f"{r['yield_estimation_error_perc']:>15.2f} {str(r.get('mocked', False)):>8}"
        )
    return rows


def _variant_config_dir(base_cfg_dir: str, out_dir: str, slug: str) -> str:
    """A copy of a config directory with the variant's ablation switches and
    its own checkpoint and log directories."""
    os.makedirs(out_dir, exist_ok=True)
    for name in ("dataset.yaml", "model.yaml", "preprocessing.yaml", "training.yaml"):
        data = load_yaml(os.path.join(base_cfg_dir, name))
        if name == "model.yaml":
            data["ablation"] = dict(VARIANT_TOGGLES[slug])
        if name == "training.yaml":
            root = os.path.dirname(out_dir)  # .../variants/<slug>
            data["checkpoint_dir"] = os.path.join(root, "checkpoints")
            data["log_dir"] = os.path.join(root, "logs")
        write_yaml(os.path.join(out_dir, name), data)
    return out_dir


def run_ablation_study_trained(
    base_dir: str,
    variants: Optional[List[str]] = None,
    num_images: int = 12,
    image_size=(64, 64),
    epochs: int = 3,
    eval_images: int = 8,
    device: Device = None,
) -> List[Dict[str, float]]:
    """The whole Table-3 loop: train each ablated architecture end to end on
    a dummy annotated dataset (``utils/bootstrap.py::make_dummy_run``), then
    evaluate its yield metrics on the annotated files."""
    from mingraph_unet_tpu_torch.train.end_to_end import train_end_to_end
    from mingraph_unet_tpu_torch.utils.bootstrap import make_dummy_run

    base_cfg = make_dummy_run(
        base_dir, num_images=num_images, image_size=image_size, batch_size=2,
        num_epochs=epochs, patch_size=16 if min(image_size) >= 64 else 8,
        init_features=8, depth=2, with_annotations=True,
    )
    data_root = os.path.join(base_dir, "data")
    img_dir = os.path.join(data_root, "train", "images")
    ann_file = os.path.join(data_root, "train", "annotations.json")
    rows = []
    for name, slug in ABLATION_VARIANTS.items():
        if variants is not None and slug not in variants:
            continue
        var_root = os.path.join(base_dir, "variants")
        cfg_dir = _variant_config_dir(base_cfg, os.path.join(var_root, slug, "configs"), slug)
        print(f"\n[ablation] training variant {name!r} ({slug})")
        train_end_to_end(cfg_dir, max_epochs=epochs, device=device)
        results = evaluate_yield_model(
            cfg_dir,
            os.path.join(var_root, slug, "checkpoints"),
            model_type="mingraph-unet",
            num_images=eval_images,
            ablation=VARIANT_TOGGLES[slug],
            image_dir=img_dir,
            ann_file=ann_file,
            device=device,
        )
        rows.append({"variant": name, **results, "mocked": False})
    print("\n--- Ablation Study, TRAINED variants (Table-3 format) ---")
    print(f"{'Variant':<26} {'Count Acc. (%)':>15} {'Yield Err. (%)':>15}")
    for r in rows:
        print(
            f"{r['variant']:<26} {r['count_accuracy_perc']:>15.2f} "
            f"{r['yield_estimation_error_perc']:>15.2f}"
        )
    return rows


def main(argv=None):
    """The JAX module's CLI: Table 3 from weights under ``--weights_root``
    (mock rows for missing ones unless ``--no_mock``), or with ``--train
    DIR`` every variant trained first. Returns the rows."""
    parser = argparse.ArgumentParser(description="Run the ablation study")
    parser.add_argument("--config_path", default=None)
    parser.add_argument("--weights_root", default=None)
    parser.add_argument("--num_images", type=int, default=8)
    parser.add_argument("--no_mock", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument(
        "--train", metavar="DIR", default=None,
        help="train every variant on a synthetic annotated dataset under DIR "
        "and produce a real Table 3 (no mocks)",
    )
    parser.add_argument("--epochs", type=int, default=3)
    args = parser.parse_args(argv)
    device = setup_host(force_cpu=args.cpu)
    if args.train:
        return run_ablation_study_trained(args.train, epochs=args.epochs, device=device)
    return run_ablation_study(args.config_path, args.weights_root, args.num_images, allow_mock=not args.no_mock,
                              device=device)


if __name__ == "__main__":
    main()
