"""Segmentation test-set evaluation (Table 1). Counterpart of
``mingraph_unet_tpu/experiments/segmentation_performance.py``.

Evaluates trained weights on the test split (else val, else train),
accumulates the flat label arrays, computes the reference-exact metrics and
prints the mango-class (index 1) and macro rows in Table-1 format. Model
types: ``unet``, ``mingraph-unet`` and ``mingraph-unet-refined`` (the
MinGraph-UNet's logits blended with their MinCut region's mean,
:func:`region_blend_logits`). Weights are the port's checkpoints
(``train/checkpoint.py``, read by ``train/infer.py::load_variables``); a
JAX checkpoint comes in through ``convert.py``. Runs on the CUDA card
unless ``device="cpu"`` is passed; :func:`main` (``python -m
mingraph_unet_tpu_torch.experiments.segmentation_performance``) unless
``--cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.data.dataset import BatchLoader, MangoDataset, device_preprocess_batch
from mingraph_unet_tpu_torch.experiments.metrics import segmentation_metrics
from mingraph_unet_tpu_torch.utils.env import setup_host

__all__ = ["main", "MODEL_TYPES", "build_eval_model", "eval_forward", "evaluate_segmentation_model", "print_table1",
           "region_blend_logits", "segmentation_logits"]

Device = Optional[Union[str, torch.device]]

MODEL_TYPES = ("unet", "mingraph-unet", "mingraph-unet-refined")


def region_blend_logits(logits: torch.Tensor, patch_labels: torch.Tensor, patch: int, num_regions: int,
                        gamma: float = 0.5, purity_tau: Optional[float] = None) -> torch.Tensor:
    """Graph-refined logits: each pixel's logits (B, H, W, C) blended with
    the mean logits of its MinCut region, ``(1 − γ)·logits +
    γ·region_mean[region(pixel)]``; ``patch_labels`` (B, H/patch, W/patch)
    are the region ids of the patches. With ``purity_tau`` only the regions
    whose foreground probability has a variance below it blend; the others
    keep their logits."""
    b, h, w, c = logits.shape
    logits = logits.float()
    pix = patch_labels.long().repeat_interleave(patch, 1).repeat_interleave(patch, 2).reshape(b, h * w)
    # One-hot products, as in JAX: on the card a matmul sums in a fixed
    # order (an atomic scatter would not), so the blend is deterministic.
    onehot = torch.nn.functional.one_hot(pix, num_regions).float()  # (B, HW, S)
    flat = logits.reshape(b, h * w, c)

    def region_sum(v: torch.Tensor) -> torch.Tensor:  # (B, HW, K) → (B, S, K)
        return onehot.transpose(1, 2) @ v

    def at_pixels(v: torch.Tensor) -> torch.Tensor:  # (B, S, K) → (B, H, W, K)
        return (onehot @ v).reshape(b, h, w, v.shape[-1])

    counts = torch.clamp(region_sum(torch.ones_like(flat[..., :1])), min=1.0)
    blended = (1.0 - gamma) * logits + gamma * at_pixels(region_sum(flat) / counts)
    if purity_tau is None:
        return blended
    p_fg = torch.softmax(flat, dim=-1)[..., 1:2]
    mean_p = region_sum(p_fg) / counts
    var = torch.clamp(region_sum(p_fg * p_fg) / counts - mean_p * mean_p, min=0.0)
    gate = at_pixels((var < purity_tau).float())
    return gate * blended + (1.0 - gate) * logits


def build_eval_model(cfg: PipelineConfig, model_type: str, weights: Dict[str, torch.Tensor], device: Device = None):
    """The ``model_type`` model of ``cfg`` (the U-Net of
    ``train/segmentation.py::build_unet`` or the MinGraph-UNet of
    ``train/end_to_end.py::build_mingraph_unet``) with ``weights``, in eval
    mode."""
    from mingraph_unet_tpu_torch.train.end_to_end import build_mingraph_unet
    from mingraph_unet_tpu_torch.train.segmentation import build_unet

    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {model_type!r} is not implemented (choices: {', '.join(MODEL_TYPES)})")
    model = build_unet(cfg, device) if model_type == "unet" else build_mingraph_unet(cfg, device)
    model.load_state_dict(weights)
    return model.eval()


@torch.no_grad()
def eval_forward(model, cfg: PipelineConfig, images_u8: torch.Tensor) -> Dict[str, Any]:
    """The eval-mode ``model``'s outputs on uint8 images (B, H, W, 3) on its
    device, normalized as the trainers normalize them."""
    pre = cfg.preprocessing
    zeros = torch.zeros(images_u8.shape[:3], dtype=torch.long, device=images_u8.device)
    imgs, _ = device_preprocess_batch(images_u8, zeros, pre.normalization_mean, pre.normalization_std)
    return model(imgs)


@torch.no_grad()
def segmentation_logits(model, cfg: PipelineConfig, images_u8: torch.Tensor, model_type: str,
                        blend_gamma: float = 0.5, blend_purity_tau: Optional[float] = None) -> torch.Tensor:
    """The device work of one evaluation batch: :func:`eval_forward` of the
    ``model_type`` model → (B, H, W, C) logits (for
    ``mingraph-unet-refined`` f32 and region-blended)."""
    out = eval_forward(model, cfg, images_u8)
    if model_type != "mingraph-unet-refined":
        return out["logits"]
    return region_blend_logits(out["logits"].float(), out["hard_patch_labels"], cfg.model.graph_construction.patch_size,
                               cfg.dataset.num_semantic_regions, gamma=blend_gamma, purity_tau=blend_purity_tau)


def _find_split_dir(cfg: PipelineConfig, data_root: str) -> str:
    test_dir = os.path.join(data_root, cfg.dataset.test_dir)
    if os.path.isdir(os.path.join(test_dir, cfg.dataset.image_folder)):
        return test_dir
    val_dir = os.path.join(data_root, cfg.dataset.val_dir)
    if os.path.isdir(os.path.join(val_dir, cfg.dataset.image_folder)):
        print(f"[eval] test split missing; falling back to val ({val_dir})")
        return val_dir
    train_dir = os.path.join(data_root, cfg.dataset.train_dir)
    print(f"[eval] test/val splits missing; falling back to train ({train_dir})")
    return train_dir


def evaluate_segmentation_model(
    config_dir: str,
    weights_path: str,
    model_type: str = "unet",
    batch_size: int = 8,
    data_root_override: Optional[str] = None,
    blend_gamma: float = 0.5,
    blend_purity_tau: Optional[float] = None,
    device: Device = None,
) -> Dict[str, Any]:
    """Table 1 for the newest checkpoint under ``weights_path``: the
    argmax of ``model_type``'s logits against the split's masks; prints the
    table and returns ``experiments/metrics.py::segmentation_metrics``."""
    from mingraph_unet_tpu_torch.train.infer import load_variables

    cfg = PipelineConfig.from_config_dir(config_dir)
    model_type = model_type.lower().replace("_", "-")
    if model_type not in MODEL_TYPES:
        raise NotImplementedError(f"model_type {model_type!r} is not implemented (choices: {', '.join(MODEL_TYPES)})")
    model = build_eval_model(cfg, model_type, load_variables(weights_path), device)
    dev = next(model.parameters()).device
    pre = cfg.preprocessing
    data_root = data_root_override or cfg.dataset.data_root
    split_dir = _find_split_dir(cfg, data_root)
    dataset = MangoDataset(
        image_dir=os.path.join(split_dir, cfg.dataset.image_folder),
        mask_dir=os.path.join(split_dir, cfg.dataset.mask_folder),
        image_size=pre.resize_dim,
        num_classes=cfg.model.unet.out_channels,
    )
    trues, preds = [], []
    for imgs_np, masks_np in BatchLoader(dataset, batch_size, shuffle=False, drop_last=False).epoch(0):
        logits = segmentation_logits(model, cfg, torch.from_numpy(imgs_np).to(dev), model_type, blend_gamma,
                                     blend_purity_tau)
        preds.append(logits.argmax(-1).cpu().numpy().reshape(-1))
        trues.append(masks_np.reshape(-1))
    results = segmentation_metrics(np.concatenate(trues), np.concatenate(preds), cfg.model.unet.out_channels)
    print_table1(results, model_type)
    return results


def print_table1(results: Dict[str, Any], model_name: str, mango_class: int = 1) -> None:
    """The Table-1 printout: IoU, precision, recall and F1 of the mango class
    and their macro averages."""
    print(f"\n--- Segmentation Performance ({model_name}) ---")
    print(f"{'Metric':<12} {'Mango (cls 1)':>14} {'Macro avg':>12}")
    rows = [("IoU", "iou_per_class", "mean_iou"), ("Precision", "precision_per_class", "mean_precision"),
            ("Recall", "recall_per_class", "mean_recall"), ("F1", "f1_per_class", "mean_f1")]
    for name, per_class_key, mean_key in rows:
        per_class = results[per_class_key]
        mango = per_class[mango_class] if len(per_class) > mango_class else float("nan")
        print(f"{name:<12} {mango:>14.4f} {results[mean_key]:>12.4f}")


def main(argv=None):
    """The JAX module's CLI: Table 1 for ``--weights_path``. Returns the
    metrics."""
    parser = argparse.ArgumentParser(description="Evaluate segmentation performance")
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--weights_path", required=True)
    parser.add_argument("--model_type", default="unet")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = setup_host(force_cpu=args.cpu)
    return evaluate_segmentation_model(args.config_path, args.weights_path, args.model_type, args.batch_size,
                                       device=device)


if __name__ == "__main__":
    main()
