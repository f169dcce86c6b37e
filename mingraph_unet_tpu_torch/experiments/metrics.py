"""Segmentation metrics with the reference's formulas: the port's own copy
of ``confusion_matrix`` and ``segmentation_metrics`` from
``mingraph_unet_tpu/experiments/metrics.py`` (full-class confusion matrix by
a fixed-bin bincount; per-class and macro IoU, precision, recall and F1
with smoothing 1e-6). The detection and yield metrics are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["confusion_matrix", "segmentation_metrics"]

SMOOTH = 1e-6


def confusion_matrix(true_flat: np.ndarray, pred_flat: np.ndarray, num_classes: int) -> np.ndarray:
    """(C, C) matrix with rows = true class, cols = predicted class, all
    classes represented (sklearn ``labels=range(C)`` semantics)."""
    true_flat = np.asarray(true_flat).reshape(-1).astype(np.int64)
    pred_flat = np.asarray(pred_flat).reshape(-1).astype(np.int64)
    valid = (true_flat >= 0) & (true_flat < num_classes) & (pred_flat >= 0) & (pred_flat < num_classes)
    idx = true_flat[valid] * num_classes + pred_flat[valid]
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def segmentation_metrics(
    true_masks_flat, pred_masks_flat, num_classes: int, smooth: float = SMOOTH
) -> Dict[str, Any]:
    cm = confusion_matrix(true_masks_flat, pred_masks_flat, num_classes)
    iou_pc, prec_pc, rec_pc, f1_pc = [], [], [], []
    for c in range(num_classes):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        iou = (tp + smooth) / (tp + fp + fn + smooth)
        precision = (tp + smooth) / (tp + fp + smooth)
        recall = (tp + smooth) / (tp + fn + smooth)
        f1 = (2 * precision * recall + smooth) / (precision + recall + smooth)
        iou_pc.append(iou)
        prec_pc.append(precision)
        rec_pc.append(recall)
        f1_pc.append(f1)
    return {
        "iou_per_class": iou_pc,
        "precision_per_class": prec_pc,
        "recall_per_class": rec_pc,
        "f1_per_class": f1_pc,
        "mean_iou": float(np.nanmean(iou_pc)),
        "mean_precision": float(np.nanmean(prec_pc)),
        "mean_recall": float(np.nanmean(rec_pc)),
        "mean_f1": float(np.nanmean(f1_pc)),
        "confusion_matrix": cm,
    }

