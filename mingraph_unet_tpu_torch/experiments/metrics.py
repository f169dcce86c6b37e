"""Evaluation metrics with the reference's formulas: the port's own copy of
``mingraph_unet_tpu/experiments/metrics.py`` (host numpy).

- Segmentation: ``confusion_matrix`` (a fixed-bin bincount over every
  class) and ``segmentation_metrics`` (per-class and macro IoU, precision,
  recall and F1 with smoothing 1e-6).
- Detection: ``calculate_iou``, ``object_detection_map`` (the reference's
  "(P + R) / 2" score) and ``average_precision`` (101-point interpolated
  AP), over greedy confidence-ranked matching.
- Yield: ``yield_estimation_metrics`` (count accuracy, MAPE, object
  matching rate, occlusion robustness).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["average_precision", "calculate_iou", "confusion_matrix", "object_detection_map", "segmentation_metrics",
           "yield_estimation_metrics"]

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


def calculate_iou(box1: Sequence[float], box2: Sequence[float]) -> float:
    """IoU of two [xmin, ymin, xmax, ymax] boxes."""
    x1 = max(box1[0], box2[0])
    y1 = max(box1[1], box2[1])
    x2 = min(box1[2], box2[2])
    y2 = min(box1[3], box2[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    if inter == 0:
        return 0.0
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    return inter / (a1 + a2 - inter)


def _greedy_match(gt_boxes: List[dict], pred_boxes: List[dict], iou_threshold: float):
    """Greedy confidence-sorted matching; yields (pred, matched_gt_idx|None)."""
    used = [False] * len(gt_boxes)
    for pred in sorted(pred_boxes, key=lambda p: p.get("confidence", 1.0), reverse=True):
        best_iou, best_idx = 0.0, None
        for gi, gt in enumerate(gt_boxes):
            if used[gi] or gt.get("class_id", 0) != pred.get("class_id", 0):
                continue
            iou = calculate_iou(pred["bbox"], gt["bbox"])
            if iou > best_iou:
                best_iou, best_idx = iou, gi
        if best_idx is not None and best_iou >= iou_threshold:
            used[best_idx] = True
            yield pred, best_idx
        else:
            yield pred, None


def object_detection_map(
    gt_boxes_list: List[List[dict]],
    pred_boxes_list: List[List[dict]],
    iou_threshold: float = 0.5,
    num_classes: int = 1,
) -> float:
    """The reference's placeholder detection score, (precision + recall) / 2
    over greedy matches. :func:`average_precision` is the real AP."""
    tp = fp = 0
    num_gt = 0
    for gt_img, pred_img in zip(gt_boxes_list, pred_boxes_list):
        num_gt += len(gt_img)
        for _, match in _greedy_match(gt_img, pred_img, iou_threshold):
            if match is not None:
                tp += 1
            else:
                fp += 1
    precision = tp / (tp + fp + SMOOTH) if (tp + fp) > 0 else 0.0
    recall = tp / (num_gt + SMOOTH) if num_gt > 0 else 0.0
    return (precision + recall) / 2 if (precision + recall) > 0 else 0.0


def average_precision(
    gt_boxes_list: List[List[dict]],
    pred_boxes_list: List[List[dict]],
    iou_threshold: float = 0.5,
) -> float:
    """Single-class AP@τ: the area under the 101-point interpolated
    precision-recall curve of all predictions ranked by confidence."""
    records = []  # (confidence, is_tp)
    num_gt = 0
    for gt_img, pred_img in zip(gt_boxes_list, pred_boxes_list):
        num_gt += len(gt_img)
        for pred, match in _greedy_match(gt_img, pred_img, iou_threshold):
            records.append((pred.get("confidence", 1.0), match is not None))
    if num_gt == 0 or not records:
        return 0.0
    records.sort(key=lambda r: r[0], reverse=True)
    tps = np.cumsum([1 if t else 0 for _, t in records])
    fps = np.cumsum([0 if t else 1 for _, t in records])
    recalls = tps / num_gt
    precisions = tps / np.maximum(tps + fps, 1)
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        mask = recalls >= r
        ap += precisions[mask].max() if mask.any() else 0.0
    return float(ap / 101)


def yield_estimation_metrics(
    gt_counts: Sequence[float],
    pred_counts: Sequence[float],
    gt_objects_list: Optional[List[List[dict]]] = None,
    pred_objects_list: Optional[List[List[dict]]] = None,
    matching_iou_thresh: float = 0.5,
) -> Dict[str, float]:
    gt_counts = np.asarray(gt_counts, dtype=np.float64)
    pred_counts = np.asarray(pred_counts, dtype=np.float64)

    count_accuracy = (
        1.0 - np.abs(pred_counts.sum() - gt_counts.sum()) / (gt_counts.sum() + SMOOTH)
    ) * 100.0

    valid = gt_counts > 0
    if np.any(valid):
        mape = float(
            np.mean(np.abs((gt_counts[valid] - pred_counts[valid]) / gt_counts[valid])) * 100.0
        )
    else:
        mape = 0.0 if np.sum(np.abs(gt_counts - pred_counts)) == 0 else float("inf")

    obj_matching_rate = -1.0
    occlusion_robustness = -1.0
    if gt_objects_list and pred_objects_list:
        total_gt = matched_gt = total_occ = matched_occ = 0
        for gt_img, pred_img in zip(gt_objects_list, pred_objects_list):
            total_gt += len(gt_img)
            total_occ += sum(1 for o in gt_img if o.get("occluded", False))
            for _, match in _greedy_match(gt_img, pred_img, matching_iou_thresh):
                if match is not None:
                    matched_gt += 1
                    if gt_img[match].get("occluded", False):
                        matched_occ += 1
        obj_matching_rate = matched_gt / (total_gt + SMOOTH) * 100.0
        occlusion_robustness = (
            matched_occ / (total_occ + SMOOTH) * 100.0 if total_occ > 0 else -1.0
        )

    return {
        "count_accuracy_perc": float(count_accuracy),
        "yield_estimation_error_perc": float(mape),
        "object_matching_rate_perc": float(obj_matching_rate),
        "occlusion_robustness_perc": float(occlusion_robustness),
        "total_gt_count_sum": float(gt_counts.sum()),
        "total_pred_count_sum": float(pred_counts.sum()),
    }
