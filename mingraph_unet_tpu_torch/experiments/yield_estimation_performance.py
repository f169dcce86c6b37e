"""Yield estimation and counting evaluation (Table 2). Counterpart of
``mingraph_unet_tpu/experiments/yield_estimation_performance.py``.

- :class:`DummyYieldDataset` and :class:`MockDetector`: the reference's
  random images, counts and boxes and its random detections (schema
  placeholders, seeded numpy as in the JAX package).
- :class:`SegmentationCountDetector`: segmentation argmax → 4-connected
  components (``ops/cc.py``, exact forms) → instance boxes, each scored by
  its mean foreground probability; for ``unet``, ``mingraph-unet`` and
  ``mingraph-unet-refined`` (region-blended logits).
- :class:`DenseHeadDetector`: the dense head's cells decoded by top-k and
  NMS (``models/detection.py::decode_dense_detections``).

Each detector's device work is one function of ``(model, cfg, images_u8)``
(:func:`segmentation_count_detect`, :func:`dense_head_detect`), as the JAX
classes wrap one jitted ``detect``; the classes build the model from a
config directory and the port's checkpoint, and map boxes back to the
image's own size on the host. Runs on the CUDA card unless
``device="cpu"`` is passed; :func:`main` (``python -m
mingraph_unet_tpu_torch.experiments.yield_estimation_performance``)
unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.experiments.metrics import average_precision, yield_estimation_metrics
from mingraph_unet_tpu_torch.experiments.segmentation_performance import (build_eval_model, eval_forward,
                                                                         segmentation_logits)
from mingraph_unet_tpu_torch.ops import cc
from mingraph_unet_tpu_torch.utils.env import setup_host

__all__ = [
    "main",
    "DummyYieldDataset",
    "MockDetector",
    "SegmentationCountDetector",
    "DenseHeadDetector",
    "dense_head_detect",
    "evaluate_yield_model",
    "instances_from_logits",
    "segmentation_count_detect",
]

Device = Optional[Union[str, torch.device]]


class DummyYieldDataset:
    """Random images, counts and occlusion-flagged xyxy boxes: the yield
    ground truth's schema (seeded as in the JAX package)."""

    def __init__(self, num_images: int = 8, image_size: Tuple[int, int] = (128, 128), seed: int = 0):
        self.num_images = num_images
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)
        self._items = [self._make(i) for i in range(num_images)]

    def _make(self, idx):
        h, w = self.image_size
        img = self.rng.integers(0, 255, (h, w, 3), np.uint8)
        count = int(self.rng.integers(1, 8))
        objects = []
        for _ in range(count):
            x1 = int(self.rng.integers(0, w - 16))
            y1 = int(self.rng.integers(0, h - 16))
            bw = int(self.rng.integers(8, 16))
            bh = int(self.rng.integers(8, 16))
            objects.append({"bbox": [x1, y1, x1 + bw, y1 + bh], "class_id": 0,
                            "occluded": bool(self.rng.random() < 0.3)})
        return img, count, objects

    def __len__(self):
        return self.num_images

    def __getitem__(self, idx):
        return self._items[idx]


class MockDetector:
    """Random detections: the reference's schema placeholder."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray) -> List[dict]:
        h, w = image.shape[:2]
        n = int(self.rng.integers(0, 9))
        dets = []
        for _ in range(n):
            x1 = int(self.rng.integers(0, w - 10))
            y1 = int(self.rng.integers(0, h - 10))
            dets.append({"bbox": [x1, y1, x1 + int(self.rng.integers(8, 20)), y1 + int(self.rng.integers(8, 20))],
                         "class_id": 0, "confidence": float(self.rng.random())})
        return dets


@torch.no_grad()
def segmentation_count_detect(model, cfg: PipelineConfig, images_u8: torch.Tensor, model_type: str = "unet",
                              max_objects: int = 32, min_area: int = 10
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segmentation counting on uint8 images (B, H, W, 3) on the model's
    device: the argmax's foreground → connected components → the
    ``max_objects`` largest of at least ``min_area`` pixels. Returns xyxy
    boxes (B, K, 4), areas (B, K) (0 in an unused slot) and confidences
    (B, K), each instance's mean foreground probability."""
    logits = segmentation_logits(model, cfg, images_u8, model_type)
    return instances_from_logits(logits, max_objects, min_area)


@torch.no_grad()
def instances_from_logits(logits: torch.Tensor, max_objects: int = 32, min_area: int = 10
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The counting half of :func:`segmentation_count_detect`, from (B, H, W,
    C) logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    fg = (logits.argmax(-1) == 1).to(torch.int32)
    masks, areas = cc.top_instances(cc.label_components(fg), max_objects, min_area)
    conf = (masks * probs[..., 1][:, None]).sum((-2, -1)) / torch.clamp(areas, min=1.0)
    return cc.instance_boxes(masks), areas, conf


@torch.no_grad()
def dense_head_detect(model, cfg: PipelineConfig, images_u8: torch.Tensor, score_threshold: float = 0.5,
                      iou_threshold: float = 0.5, top_k: int = 32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense head's detections on uint8 images (B, H, W, 3) on the
    model's device: ``decode_dense_detections`` of the eval forward's
    dense outputs, (boxes (B, K, 4), scores (B, K), valid (B, K))."""
    from mingraph_unet_tpu_torch.models.detection import decode_dense_detections

    out = eval_forward(model, cfg, images_u8)
    return decode_dense_detections(out["dense_objectness_logits"], out["dense_boxes"],
                                   image_hw=tuple(cfg.preprocessing.resize_dim),
                                   cell_size=cfg.model.graph_construction.patch_size, top_k=top_k,
                                   score_threshold=score_threshold, iou_threshold=iou_threshold)


def _with_ablation(cfg: PipelineConfig, ablation: Optional[Dict[str, bool]]) -> PipelineConfig:
    if ablation:
        cfg.model = dataclasses.replace(cfg.model, ablation=dataclasses.replace(cfg.model.ablation, **ablation))
    return cfg


class _Detector:
    """Host side of a detector: resize to the config's ``resize_dim``, run
    the device function at batch 1, map the boxes back to the image."""

    def _run(self, image: np.ndarray):
        from mingraph_unet_tpu_torch.data.dataset import _resize

        resized = _resize(image, tuple(self.cfg.preprocessing.resize_dim), nearest=False)
        out = self._detect(torch.from_numpy(np.ascontiguousarray(resized))[None].to(self.device))
        sy = image.shape[0] / self.cfg.preprocessing.resize_dim[0]
        sx = image.shape[1] / self.cfg.preprocessing.resize_dim[1]
        return [t[0].cpu().numpy() for t in out], sx, sy


class SegmentationCountDetector(_Detector):
    """Segmentation counting (:func:`segmentation_count_detect`) with the
    newest checkpoint under ``weights_path``."""

    def __init__(self, config_dir: str, weights_path: str, model_type: str = "unet", max_objects: int = 32,
                 min_area: int = 10, ablation: Optional[Dict[str, bool]] = None, device: Device = None):
        from mingraph_unet_tpu_torch.train.infer import load_variables

        self.cfg = _with_ablation(PipelineConfig.from_config_dir(config_dir), ablation)
        self.max_objects = max_objects
        model_type = model_type.replace("_", "-")
        self.model = build_eval_model(self.cfg, model_type, load_variables(weights_path), device)
        self.device = next(self.model.parameters()).device
        self._detect = lambda x: segmentation_count_detect(self.model, self.cfg, x, model_type, max_objects, min_area)

    def __call__(self, image: np.ndarray) -> List[dict]:
        (boxes, areas, conf), sx, sy = self._run(image)
        return [{"bbox": [b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy], "class_id": 0, "confidence": float(c)}
                for b, a, c in zip(boxes, areas, conf) if a > 0]


class DenseHeadDetector(_Detector):
    """The dense head's detections (:func:`dense_head_detect`) with the newest
    checkpoint under ``weights_path`` (the config's model with the dense
    head on)."""

    def __init__(self, config_dir: str, weights_path: str, score_threshold: float = 0.5, iou_threshold: float = 0.5,
                 top_k: int = 32, ablation: Optional[Dict[str, bool]] = None, device: Device = None):
        from mingraph_unet_tpu_torch.train.infer import load_variables

        cfg = PipelineConfig.from_config_dir(config_dir)
        cfg.model.fusion_detection = dataclasses.replace(cfg.model.fusion_detection, use_dense_detection=True)
        self.cfg = _with_ablation(cfg, ablation)
        self.model = build_eval_model(self.cfg, "mingraph-unet", load_variables(weights_path), device)
        self.device = next(self.model.parameters()).device
        self._detect = lambda x: dense_head_detect(self.model, self.cfg, x, score_threshold, iou_threshold, top_k)

    def __call__(self, image: np.ndarray) -> List[dict]:
        (boxes, scores, valid), sx, sy = self._run(image)
        return [{"bbox": [b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy], "class_id": 0, "confidence": float(s)}
                for b, s, v in zip(boxes, scores, valid) if v]


def evaluate_yield_model(
    config_dir: Optional[str] = None,
    weights_path: Optional[str] = None,
    model_type: str = "mock",
    num_images: int = 8,
    seed: int = 0,
    ablation: Optional[Dict[str, bool]] = None,
    image_dir: Optional[str] = None,
    ann_file: Optional[str] = None,
    device: Device = None,
) -> Dict[str, float]:
    """Counting and yield metrics (Table 2). ``model_type``: ``mock`` (the
    reference's random detector), ``mingraph-unet-dense``
    (:class:`DenseHeadDetector`), or ``unet`` / ``mingraph-unet`` /
    ``mingraph-unet-refined`` (:class:`SegmentationCountDetector`).
    ``ablation`` overrides the model's stage switches. ``image_dir`` and
    ``ann_file`` evaluate on annotated files (``data/annotations.py``)
    instead of :class:`DummyYieldDataset`; ``num_images`` caps the count.
    Adds ``ap50_perc``, the AP at IoU 0.5 of the confidence-ranked
    detections."""
    if image_dir and ann_file:
        from mingraph_unet_tpu_torch.data.annotations import YieldImageDataset

        dataset = YieldImageDataset(image_dir, ann_file)
        if num_images and num_images < len(dataset):
            dataset.items = dataset.items[:num_images]
    else:
        dataset = DummyYieldDataset(num_images=num_images, seed=seed)
    if model_type == "mock":
        detector = MockDetector(seed=seed)
    elif not (config_dir and weights_path):
        raise ValueError("config_dir and weights_path required for a real detector")
    elif model_type == "mingraph-unet-dense":
        detector = DenseHeadDetector(config_dir, weights_path, ablation=ablation, device=device)
    else:
        detector = SegmentationCountDetector(config_dir, weights_path, model_type, ablation=ablation, device=device)

    gt_counts, pred_counts, gt_objs, pred_objs = [], [], [], []
    for i in range(len(dataset)):
        img, count, objects = dataset[i]
        dets = detector(img)
        gt_counts.append(count)
        pred_counts.append(len(dets))
        gt_objs.append(objects)
        pred_objs.append(dets)
    results = yield_estimation_metrics(gt_counts, pred_counts, gt_objs, pred_objs)
    results["ap50_perc"] = 100.0 * average_precision(gt_objs, pred_objs, 0.5)
    print("\n--- Yield Estimation Performance ---")
    for k, v in results.items():
        print(f"  {k}: {v:.3f}")
    return results


def main(argv=None):
    """The JAX module's CLI: Table 2 of one detector. Returns the
    metrics."""
    parser = argparse.ArgumentParser(description="Evaluate yield estimation")
    parser.add_argument("--config_path", default=None)
    parser.add_argument("--weights_path", default=None)
    parser.add_argument("--model_type", default="mock")
    parser.add_argument("--num_images", type=int, default=8)
    parser.add_argument("--image_dir", default=None, help="real-image eval dir")
    parser.add_argument("--ann_file", default=None, help="COCO-style annotation JSON")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = setup_host(force_cpu=args.cpu)
    return evaluate_yield_model(args.config_path, args.weights_path, args.model_type, args.num_images,
                                image_dir=args.image_dir, ann_file=args.ann_file, device=device)


if __name__ == "__main__":
    main()
