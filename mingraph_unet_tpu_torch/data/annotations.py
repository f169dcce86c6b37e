"""COCO-style annotations: boxes, occlusion flags, instance masks. The port's
own copy of ``mingraph_unet_tpu/data/annotations.py`` (host numpy; polygons
are rasterized by ``data/raster.py``, OpenCV's fill reproduced).

- :class:`CocoAnnotations` reads the COCO detection layout (``images`` /
  ``annotations`` / ``categories``). Polygon segmentations are rasterized
  as ``cv2.fillPoly`` fills them; an annotation without a usable polygon
  becomes its filled box. Occlusion comes from ``iscrowd`` or
  ``attributes.occluded`` (the CVAT convention).
- :class:`YieldImageDataset` gives image files with their annotations in
  the yield harness's item schema ``(image_u8 HWC, count, [{"bbox" xyxy,
  "class_id", "occluded"}, ...])``.
- :func:`write_coco_json` writes a minimal annotation file.

Instance masks are padded or cut to a static ``max_instances`` (the largest
kept), so that the device side sees one shape.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mingraph_unet_tpu_torch.data.raster import fill_poly, resize_nearest

__all__ = ["CocoAnnotations", "YieldImageDataset", "write_coco_json"]


class CocoAnnotations:
    """A parsed COCO annotation file (detection layout)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images: Dict[int, Dict[str, Any]] = {im["id"]: im for im in data.get("images", [])}
        self.file_to_id: Dict[str, int] = {os.path.basename(im["file_name"]): im["id"] for im in self.images.values()}
        self.by_image: Dict[int, List[Dict[str, Any]]] = {i: [] for i in self.images}
        for ann in data.get("annotations", []):
            self.by_image.setdefault(ann["image_id"], []).append(ann)
        self.categories = {c["id"]: c.get("name", str(c["id"])) for c in data.get("categories", [])}

    def id_for_file(self, path_or_name: str) -> Optional[int]:
        return self.file_to_id.get(os.path.basename(path_or_name))

    @staticmethod
    def _occluded(ann: Dict[str, Any]) -> bool:
        if ann.get("iscrowd", 0):
            return True
        attrs = ann.get("attributes") or {}
        return bool(attrs.get("occluded", False))

    def objects_for(self, image_id: int) -> List[Dict[str, Any]]:
        """Per-object dicts in the yield-metric schema: xyxy pixel boxes in
        the annotation's frame, the category, the occlusion flag."""
        out = []
        for ann in self.by_image.get(image_id, []):
            x, y, w, h = ann["bbox"]
            out.append({"bbox": [float(x), float(y), float(x + w), float(y + h)],
                        "class_id": int(ann.get("category_id", 0)), "occluded": self._occluded(ann)})
        return out

    def instance_masks_for(self, image_id: int, out_hw: Optional[Tuple[int, int]] = None,
                           max_instances: Optional[int] = None) -> np.ndarray:
        """(O, H, W) uint8 instance masks of one image: polygons filled
        (``cv2.fillPoly``), a box where no polygon fills a pixel; resized
        nearest (``INTER_NEAREST``) to ``out_hw``; with ``max_instances``
        padded with empty masks or cut to the largest."""
        im = self.images[image_id]
        h, w = int(im["height"]), int(im["width"])
        masks = []
        for ann in self.by_image.get(image_id, []):
            m = np.zeros((h, w), np.uint8)
            seg = ann.get("segmentation")
            if seg and isinstance(seg, list) and len(seg) and isinstance(seg[0], (list, tuple)):
                polys = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32) for p in seg
                         if len(p) >= 6]
                if polys:
                    fill_poly(m, polys, 1)
            if not m.any():
                x, y, bw, bh = ann["bbox"]
                x0, y0 = max(0, int(round(x))), max(0, int(round(y)))
                x1, y1 = min(w, int(round(x + bw))), min(h, int(round(y + bh)))
                m[y0:y1, x0:x1] = 1
            masks.append(m)
        if out_hw is not None and tuple(out_hw) != (h, w):
            masks = [resize_nearest(m, tuple(out_hw)) for m in masks]
            h, w = out_hw
        stack = np.stack(masks) if masks else np.zeros((0, h, w), np.uint8)
        if max_instances is not None:
            if stack.shape[0] > max_instances:
                order = np.argsort(-stack.reshape(stack.shape[0], -1).sum(1))
                stack = stack[order[:max_instances]]
            elif stack.shape[0] < max_instances:
                stack = np.concatenate([stack, np.zeros((max_instances - stack.shape[0], h, w), np.uint8)], axis=0)
        return stack


class YieldImageDataset:
    """Image files with COCO annotations, in the yield harness's item schema:
    ``dataset[i] -> (image_u8 HWC at its own size, count, objects)``. Only the
    images the annotation file names are kept."""

    IMAGE_EXTS = ("*.png", "*.jpg", "*.jpeg")

    def __init__(self, image_dir: str, ann_file: str):
        self.ann = CocoAnnotations(ann_file)
        paths = sorted(p for ext in self.IMAGE_EXTS for p in glob.glob(os.path.join(image_dir, ext)))
        self.items = [(p, i) for p, i in ((p, self.ann.id_for_file(p)) for p in paths) if i is not None]
        if not self.items:
            raise FileNotFoundError(f"No annotated images found ({image_dir!r} vs {ann_file!r})")

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        from mingraph_unet_tpu_torch.data.dataset import load_image_rgb

        path, image_id = self.items[idx]
        objects = self.ann.objects_for(image_id)
        return load_image_rgb(path), len(objects), objects

    def instance_masks(self, idx: int, out_hw=None, max_instances=None) -> np.ndarray:
        return self.ann.instance_masks_for(self.items[idx][1], out_hw, max_instances)


def write_coco_json(path: str, images: Sequence[Dict[str, Any]], annotations: Sequence[Dict[str, Any]],
                    categories: Optional[Sequence[Dict[str, Any]]] = None) -> str:
    """Write a minimal COCO detection JSON; returns ``path``."""
    data = {"images": list(images), "annotations": list(annotations),
            "categories": list(categories or [{"id": 0, "name": "mango"}])}
    with open(path, "w") as f:
        json.dump(data, f)
    return path
