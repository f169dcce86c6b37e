"""Dummy configs and a tiny dataset for smoke runs and tests. The port's
own copy of ``mingraph_unet_tpu/utils/bootstrap.py``: the same seed writes
the same images, masks, annotation JSON and YAML (OpenCV is imported on
use; the YAML is ``config.py``'s writer).
"""

from __future__ import annotations

import os
from dataclasses import asdict, replace
from typing import Tuple

import numpy as np

from mingraph_unet_tpu_torch.config import PipelineConfig, write_yaml

__all__ = ["make_dummy_run"]


def make_dummy_run(
    base_dir: str,
    num_images: int = 4,
    image_size: Tuple[int, int] = (64, 64),
    batch_size: int = 2,
    num_epochs: int = 2,
    patch_size: int = 16,
    init_features: int = 8,
    depth: int = 2,
    seed: int = 0,
    with_annotations: bool = False,
) -> str:
    """Create configs + a tiny synthetic mango dataset under ``base_dir``.

    Returns the config directory path. Images are green backgrounds with
    orange ellipses; masks mark the ellipses as class 1.
    ``with_annotations`` additionally writes a COCO-style JSON
    (polygon segmentations + boxes, one annotation per ellipse) and points
    ``dataset.annotations_file`` at it (the instance-GT training path).
    """
    import cv2

    cfg_dir = os.path.join(base_dir, "configs")
    data_root = os.path.join(base_dir, "data")
    img_dir = os.path.join(data_root, "train", "images")
    mask_dir = os.path.join(data_root, "train", "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    h, w = image_size
    rng = np.random.default_rng(seed)
    coco_images, coco_anns = [], []
    ann_id = 1
    for i in range(num_images):
        img = np.full((h, w, 3), (35, 110, 40), np.uint8)  # BGR green-ish
        mask = np.zeros((h, w), np.uint8)
        for _ in range(rng.integers(1, 4)):
            c = (int(rng.integers(w // 4, 3 * w // 4)), int(rng.integers(h // 4, 3 * h // 4)))
            ax = (int(rng.integers(4, max(5, w // 6))), int(rng.integers(3, max(4, h // 8))))
            ang = float(rng.uniform(0, 180))
            cv2.ellipse(img, c, ax, ang, 0, 360, (30, 140, 230), -1)
            cv2.ellipse(mask, c, ax, ang, 0, 360, 1, -1)
            if with_annotations:
                poly = cv2.ellipse2Poly(c, ax, int(ang), 0, 360, 10)
                poly = np.clip(poly, [0, 0], [w - 1, h - 1])
                x0, y0 = poly.min(axis=0)
                x1, y1 = poly.max(axis=0)
                coco_anns.append(
                    {
                        "id": ann_id,
                        "image_id": i,
                        "category_id": 0,
                        "bbox": [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)],
                        "segmentation": [poly.astype(float).reshape(-1).tolist()],
                        "iscrowd": 0,
                    }
                )
                ann_id += 1
        cv2.imwrite(os.path.join(img_dir, f"img_{i:03d}.png"), img)
        cv2.imwrite(os.path.join(mask_dir, f"img_{i:03d}.png"), mask)
        coco_images.append(
            {"id": i, "file_name": f"img_{i:03d}.png", "height": h, "width": w}
        )

    ann_file = None
    if with_annotations:
        from mingraph_unet_tpu_torch.data.annotations import write_coco_json

        ann_file = write_coco_json(
            os.path.join(data_root, "train", "annotations.json"), coco_images, coco_anns
        )

    cfg = PipelineConfig()
    cfg.dataset = replace(
        cfg.dataset, data_root=data_root, image_height=h, image_width=w,
        annotations_file=ann_file,
    )
    cfg.preprocessing = replace(cfg.preprocessing, resize_dim=(h, w))
    cfg.model.unet = replace(cfg.model.unet, init_features=init_features, depth=depth)
    cfg.model.graph_construction = replace(cfg.model.graph_construction, patch_size=patch_size)
    cfg.model.gat = replace(cfg.model.gat, hidden_dim=32, output_dim=16, num_heads=2)
    cfg.training = replace(
        cfg.training,
        batch_size=batch_size,
        num_epochs=num_epochs,
        checkpoint_dir=os.path.join(base_dir, "checkpoints"),
        log_dir=os.path.join(base_dir, "logs"),
        save_epoch_interval=1,
        num_workers=0,
    )

    os.makedirs(cfg_dir, exist_ok=True)
    PipelineConfig.write_defaults(cfg_dir)  # writes defaults...
    # ...then overwrite with the run-specific values.
    for name, section in (("dataset.yaml", cfg.dataset), ("model.yaml", cfg.model),
                          ("preprocessing.yaml", cfg.preprocessing), ("training.yaml", cfg.training)):
        write_yaml(os.path.join(cfg_dir, name), asdict(section))
    return cfg_dir
