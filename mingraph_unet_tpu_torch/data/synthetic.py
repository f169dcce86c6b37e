"""Synthetic annotated orchard scenes: the port's own copy of
``mingraph_unet_tpu/data/synthetic.py`` (seeded numpy + OpenCV on the host,
so the same seed writes the same images, masks and annotation JSON).

- Foliage background: multi-scale green blotch texture, brown branch
  strokes and a low-frequency lighting field.
- Fruit instances: rotated ellipses with mango-like axis ratios, radial
  shading, colour from green to ripe orange, a specular highlight; later
  fruits occlude earlier ones.
- Occlusion: leaf clusters drawn over a share of the fruits (their
  annotations carry ``attributes.occluded = true``).
- Annotations: each fruit's amodal ellipse polygon and box in COCO layout
  (``data/annotations.py::write_coco_json``); the semantic mask (class 1)
  marks the visible fruit pixels.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["render_orchard_scene", "generate_orchard_split", "generate_orchard_dataset"]


def _lighting_field(
    rng: np.random.Generator, h: int, w: int, strength: float = 1.0
) -> np.ndarray:
    """Low-frequency multiplicative lighting (sun-dappled canopy), (H, W, 1);
    ``strength`` scales the gradient amplitude around 1.0."""
    import cv2

    s = strength
    coarse = rng.uniform(1.0 - 0.35 * s, 1.0 + 0.25 * s, size=(max(2, h // 32), max(2, w // 32)))
    field = cv2.resize(coarse.astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(field, max(0.15, 1.0 - 0.5 * s), 1.0 + 0.4 * s)[..., None]


def _foliage_background(
    rng: np.random.Generator, h: int, w: int, lighting_strength: float = 1.0
) -> np.ndarray:
    """Leaf-clutter background, uint8 BGR."""
    import cv2

    # Base canopy color with per-pixel noise.
    base = np.array([28, 85, 30], np.float32)  # BGR dark green
    img = base[None, None, :] + rng.normal(0, 10, size=(h, w, 3)).astype(np.float32)

    # Branches: a few brown poly-lines behind the leaves.
    for _ in range(rng.integers(2, 5)):
        pts = np.stack(
            [
                rng.integers(0, w, size=3),
                rng.integers(0, h, size=3),
            ],
            axis=1,
        ).astype(np.int32)
        col = (int(rng.integers(20, 45)), int(rng.integers(40, 70)), int(rng.integers(60, 95)))
        cv2.polylines(img, [pts], False, col, thickness=int(rng.integers(1, 3)))

    # Leaf blotches at two scales, varied green hues, random orientation.
    n_leaves = int(0.004 * h * w)
    for _ in range(n_leaves):
        c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        ax = (int(rng.integers(2, max(3, w // 24))), int(rng.integers(1, max(2, h // 48))))
        ang = float(rng.uniform(0, 180))
        g = rng.uniform(0.6, 1.6)
        col = (
            float(np.clip(rng.normal(35, 12) * g, 8, 90)),   # B
            float(np.clip(rng.normal(105, 25) * g, 40, 215)),  # G
            float(np.clip(rng.normal(45, 15) * g, 10, 110)),  # R
        )
        cv2.ellipse(img, c, ax, ang, 0, 360, col, -1)

    img *= _lighting_field(rng, h, w, lighting_strength)
    return np.clip(img, 0, 255).astype(np.uint8)


def _draw_clutter(rng: np.random.Generator, img: np.ndarray, n: int) -> None:
    """Fruit-COLORED distractor blobs (dead leaves / sun-lit bark): mango-like
    hues but elongated ragged shapes (axis ratio 0.2-0.45 vs fruit 0.68-0.88),
    NOT in the semantic mask. Color alone stops separating the classes —
    the hard-regime knob that punishes a pure color segmenter."""
    import cv2

    h, w = img.shape[:2]
    scale = min(h, w)
    for _ in range(n):
        c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        a = int(rng.integers(max(4, scale // 22), max(6, scale // 10)))
        b = max(1, int(a * rng.uniform(0.2, 0.45)))
        ang = float(rng.uniform(0, 180))
        t = rng.uniform(0.2, 1.0)
        unripe = np.array([55, 170, 150], np.float32)
        ripe = np.array([25, 135, 235], np.float32)
        col = unripe * (1 - t) + ripe * t + rng.normal(0, 15, 3)
        col = tuple(float(np.clip(v, 0, 255)) for v in col)
        cv2.ellipse(img, c, (a, b), ang, 0, 360, col, -1)
        # Ragged edge: a couple of darker nicks along the blob.
        for _ in range(2):
            nc = (
                int(np.clip(c[0] + rng.integers(-a, a + 1), 0, w - 1)),
                int(np.clip(c[1] + rng.integers(-b, b + 1), 0, h - 1)),
            )
            dark = tuple(v * 0.55 for v in col)
            cv2.ellipse(img, nc, (max(1, a // 3), max(1, b // 2)), ang, 0, 360, dark, -1)


def _draw_fruit(
    rng: np.random.Generator, img: np.ndarray, c, axes, ang: float
) -> np.ndarray:
    """Shaded mango ellipse onto ``img`` in place; returns its filled mask."""
    import cv2

    h, w = img.shape[:2]
    layer_mask = np.zeros((h, w), np.uint8)
    cv2.ellipse(layer_mask, c, axes, ang, 0, 360, 1, -1)

    # Ripeness: green-tinged → deep orange (BGR).
    t = rng.uniform(0.0, 1.0)
    unripe = np.array([55, 170, 150], np.float32)
    ripe = np.array([25, 135, 235], np.float32)
    color = unripe * (1 - t) + ripe * t + rng.normal(0, 8, 3).astype(np.float32)

    # Radial shading toward the rim.
    ys, xs = np.nonzero(layer_mask)
    if len(ys) == 0:
        return layer_mask
    dy = (ys - c[1]) / max(axes[1], 1)
    dx = (xs - c[0]) / max(axes[0], 1)
    r = np.sqrt(dx * dx + dy * dy)  # ~0 center, ~1 rim (pre-rotation approx)
    shade = (1.0 - 0.45 * np.clip(r, 0, 1.2)) * rng.uniform(0.85, 1.1)
    img[ys, xs] = np.clip(color[None, :] * shade[:, None], 0, 255).astype(np.uint8)

    # Specular highlight: small bright ellipse offset toward the light.
    hx = int(c[0] - 0.35 * axes[0])
    hy = int(c[1] - 0.35 * axes[1])
    hl = np.zeros((h, w), np.uint8)
    cv2.ellipse(
        hl, (hx, hy), (max(1, axes[0] // 4), max(1, axes[1] // 5)), ang, 0, 360, 1, -1
    )
    hl &= layer_mask
    img[hl > 0] = np.clip(img[hl > 0].astype(np.float32) * 1.35 + 40, 0, 255).astype(
        np.uint8
    )
    return layer_mask


def render_orchard_scene(
    rng: np.random.Generator,
    h: int = 128,
    w: int = 128,
    min_fruits: int = 2,
    max_fruits: int = 9,
    occlusion_prob: float = 0.3,
    lighting_strength: float = 1.0,
    clutter: float = 0.0,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, List[Dict]]:
    """Render one scene.

    Returns ``(img_bgr_u8, semantic_mask_u8, instances)`` where each
    instance dict carries ``poly`` ((P, 2) float array, amodal ellipse
    outline), ``bbox`` (xywh), and ``occluded`` (bool, leaf drawn over it).
    The semantic mask marks **visible** fruit pixels.

    Hard-regime knobs (the defaults leave them off):
    ``lighting_strength`` scales the canopy lighting gradients;
    ``clutter`` is the expected number of fruit-colored distractor blobs
    per scene (Poisson), never in the mask; ``label_noise`` simulates
    annotation noise in the SEMANTIC mask ONLY (train splits): each fruit
    is dropped from the mask with prob ``0.5·label_noise`` (missed
    annotation), and with prob ``label_noise`` the whole mask is eroded or
    dilated 1-2 px (sloppy boundaries). Instance annotations (boxes/polys)
    stay correct — eval splits must be generated with label_noise=0.
    """
    import cv2

    img = _foliage_background(rng, h, w, lighting_strength)
    if clutter > 0:
        _draw_clutter(rng, img, int(rng.poisson(clutter)))
    n = int(rng.integers(min_fruits, max_fruits + 1))

    visible = np.zeros((h, w), np.uint8)  # running visible-fruit mask
    instances: List[Dict] = []
    per_fruit_masks: List[np.ndarray] = []

    scale = min(h, w)
    for _ in range(n):
        a = int(rng.integers(max(4, scale // 20), max(6, scale // 9)))
        b = int(a * rng.uniform(0.68, 0.88))  # mango axis ratio
        c = (int(rng.integers(a, w - a)), int(rng.integers(b, h - b)))
        ang = float(rng.uniform(0, 180))
        m = _draw_fruit(rng, img, c, (a, b), ang)
        # This fruit overwrites any pixel of earlier fruits it covers.
        for pm in per_fruit_masks:
            pm &= ~m
        per_fruit_masks.append(m)

        poly = cv2.ellipse2Poly(c, (a, b), int(ang), 0, 360, 10).astype(np.float64)
        poly = np.clip(poly, [0, 0], [w - 1, h - 1])
        x0, y0 = poly.min(axis=0)
        x1, y1 = poly.max(axis=0)
        instances.append(
            {
                "poly": poly,
                "bbox": [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)],
                "occluded": False,
            }
        )

    # Foreground leaf clusters over a fraction of fruits.
    for inst, pm in zip(instances, per_fruit_masks):
        if rng.uniform() < occlusion_prob and pm.any():
            ys, xs = np.nonzero(pm)
            k = int(rng.integers(0, len(ys)))
            leaf_c = (int(xs[k]), int(ys[k]))
            la = int(rng.integers(max(3, scale // 24), max(5, scale // 12)))
            lb = max(2, int(la * rng.uniform(0.35, 0.6)))
            lang = float(rng.uniform(0, 180))
            g = rng.uniform(0.7, 1.4)
            col = (
                float(np.clip(30 * g, 8, 90)),
                float(np.clip(110 * g, 40, 215)),
                float(np.clip(50 * g, 10, 120)),
            )
            leaf = np.zeros((h, w), np.uint8)
            cv2.ellipse(leaf, leaf_c, (la, lb), lang, 0, 360, 1, -1)
            cv2.ellipse(img, leaf_c, (la, lb), lang, 0, 360, col, -1)
            covered = int((leaf & pm).sum())
            for pm2 in per_fruit_masks:
                pm2 &= ~leaf
            if covered > 0:
                inst["occluded"] = True

    for pm in per_fruit_masks:
        if label_noise > 0 and rng.uniform() < 0.5 * label_noise:
            continue  # missed annotation: fruit absent from the semantic mask
        visible |= pm
    if label_noise > 0 and rng.uniform() < label_noise:
        k = int(rng.integers(1, 3))
        kernel = np.ones((2 * k + 1, 2 * k + 1), np.uint8)
        if rng.uniform() < 0.5:
            visible = cv2.erode(visible, kernel)
        else:
            visible = cv2.dilate(visible, kernel)

    # Final sensor noise.
    img = np.clip(
        img.astype(np.float32) + rng.normal(0, 4, img.shape).astype(np.float32), 0, 255
    ).astype(np.uint8)
    return img, visible, instances


def generate_orchard_split(
    split_dir: str,
    num_images: int,
    image_size: Tuple[int, int] = (128, 128),
    seed: int = 0,
    min_fruits: int = 2,
    max_fruits: int = 9,
    occlusion_prob: float = 0.3,
    **scene_kwargs,
) -> str:
    """Write ``images/``, ``masks/`` and ``annotations.json`` under
    ``split_dir``.  Returns the annotation-file path.  Extra kwargs go to
    :func:`render_orchard_scene` (hard-regime knobs; pass ``label_noise``
    to TRAIN splits only)."""
    import cv2

    from mingraph_unet_tpu_torch.data.annotations import write_coco_json

    img_dir = os.path.join(split_dir, "images")
    mask_dir = os.path.join(split_dir, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    h, w = image_size
    rng = np.random.default_rng(seed)
    coco_images, coco_anns = [], []
    ann_id = 1
    for i in range(num_images):
        img, mask, instances = render_orchard_scene(
            rng, h, w, min_fruits, max_fruits, occlusion_prob, **scene_kwargs
        )
        name = f"img_{i:05d}.png"
        cv2.imwrite(os.path.join(img_dir, name), img)
        cv2.imwrite(os.path.join(mask_dir, name), mask)
        coco_images.append({"id": i, "file_name": name, "height": h, "width": w})
        for inst in instances:
            coco_anns.append(
                {
                    "id": ann_id,
                    "image_id": i,
                    "category_id": 0,
                    "bbox": inst["bbox"],
                    "segmentation": [inst["poly"].reshape(-1).tolist()],
                    "iscrowd": 0,
                    "attributes": {"occluded": bool(inst["occluded"])},
                }
            )
            ann_id += 1
    return write_coco_json(
        os.path.join(split_dir, "annotations.json"), coco_images, coco_anns
    )


def generate_orchard_dataset(
    data_root: str,
    num_train: int = 1200,
    num_val: int = 200,
    num_test: int = 200,
    image_size: Tuple[int, int] = (128, 128),
    seed: int = 0,
    train_only_kwargs: Optional[Dict] = None,
    **scene_kwargs,
) -> Dict[str, str]:
    """Standard train/val/test layout (``configs/dataset.yaml`` dirs).

    Returns ``{split: annotation_file}``.  Splits use disjoint seeds so no
    scene repeats across splits.  ``train_only_kwargs`` merge into the
    train split's scene kwargs only (e.g. ``{"label_noise": 0.35}`` —
    annotation noise belongs in training data, never in eval GT).
    """
    out = {}
    for split, count, s in (
        ("train", num_train, seed),
        ("val", num_val, seed + 1_000_003),
        ("test", num_test, seed + 2_000_003),
    ):
        if count <= 0:
            continue
        kw = dict(scene_kwargs)
        if split == "train" and train_only_kwargs:
            kw.update(train_only_kwargs)
        out[split] = generate_orchard_split(
            os.path.join(data_root, split), count, image_size, s, **kw
        )
    return out
