"""Inference entry points. Counterpart of ``mingraph_unet_tpu/train/infer.py``.

- :func:`infer_segmentation`: config + weights + image → uint8 label map and
  colour visualization PNGs (argmax over the U-Net's class logits at the
  config's ``resize_dim``).
- :func:`infer_segmentation_large`: the same at the scene's native
  resolution, by overlapping tiles with border-flush halos
  (``parallel/spatial.py``).
- :func:`pipeline_forward_large`: the full ``MinGraphUNet`` on a large
  scene: the U-Net tile by tile, then the graph branch, fusion and the
  heads once over the whole scene's patch lattice.

Weights are the port's own checkpoints (``train/checkpoint.py``): a trainer's
composite checkpoint or a bare state dict. A JAX checkpoint comes in through
``convert.py``. Entry points run on the CUDA card unless ``device="cpu"``
is passed. A PNG is read by the C++ loader (``data/dataset.py::
read_image``; OpenCV only for other formats) and the outputs are written
by ``data/png.py``: a label PNG and a visualization PNG whose decoded BGR
equals the BGR visualization array, as OpenCV's ``imwrite`` writes it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.data.dataset import read_image
from mingraph_unet_tpu_torch.data.png import write_png
from mingraph_unet_tpu_torch.models.pipeline import MinGraphUNet
from mingraph_unet_tpu_torch.ops.image import normalize
from mingraph_unet_tpu_torch.parallel.spatial import tiled_inference
from mingraph_unet_tpu_torch.train.checkpoint import CheckpointManager
from mingraph_unet_tpu_torch.train.segmentation import build_unet

__all__ = [
    "class_palette",
    "postprocess_segmentation",
    "load_variables",
    "infer_segmentation",
    "infer_segmentation_large",
    "pipeline_forward_large",
]

Device = Optional[Union[str, torch.device]]


def class_palette(num_classes: int) -> np.ndarray:
    """BGR colours per class: black, green, red, blue, then seeded extras."""
    colors = [(0, 0, 0), (0, 255, 0), (0, 0, 255), (255, 0, 0)]
    rng = np.random.default_rng(0)
    while len(colors) < num_classes + 1:
        colors.append(tuple(int(v) for v in rng.integers(0, 255, 3)))
    return np.asarray(colors[: max(num_classes, 1)], np.uint8)


def postprocess_segmentation(logits_or_labels: np.ndarray, num_classes: int):
    """(H, W[, C]) logits or labels (a leading batch axis takes image 0) →
    (label map HW, BGR visualization HWC)."""
    arr = np.asarray(logits_or_labels)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[-1] == num_classes:
        labels = arr.argmax(-1)
    else:
        labels = arr.astype(np.int64)
    vis = class_palette(num_classes)[np.clip(labels, 0, num_classes - 1)]
    return labels, vis


def load_variables(weights_path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of the newest checkpoint under ``weights_path``
    (``CheckpointManager``'s directory), on the CPU: a trainer's composite
    checkpoint (``{"state": {"model": ...}, ...}``) or a bare state dict."""
    restored = None
    if os.path.isdir(weights_path):  # the manager would create a missing directory
        restored = CheckpointManager(weights_path).restore_latest(map_location="cpu")
    if restored is None:
        raise FileNotFoundError(f"No checkpoint found under {weights_path!r}")
    if isinstance(restored.get("state"), dict) and "model" in restored["state"]:
        return restored["state"]["model"]
    if all(isinstance(v, torch.Tensor) for v in restored.values()):
        return restored
    raise ValueError(f"Unrecognized checkpoint layout with keys {list(restored)}")


def _segmentation_model(config_dir: str, weights_path: str, device: Device):
    cfg = PipelineConfig.from_config_dir(config_dir)
    model = build_unet(cfg, device)
    model.load_state_dict(load_variables(weights_path))
    return cfg, model.eval()


def _write_pngs(labels: np.ndarray, vis: np.ndarray, output_dir: str, image_path: str, kind: str) -> Dict[str, Any]:
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_path))[0]
    label_path = os.path.join(output_dir, f"{stem}_{kind}_labels.png")
    vis_path = os.path.join(output_dir, f"{stem}_{kind}_visualization.png")
    write_png(label_path, labels.astype(np.uint8))
    write_png(vis_path, vis[..., ::-1])  # the file holds RGB; the array is BGR
    print(f"[infer] wrote {label_path} and {vis_path}")
    return {"labels": labels, "visualization": vis, "label_path": label_path, "vis_path": vis_path}


@torch.no_grad()
def infer_segmentation(config_dir: str, image_path: str, weights_path: str,
                       output_dir: str = "outputs/inference", device: Device = None) -> Dict[str, Any]:
    """U-Net inference on one image resized to ``resize_dim``; writes
    ``<stem>_seg_labels.png`` and ``<stem>_seg_visualization.png``."""
    cfg, model = _segmentation_model(config_dir, weights_path, device)
    pre = cfg.preprocessing
    img = read_image(image_path, pre.resize_dim)
    dev = next(model.parameters()).device
    x = normalize(torch.from_numpy(img).to(dev).float() / 255.0, pre.normalization_mean, pre.normalization_std)
    logits = model(x[None])["logits"]
    labels, vis = postprocess_segmentation(logits.float().cpu().numpy(), cfg.model.unet.out_channels)
    return _write_pngs(labels, vis, output_dir, image_path, "seg")


@torch.no_grad()
def infer_segmentation_large(config_dir: str, image_path: str, weights_path: str,
                             output_dir: str = "outputs/inference", tile: int = 512, halo: int = 64,
                             device: Device = None) -> Dict[str, Any]:
    """U-Net inference on a scene at its native resolution, by overlapping
    ``tile``-sized windows (the whole scene at once when it is smaller than
    one window); writes ``<stem>_scene_labels.png`` and
    ``<stem>_scene_visualization.png``."""
    cfg, model = _segmentation_model(config_dir, weights_path, device)
    pre = cfg.preprocessing
    img = read_image(image_path)
    dev = next(model.parameters()).device
    x = normalize(torch.from_numpy(img).to(dev).float() / 255.0, pre.normalization_mean,
                  pre.normalization_std)[None]

    def apply_fn(tiles: torch.Tensor) -> torch.Tensor:
        return model(tiles)["logits"]

    h, w = img.shape[:2]
    if h < tile + 2 * halo or w < tile + 2 * halo:
        logits = apply_fn(x)
    else:
        logits = tiled_inference(apply_fn, x, tile=tile, halo=halo)
    labels, vis = postprocess_segmentation(logits.float().cpu().numpy(), cfg.model.unet.out_channels)
    return _write_pngs(labels, vis, output_dir, image_path, "scene")


@torch.no_grad()
def pipeline_forward_large(model: MinGraphUNet, scene: torch.Tensor, tile: int = 512,
                           halo: int = 64) -> Dict[str, object]:
    """``model``'s inference forward on a large scene (B, H, W, C)
    (normalized; H, W multiples of ``patch_size``; ``tile`` and ``halo``
    multiples of 2^depth): the U-Net runs over overlapping windows (the
    whole scene when it is at most one window), its logits, skip 0 and
    ``f_u[0]`` are stitched in f32 in one concat, and the rest of the
    model runs once over the whole scene through ``unet_outputs``. Equals
    the whole-scene forward when ``halo`` covers the U-Net's receptive
    field. The model's train/eval mode is restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        scene = scene.to(model.device)
        ncls, f0 = model.num_classes, model.init_features

        def unet_tile(tiles: torch.Tensor) -> torch.Tensor:
            u = model.unet(tiles, full_res_outputs=True)
            return torch.cat([u["logits"].float(), u["skips"][0].float(), u["f_u"][0].float()], dim=-1)

        h, w = scene.shape[1:3]
        if h <= tile + 2 * halo or w <= tile + 2 * halo:
            stacked = unet_tile(scene)
        else:
            stacked = tiled_inference(unet_tile, scene, tile=tile, halo=halo)
        logits, skip0, f_u0 = stacked[..., :ncls], stacked[..., ncls : ncls + f0], stacked[..., ncls + f0 :]
        return model(scene, unet_outputs={"logits": logits, "skips": [skip0], "f_u": [f_u0]})
    finally:
        model.train(was_training)
