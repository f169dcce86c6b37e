"""CLI: the graph branch on its own, on one image. Counterpart of
``scripts/graph_refinement.py``.

    python -m mingraph_unet_tpu_torch.scripts.graph_refinement --config_path D --image_path I [--cpu]

Preprocess → patch features (pooled normalized pixels ⊕ Sobel ⊕ hist-eq,
the reference's recipe) → lattice GAT → segment predictor and Ncut loss →
hard patch labels. :func:`graph_features` and :func:`build_graph_modules`
make the inputs and the seeded modules, :func:`run_graph_pipeline` runs
them (so that a caller can load other weights in between) and
:func:`graph_pipeline` does all three. Without ``--config_path`` it runs on
an image of a tiny dataset (``utils/bootstrap.py``, which draws with
OpenCV). Runs on the CUDA card unless ``--cpu`` is given; on the card the
hist-eq feature runs K6 on a batch of one.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import tempfile
from typing import Tuple

import numpy as np
import torch

from mingraph_unet_tpu_torch.config import PipelineConfig
from mingraph_unet_tpu_torch.data.dataset import read_image
from mingraph_unet_tpu_torch.models.gat import GATNetwork
from mingraph_unet_tpu_torch.models.mincut import MinCutRefinement
from mingraph_unet_tpu_torch.ops import filters
from mingraph_unet_tpu_torch.ops.image import normalize
from mingraph_unet_tpu_torch.ops.patches import patch_reduce_mean
from mingraph_unet_tpu_torch.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.utils.env import setup_host


def graph_features(cfg: PipelineConfig, image_path: str, device: torch.device) -> torch.Tensor:
    """The patch-node features (1, nph, npw, 7) of the image at
    ``resize_dim``: pooled normalized pixels (the reference demo's stand-in
    for U-Net features), the Sobel mean and the hist-eq mean."""
    patch = cfg.model.graph_construction.patch_size
    pre = cfg.preprocessing
    rgb = torch.from_numpy(read_image(image_path, pre.resize_dim)).to(device)
    x = normalize(rgb.float() / 255.0, pre.normalization_mean, pre.normalization_std)
    unet_feat = patch_reduce_mean(x[None], patch)
    sobel_feat = patch_reduce_mean(filters.sobel_magnitude(rgb)[None, ..., None] / 255.0, patch)
    histeq_feat = patch_reduce_mean(filters.equalize_histogram_rgb(rgb).float()[None] / 255.0, patch)
    return torch.cat([unet_feat, sobel_feat, histeq_feat], dim=-1)


def build_graph_modules(cfg: PipelineConfig, in_features: int, device: torch.device
                        ) -> Tuple[GATNetwork, MinCutRefinement]:
    """The one-layer lattice GAT (seed 0) and the MinCut stage (seed 1) of
    the config's widths, in eval mode."""
    g = cfg.model.gat
    gat = GATNetwork(in_features, g.hidden_dim, g.output_dim, g.num_heads, torch.Generator().manual_seed(0),
                     num_layers=1, alpha=g.alpha, backend="lattice", dropout_rate=g.dropout)
    mincut = MinCutRefinement(g.output_dim, cfg.dataset.num_semantic_regions, torch.Generator().manual_seed(1),
                              sigma_ncut=cfg.model.mincut.sigma_ncut, backend="lattice")
    return gat.to(device).eval(), mincut.to(device).eval()


@torch.no_grad()
def run_graph_pipeline(feats: torch.Tensor, gat: GATNetwork, mincut: MinCutRefinement) -> Tuple[float, np.ndarray]:
    """GAT, then MinCut on the refined features: (L_partition, hard patch
    labels (nph, npw)) of image 0, printed as the JAX script prints them."""
    nph, npw = feats.shape[1], feats.shape[2]
    print(f"[graph] patch grid {nph}x{npw}, node feature dim {feats.shape[-1]}")
    refined = gat(feats)
    print(f"[graph] GAT-refined features: {tuple(refined.shape)}")
    l_part, soft = mincut(refined)
    hard = soft.argmax(dim=-1)[0].cpu().numpy()
    print(f"[graph] L_partition = {float(l_part[0]):.6f}")
    print(f"[graph] hard patch labels ({nph}x{npw}):")
    print(hard)
    return float(l_part[0]), hard


def graph_pipeline(config_dir: str, image_path: str, device: torch.device) -> Tuple[float, np.ndarray]:
    """The whole demo on one image: features, seeded modules, the run."""
    cfg = PipelineConfig.from_config_dir(config_dir)
    feats = graph_features(cfg, image_path, device)
    return run_graph_pipeline(feats, *build_graph_modules(cfg, feats.shape[-1], device))


def main(argv=None):
    """Returns (L_partition, hard patch labels)."""
    parser = argparse.ArgumentParser(description="Graph refinement pipeline demo")
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--image_path", type=str, default=None)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    if args.config_path and not args.image_path:
        parser.error("--image_path required with --config_path")
    device = setup_host(force_cpu=args.cpu)
    if args.config_path:
        return graph_pipeline(args.config_path, args.image_path, device)

    base = tempfile.mkdtemp(prefix="mgu_graph_smoke_")
    try:
        cfg_dir = make_dummy_run(base, num_images=1, image_size=(64, 64))
        image = sorted(glob.glob(os.path.join(base, "data/train/images/*.png")))[0]
        l_part, hard = graph_pipeline(cfg_dir, image, device)
        if not l_part >= 0:
            raise RuntimeError(f"L_partition is {l_part}")
        print("[smoke] graph_refinement OK")
        return l_part, hard
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
