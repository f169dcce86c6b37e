"""CLI: U-Net segmentation inference on one image. Counterpart of
``scripts/infer_segmentation.py``.

    python -m mingraph_unet_tpu_torch.scripts.infer_segmentation --config_path D --image_path I \
        --weights_path W [--output_dir O] [--large_scene --tile 512 --halo 64] [--cpu]

Writes the label and visualization PNGs (``train/infer.py``); with
``--large_scene`` the scene is segmented at its own resolution by
overlapping tiles. Without ``--config_path`` it trains a one-epoch smoke
model on a tiny dataset (``utils/bootstrap.py``) and infers on one of its
images. The image is a PNG, JPEG or BMP (``data/dataset.py::read_image``).
Runs on the CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import tempfile

from mingraph_unet_tpu_torch.train.infer import infer_segmentation, infer_segmentation_large
from mingraph_unet_tpu_torch.train.segmentation import train_unet_segmentation
from mingraph_unet_tpu_torch.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.utils.env import setup_host


def main(argv=None):
    """Returns the inference result (``labels``, ``visualization`` and the
    two PNG paths)."""
    parser = argparse.ArgumentParser(description="Infer mango segmentation on one image")
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--image_path", type=str, default=None)
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default="outputs/inference")
    parser.add_argument("--large_scene", action="store_true",
                        help="Tiled native-resolution inference for big scenes")
    parser.add_argument("--tile", type=int, default=512)
    parser.add_argument("--halo", type=int, default=64)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    if args.config_path and not (args.image_path and args.weights_path):
        parser.error("--image_path and --weights_path are required with --config_path")
    device = setup_host(force_cpu=args.cpu)
    if args.config_path:
        if args.large_scene:
            return infer_segmentation_large(args.config_path, args.image_path, args.weights_path, args.output_dir,
                                            tile=args.tile, halo=args.halo, device=device)
        return infer_segmentation(args.config_path, args.image_path, args.weights_path, args.output_dir,
                                  device=device)

    base = tempfile.mkdtemp(prefix="mgu_infer_smoke_")
    try:
        cfg_dir = make_dummy_run(base, num_images=4, image_size=(64, 64), batch_size=2, num_epochs=1)
        train_unet_segmentation(cfg_dir, max_epochs=1, device=device)
        image = sorted(glob.glob(os.path.join(base, "data/train/images/*.png")))[0]
        out = infer_segmentation(cfg_dir, image, os.path.join(base, "checkpoints"), args.output_dir, device=device)
        if out["labels"].shape != (64, 64):
            raise RuntimeError(f"labels of shape {out['labels'].shape}, expected (64, 64)")
        print("[smoke] infer_segmentation OK")
        return out
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
