"""CLI: U-Net segmentation training. Counterpart of
``scripts/train_segmentation.py``.

    python -m mingraph_unet_tpu_torch.scripts.train_segmentation --config_path D [--epochs N] [--cpu]

With ``--config_path`` it trains from the four YAML files in ``D``; without
it, it writes a tiny dataset and configs (``utils/bootstrap.py``, which
draws with OpenCV) to a temporary directory and runs a two-epoch smoke.
Runs on the CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from mingraph_unet_tpu_torch.train.segmentation import train_unet_segmentation
from mingraph_unet_tpu_torch.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.utils.env import setup_host


def main(argv=None):
    """Returns ``train_unet_segmentation``'s (state, history)."""
    parser = argparse.ArgumentParser(description="Train U-Net for mango segmentation")
    parser.add_argument("--config_path", type=str, default=None, help="Directory with the 4 YAML configs")
    parser.add_argument("--epochs", type=int, default=None, help="Override num_epochs")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU")
    args = parser.parse_args(argv)
    device = setup_host(force_cpu=args.cpu)
    if args.config_path:
        return train_unet_segmentation(args.config_path, max_epochs=args.epochs, device=device)

    base = tempfile.mkdtemp(prefix="mgu_smoke_")
    try:
        cfg_dir = make_dummy_run(base, num_images=4, image_size=(64, 64), batch_size=2, num_epochs=2)
        state, history = train_unet_segmentation(cfg_dir, max_epochs=args.epochs or 2, device=device)
        print(f"[smoke] final epoch losses: {history['epoch_loss']}")
        if not history["epoch_loss"][-1] > 0:
            raise RuntimeError(f"the smoke run's last epoch loss is {history['epoch_loss'][-1]}")
        print("[smoke] train_segmentation OK")
        return state, history
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
