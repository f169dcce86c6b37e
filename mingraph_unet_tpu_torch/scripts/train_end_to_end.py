"""CLI: end-to-end MinGraph-UNet training. Counterpart of
``scripts/train_end_to_end.py``.

    python -m mingraph_unet_tpu_torch.scripts.train_end_to_end --config_path D [--epochs N] [--no_detection] [--cpu]

With ``--config_path`` it trains from the four YAML files in ``D``; without
it, it runs a two-epoch smoke on a tiny dataset written by
``utils/bootstrap.py``. Runs on the CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from mingraph_unet_tpu_torch.train.end_to_end import train_end_to_end
from mingraph_unet_tpu_torch.utils.bootstrap import make_dummy_run
from mingraph_unet_tpu_torch.utils.env import setup_host


def main(argv=None):
    """Returns ``train_end_to_end``'s (state, history)."""
    parser = argparse.ArgumentParser(description="Train the full MinGraph-UNet pipeline")
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--no_detection", action="store_true", help="Skip detection losses")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = setup_host(force_cpu=args.cpu)
    if args.config_path:
        return train_end_to_end(args.config_path, max_epochs=args.epochs, train_detection=not args.no_detection,
                                device=device)

    base = tempfile.mkdtemp(prefix="mgu_e2e_smoke_")
    try:
        cfg_dir = make_dummy_run(base, num_images=4, image_size=(64, 64), batch_size=2, num_epochs=2, patch_size=16)
        state, history = train_end_to_end(cfg_dir, max_epochs=args.epochs or 2, device=device)
        print(f"[smoke] epoch losses: {history['epoch_loss']}")
        print("[smoke] train_end_to_end OK")
        return state, history
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
