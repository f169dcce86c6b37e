"""Faults planted under a cell's timed path, for the readings that set the
limits (``calibrate.py --fault``) and for the tests that see ``correct``
come out false. Each takes the driver before its set-up.

- ``unchanged``: the optimizer step leaves the train state as it was.
- ``half_batch``: the step (or the request) sees the first half of the
  batch's rows; a request's other rows come back as zeros.
- ``altered``: one value of a request's first output is changed where it
  is produced.
"""

from __future__ import annotations

import torch

FAULTS = {"train": ("unchanged", "half_batch"), "serve": ("altered", "half_batch")}


def plant(driver, fault: str) -> None:
    if fault not in FAULTS[driver.kind]:
        raise ValueError(f"no fault {fault!r} for a {driver.kind} cell")
    if fault == "unchanged":
        from mingraph_unet_tpu_torch.train.common import TrainState

        driver.restore = (TrainState, TrainState.apply_gradients)
        TrainState.apply_gradients = lambda self: None
    elif driver.kind == "train":  # half_batch
        def run_step(t: int):
            imgs, masks = driver.pool[t % len(driver.pool)]
            half = imgs.shape[0] // 2
            return driver.step(driver.state, imgs[:half], masks[:half], driver.gen)

        driver.run_step = run_step
    else:
        forward = driver.forward

        def broken(x_host):
            if fault == "altered":
                out = forward(x_host)
                k = driver.keys[0]
                out[k] = out[k].clone()
                out[k].view(-1)[0] += 1.0 + out[k].abs().max()
                return out
            half = x_host.shape[0] // 2
            out = forward(x_host[:half])
            return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in out.items()}

        driver.forward = broken


def lift(driver) -> None:
    """Undo a fault that outlives its driver (a patched class)."""
    restore = getattr(driver, "restore", None)
    if restore is not None:
        cls, fn = restore
        cls.apply_gradients = fn
