"""Step-indexed checkpoints with best-metric retention and exact resume.
Counterpart of ``mingraph_unet_tpu/train/checkpoint.py`` (whose Orbax
manager has the same retention rules); the port's format is its own:
``torch.save`` of the state dict per step (``step_<n>.pt``) and a JSON index
of the kept steps and their metrics. It does not read Orbax checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Keeps ``max_to_keep`` checkpoints: the newest, or with
    ``best_metric`` the best by that key of the ``metrics`` given to
    :meth:`save` (``best_mode`` 'min' or 'max')."""

    INDEX = "checkpoints.json"

    def __init__(self, directory: str, max_to_keep: int = 3, best_metric: Optional[str] = None,
                 best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode
        path = os.path.join(self.directory, self.INDEX)
        self._index: Dict[int, Dict[str, float]] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._index = {int(k): v for k, v in json.load(f).items()}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _by_metric(self) -> List[int]:
        """Kept steps, best first (ties: the older first)."""
        sign = 1.0 if self.best_mode == "min" else -1.0
        return sorted(self._index, key=lambda s: (sign * self._index[s][self.best_metric], s))

    def all_steps(self) -> List[int]:
        return sorted(self._index)

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._index) if self._index else None

    @property
    def best_step(self) -> Optional[int]:
        if not self.best_metric or not self._index:
            return None
        return self._by_metric()[0]

    def save(self, step: int, state: Dict[str, Any], metrics: Optional[Dict[str, float]] = None) -> None:
        """Write ``state`` (tensors, numbers, lists and dicts of them) as
        checkpoint ``step``, then drop what retention no longer keeps."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        if self.best_metric and self.best_metric not in metrics:
            raise ValueError(f"save needs the metric {self.best_metric!r} for best-metric retention")
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        self._index[step] = metrics
        kept = self._by_metric() if self.best_metric else sorted(self._index, reverse=True)
        for old in kept[self.max_to_keep :]:
            del self._index[old]
            os.remove(self._path(old))
        tmp = os.path.join(self.directory, self.INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._index.items()}, f)
        os.replace(tmp, os.path.join(self.directory, self.INDEX))

    def restore(self, step: int, map_location=None) -> Dict[str, Any]:
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def restore_latest(self, map_location=None) -> Optional[Dict[str, Any]]:
        """The newest kept checkpoint, or None when there is none."""
        step = self.latest_step
        return None if step is None else self.restore(step, map_location)
