"""Structured metrics logging: the port's own copy of
``mingraph_unet_tpu/utils/logging.py``.

The reference declares ``log_dir`` / ``log_interval`` in
``configs/training.yaml:21-23`` but never writes logs (SURVEY §5). This module
honors them: per-step metric dicts are appended as JSON lines under
``log_dir`` and optionally echoed to stdout every ``log_interval`` steps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, log_dir: Optional[str], run_name: str = "train", log_interval: int = 10, echo: bool = True):
        self.log_interval = max(1, int(log_interval))
        self.echo = echo
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{run_name}-{int(time.time())}.jsonl")
            self._fh = open(path, "a", buffering=1)
            self.path = path
        else:
            self.path = None

    def log(self, step: int, metrics: Dict[str, Any], force: bool = False) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
        if self.echo and (force or step % self.log_interval == 0):
            pretty = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k != "time"
            )
            print(f"[metrics] {pretty}", flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
