"""Metrics logging: JSONL always, TensorBoard when the config asks for it
(`hybrid_ode_tpu/utils/logging.py`)."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict

logger = logging.getLogger("hybrid_ode_torch")


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = False):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.log_dir))
            except ImportError:
                logger.warning("tensorboard unavailable; logging JSONL only")

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(v) if hasattr(v, "__float__") else v
            if self._tb is not None and isinstance(rec[key], float):
                self._tb.add_scalar(key, rec[key], step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
