"""Metric logging: a JSONL file plus a console echo.

Counterpart of ``enf_pde_tpu/train/logging.py`` without wandb, with the same metric
names (``mse_step``, ``train_mse_epoch``, ``{val,train}_mse_{in,out}_t``,
``*_dp{5,10,50}``, ``equivariance_err_*``) and figures recorded by their path.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["MetricLogger", "NullLogger"]


class MetricLogger:
    """Appends one JSON record per ``log`` call to ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None, echo: bool = False):
        record = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            record["step"] = step
        record.update({k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()})
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if echo:
            parts = " ".join(
                f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()
            )
            print(parts, file=sys.stderr)

    def log_image(self, name: str, path: str, step: Optional[int] = None):
        """Record a figure: its path in the JSONL stream."""
        record = {"t": round(time.time() - self._t0, 3), name: path}
        if step is not None:
            record["step"] = step
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


class NullLogger:
    """A ``MetricLogger`` that records nothing: the logger of a data-parallel run's
    ranks other than 0, which log through rank 0."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None, echo: bool = False):
        pass

    def log_image(self, name: str, path: str, step: Optional[int] = None):
        pass

    def close(self):
        pass
