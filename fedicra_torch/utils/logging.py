"""Metrics logging: JSONL always, TensorBoard when available.

Counterpart of ``fedicra_tpu/utils/logging.py``; nothing depends on
tensorboardX being installed.

The reference logs through tensorboardX on the server only
(flower_common.py:269-283, 309-336). We write a machine-readable JSONL
stream as the primary record and mirror scalars to TensorBoard if
tensorboardX is importable.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float]):
        scalars = {
            k: float(v)
            for k, v in metrics.items()
            if isinstance(v, (int, float)) or getattr(v, "ndim", None) == 0
        }
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def write_image(self, step: int, tag: str, image):
        """HWC or HW array -> TensorBoard image (reference MyServer parity:
        per-client Image/Prediction/GroundTruth grids, flower_common.py:269-283)."""
        if self._tb is None:
            return
        import numpy as np

        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = arr[..., None]
        lo, hi = arr.min(), arr.max()
        arr = (arr - lo) / (hi - lo + 1e-8)
        self._tb.add_image(tag, arr, step, dataformats="HWC")

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
