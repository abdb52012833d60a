"""Scalar logging (counterpart of gens_tpu/utils/meters.py): running means
and a jsonl sink, with TensorBoard beside it when tensorboardX imports."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class DictAverageMeter:
    """Running mean of scalar dicts."""

    def __init__(self):
        self.sum: Dict[str, float] = {}
        self.count = 0

    def update(self, scalars: Dict[str, float]):
        self.count += 1
        for k, v in scalars.items():
            self.sum[k] = self.sum.get(k, 0.0) + float(v)

    @property
    def avg_data(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.sum.items()}


class MetricsLogger:
    """Appends one JSON record a call to ``<log_dir>/metrics.jsonl``
    (``mode``, ``step``, ``time`` and the scalars) and, when tensorboardX
    imports, writes the scalars to TensorBoard as ``<mode>/<name>``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(log_dir)

    def log(self, mode: str, scalars: Dict[str, float], step: int):
        rec = {"mode": mode, "step": step, "time": time.time(), **scalars}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{mode}/{k}", v, step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
            self.tb = None
