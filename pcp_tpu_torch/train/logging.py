"""Training observability: one JSON line per report, plus TensorBoard when
it imports (counterpart of ``pcp_tpu/train/logging.py``; the tags of
prepare_output_and_logger / training_report, train.py:165-243)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class TrainLogger:
    """``use_tensorboard`` defaults to on unless the environment sets
    ``PCP_TENSORBOARD=0``. Only the tests set it: it reaches the ranks
    they start in new processes, where a patched ``TrainLogger`` does
    not."""

    def __init__(self, model_path: str,
                 use_tensorboard: Optional[bool] = None):
        if use_tensorboard is None:
            use_tensorboard = os.environ.get("PCP_TENSORBOARD", "1") != "0"
        self.model_path = model_path
        os.makedirs(model_path, exist_ok=True)
        self.jsonl = open(os.path.join(model_path, "train_log.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(model_path)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": step, "ts": time.time(), **values}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb:
            for k, v in values.items():
                self.tb.add_scalar(k, v, step)

    def histogram(self, step: int, tag: str, values: np.ndarray) -> None:
        if self.tb:
            self.tb.add_histogram(tag, values, step)

    def close(self) -> None:
        self.jsonl.close()
        if self.tb:
            self.tb.close()
