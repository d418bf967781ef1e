"""Metric writer: ``metrics.jsonl`` under the log directory always;
TensorBoard when ``torch.utils.tensorboard`` imports; wandb with ``--log``
when it imports (the reference gates wandb the same way,
``train.py:429-432``).  TensorBoard's import is deferred to the first
write, so a run that writes nothing does not pay for it."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, logdir: Optional[str] = None, use_wandb: bool = False):
        self._logdir = logdir
        self._tb = None
        self._tb_tried = False
        self._wandb = None
        self._jsonl = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb
            except ImportError:
                pass
            else:
                wandb.init(project="ucnerf_torch")
                self._wandb = wandb

    def _tensorboard(self):
        if not self._tb_tried and self._logdir:
            self._tb_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(self._logdir)
        return self._tb

    def write(self, step: int, metrics: Dict[str, float]):
        tb = self._tensorboard()
        if tb is not None:
            for k, v in metrics.items():
                tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"step": step, "t": time.time(),
                 **{k: float(v) for k, v in metrics.items()}}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
