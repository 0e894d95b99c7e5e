"""Scalar telemetry, the port's copy of ``tpugan_tpu/utils/logging.py``: the
six per-step scalars of the reference (train_tempo.py:253-254) go to a
``metrics.jsonl`` file always, and to TensorBoard when ``tensorboardX``
imports. The port's train step returns host floats, so a flush writes the
queued rows without another device read.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List


class MetricWriter:
    def __init__(self, log_dir: str, flush_every: int = 20):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self.flush_every = flush_every
        self._pending: List[tuple] = []
        try:
            from tensorboardX import SummaryWriter  # optional

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._tb = None

    def add(self, step: int, metrics: Dict) -> None:
        """Queue a step's scalars; written every ``flush_every`` steps."""
        self._pending.append((step, metrics))
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        for step, metrics in self._pending:
            host = {k: float(v) for k, v in metrics.items()}
            self._jsonl.write(json.dumps({"step": step, **host}) + "\n")
            if self._tb is not None:
                for k, v in host.items():
                    self._tb.add_scalar(k, v, global_step=step)
        self._pending.clear()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Data-wait / step wall-time split, like the reference's tqdm telemetry
    (train_tempo.py:205,237; train_msr.py:225-227 compute_efficiency)."""

    def __init__(self):
        self._t = time.time()
        self.prepare_time = 0.0
        self.process_time = 0.0

    def data_ready(self):
        now = time.time()
        self.prepare_time = now - self._t
        self._t = now

    def step_done(self):
        now = time.time()
        self.process_time = now - self._t
        self._t = now

    @property
    def compute_efficiency(self) -> float:
        total = self.prepare_time + self.process_time
        return self.process_time / total if total else 0.0
