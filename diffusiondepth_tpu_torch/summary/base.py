"""BaseSummary: accumulate per-batch loss and metric rows, write epoch
means (port of ``diffusiondepth_tpu/summary/base.py``).

``loss_{mode}.txt`` and ``metric_{mode}.txt`` are truncated at
construction and get one line per epoch. Scalars go to a grep-able
``scalars_{mode}.jsonl`` and to a TensorBoard event file per mode
(``tb_events.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from .tb_events import EventFileWriter


class BaseSummary:
    def __init__(self, log_dir: str, mode: str, args):
        self.log_dir = log_dir
        self.mode = mode
        self.args = args

        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(os.path.join(log_dir, mode), exist_ok=True)

        self.loss = []
        self.metric = []

        self.f_loss = os.path.join(log_dir, f"loss_{mode}.txt")
        self.f_metric = os.path.join(log_dir, f"metric_{mode}.txt")
        self.f_scalars = os.path.join(log_dir, f"scalars_{mode}.jsonl")
        open(self.f_loss, "w").close()
        open(self.f_metric, "w").close()
        open(self.f_scalars, "w").close()
        self.writer = EventFileWriter(os.path.join(log_dir, mode))

    def add_scalar(self, tag: str, value: float, step: int):
        with open(self.f_scalars, "a") as f:
            f.write(json.dumps({"step": int(step), "tag": tag, "value": float(value)}) + "\n")
        self.writer.add_scalar(tag, value, step)

    def add_image(self, tag: str, image: np.ndarray, step: int):
        """HWC uint8 image summary."""
        self.writer.add_image(tag, image, step)

    def flush(self):
        self.writer.flush()

    def add(self, loss: Optional[np.ndarray] = None, metric: Optional[np.ndarray] = None):
        """Append one batch's (1, n) loss and metric rows (numpy arrays or
        tensors)."""
        if loss is not None:
            self.loss.append(np.asarray(loss))
        if metric is not None:
            self.metric.append(np.asarray(metric))

    def _mean(self, rows) -> Optional[np.ndarray]:
        if not rows:
            return None
        return np.mean(np.concatenate(rows, axis=0), axis=0, keepdims=True)

    def _format_line(self, kind: str, names: Sequence[str], vals: np.ndarray) -> str:
        """The reference's line format."""
        msg = [" {:<9s}|  ".format(kind)]
        for idx, name in enumerate(names):
            msg += ["{:<s}: {:.4f}  ".format(name, float(vals[0, idx]))]
            if (idx + 1) % 10 == 0:
                msg += ["\n             "]
        return "".join(msg)

    def reset(self):
        self.loss = []
        self.metric = []
