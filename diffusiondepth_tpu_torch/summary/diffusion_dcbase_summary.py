"""Diffusion_DCbase_ summary writer (port of
``diffusiondepth_tpu/summary/diffusion_dcbase_summary.py``).

``update``: the epoch's mean loss and metric rows to the text logs, the
scalars file and TensorBoard, and a panel (rgb | sparse | pred | gt, depths
in plasma) as a PNG under ``{log_dir}/{mode}/images`` and an image summary.

``save``: per-sample files. With ``save_result_only`` the KITTI submission
PNG ``uint16(pred * 256)`` (and the raw ``.npy`` with
``save_raw_npdepth``); otherwise a directory per sample with rgb, dep,
pred and gt PNGs. Batches are NHWC numpy dicts; PNGs are written by the
port's own writer (``native/png.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..losses import get_loss_names
from ..metrics import METRIC_NAMES
from ..native.png import write_png
from ..ops.vis import colormap_255
from .base import BaseSummary

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _slice_sample(arr: np.ndarray, b: int, batch: int) -> np.ndarray:
    """Sample ``b`` of an output entry: (B, ...) entries on axis 0, the
    stacked (T, B, ...) ones (NLSPN's ``pred_inter``) on axis 1, entries
    without a batch axis (``gamma``, (1,)) whole."""
    if arr.ndim >= 1 and arr.shape[0] == batch:
        return arr[b]
    if arr.ndim >= 2 and arr.shape[1] == batch:
        return arr[:, b]
    return arr


class Diffusion_DCbase_Summary(BaseSummary):
    def __init__(self, log_dir: str, mode: str, args, loss_name=None, metric_name=None):
        super().__init__(log_dir, mode, args)
        self.loss_name = loss_name or get_loss_names(args)
        self.metric_name = metric_name or list(METRIC_NAMES)
        self.path_output = None

    def update(self, global_step: int, sample: Optional[Dict] = None,
               output: Optional[Dict] = None):
        loss_mean = self._mean(self.loss)
        if loss_mean is not None and self.loss_name:
            msg = self._format_line("Loss", self.loss_name, loss_mean)
            for i, name in enumerate(self.loss_name):
                self.add_scalar("Loss/" + name, loss_mean[0, i], global_step)
            print(msg)
            with open(self.f_loss, "a") as f:
                f.write("{:04d} | {}\n".format(global_step, msg))

        metric_mean = self._mean(self.metric)
        if metric_mean is not None:
            msg = self._format_line("Metric", self.metric_name, metric_mean)
            for i, name in enumerate(self.metric_name):
                self.add_scalar("Metric/" + name, metric_mean[0, i], global_step)
            print(msg)
            with open(self.f_metric, "a") as f:
                f.write("{:04d} | {}\n".format(global_step, msg))

        if sample is not None and output is not None:
            self._write_panel(global_step, sample, output)

        self.flush()
        self.reset()
        return metric_mean

    def _write_panel(self, global_step: int, sample: Dict, output: Dict):
        rgb = np.asarray(sample["rgb"], np.float32)
        rgb = np.clip(rgb * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)
        dep = np.clip(np.asarray(sample["dep"], np.float32), 0, self.args.max_depth)
        gt = np.clip(np.asarray(sample["gt"], np.float32), 0, self.args.max_depth)
        pred = np.clip(np.asarray(output["pred"], np.float32), 0, self.args.max_depth)

        n = min(rgb.shape[0], self.args.num_summary)
        rows = []
        for b in range(n):
            cols = [rgb[b]]
            for m in (dep[b, ..., 0], pred[b, ..., 0], gt[b, ..., 0]):
                cols.append(colormap_255(255.0 * m / self.args.max_depth))
            rows.append(np.concatenate(cols, axis=1))
        panel = (np.concatenate(rows, axis=0) * 255).astype(np.uint8)

        img_dir = os.path.join(self.log_dir, self.mode, "images")
        os.makedirs(img_dir, exist_ok=True)
        write_png(os.path.join(img_dir, f"step_{global_step:06d}.png"), panel)
        self.add_image(self.mode + "/images", panel, global_step)

    def make_dir(self, epoch: int, idx: int):
        if self.args.save_result_only:
            self.path_output = os.path.join(self.log_dir, self.mode, f"epoch{epoch:04d}")
        else:
            self.path_output = os.path.join(self.log_dir, self.mode, f"epoch{epoch:04d}",
                                            f"{idx:08d}")
        os.makedirs(self.path_output, exist_ok=True)

    def save(self, epoch: int, idx: int, sample: Dict, output: Dict):
        """Write the files of every sample of the batch. ``idx`` is the
        dataset index of the batch's first sample; sample ``b`` is written
        as index ``idx + b``. Output entries beside ``pred`` (NLSPN's
        propagation internals) reach ``_save_one`` sliced per sample."""
        preds = np.clip(np.asarray(output["pred"], np.float32)[..., 0], 0, None)
        n = preds.shape[0]
        extras_all = {k: np.asarray(v) for k, v in output.items()
                      if k != "pred" and v is not None}
        for b in range(n):
            extras = {k: _slice_sample(v, b, n) for k, v in extras_all.items()}
            self._save_one(epoch, idx + b,
                           {k: np.asarray(v)[b] for k, v in sample.items()
                            if getattr(v, "ndim", 0) >= 1}, preds[b], extras or None)

    def _save_one(self, epoch: int, idx: int, sample: Dict, pred: np.ndarray,
                  extras: Optional[Dict] = None):
        self.make_dir(epoch, idx)
        if self.args.save_result_only:
            # the KITTI submission format
            write_png(os.path.join(self.path_output, f"{idx:010d}.png"),
                      (pred * 256.0).astype(np.uint16))
            if self.args.save_raw_npdepth:
                np.save(os.path.join(self.path_output, f"{idx:010d}.npy"), pred)
            return

        rgb = np.asarray(sample["rgb"], np.float32)
        rgb = np.clip(rgb * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)
        dep = np.asarray(sample["dep"], np.float32)[..., 0]
        gt = np.asarray(sample["gt"], np.float32)[..., 0]

        write_png(os.path.join(self.path_output, "01_rgb.png"), (rgb * 255).astype(np.uint8))
        for name, m in (("02_dep", dep), ("03_pred", pred), ("04_gt", gt)):
            img = colormap_255(255.0 * np.clip(m, 0, self.args.max_depth) / self.args.max_depth)
            write_png(os.path.join(self.path_output, f"{name}.png"),
                      (img * 255).astype(np.uint8))
        if self.args.save_raw_npdepth:
            np.save(os.path.join(self.path_output, "pred.npy"), pred)
