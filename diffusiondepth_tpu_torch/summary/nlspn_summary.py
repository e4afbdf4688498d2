"""NLSPN summary writer (port of ``diffusiondepth_tpu/summary/nlspn_summary.py``).

The ``Diffusion_DCbase_Summary`` logs, plus NLSPN's own:

* ``update``: an ``Etc/gamma`` scalar (the affinity scale), and a panel
  rgb | dep | pred | gt | confidence, the depths over ``max_depth`` and the
  confidence in [0, 1], all in plasma.
* ``save``: with ``save_result_only`` the KITTI submission PNG; otherwise a
  directory per sample with 01_rgb, 02_dep, 03_pred_init, 04_pred_prop_<k>
  (one per propagation step), 05_pred_final and its gray copy, 06_gt, and
  the raw ``guidance``, ``offset``, ``aff`` and ``gamma`` as ``.npy``.

``SAVE_KEYS`` names the model outputs the runtime fetches from the eval
step for these files (``make_eval_step(extra_keys=...)``). PNGs are
written by the port's own writer.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..native.png import write_png
from ..ops.vis import colormap_255
from .diffusion_dcbase_summary import IMAGENET_MEAN, IMAGENET_STD, Diffusion_DCbase_Summary


class NLSPNSummary(Diffusion_DCbase_Summary):
    SAVE_KEYS = ("guidance", "offset", "aff", "gamma", "confidence", "pred_init", "pred_inter")

    def update(self, global_step: int, sample: Optional[Dict] = None,
               output: Optional[Dict] = None):
        if output is not None and "gamma" in output:
            self.add_scalar("Etc/gamma", float(np.ravel(output["gamma"])[0]), global_step)
        return super().update(global_step, sample, output)

    def _write_panel(self, global_step: int, sample: Dict, output: Dict):
        max_depth = self.args.max_depth
        rgb = np.asarray(sample["rgb"], np.float32)
        rgb = np.clip(rgb * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)
        dep = np.clip(np.asarray(sample["dep"], np.float32), 0, max_depth)
        gt = np.clip(np.asarray(sample["gt"], np.float32), 0, max_depth)
        pred = np.clip(np.asarray(output["pred"], np.float32), 0, max_depth)
        conf = output.get("confidence")
        conf = (np.clip(np.asarray(conf, np.float32), 0.0, 1.0)
                if conf is not None else np.zeros_like(dep))

        n = min(rgb.shape[0], self.args.num_summary)
        rows = []
        for b in range(n):
            cols = [rgb[b]]
            for m in (dep[b, ..., 0] / max_depth, pred[b, ..., 0] / max_depth,
                      gt[b, ..., 0] / max_depth, conf[b, ..., 0]):
                cols.append(colormap_255(255.0 * m))
            rows.append(np.concatenate(cols, axis=1))
        panel = (np.concatenate(rows, axis=0) * 255).astype(np.uint8)

        img_dir = os.path.join(self.log_dir, self.mode, "images")
        os.makedirs(img_dir, exist_ok=True)
        write_png(os.path.join(img_dir, f"step_{global_step:06d}.png"), panel)
        self.add_image(self.mode + "/images", panel, global_step)

    def _save_one(self, epoch: int, idx: int, sample: Dict, pred: np.ndarray,
                  extras: Optional[Dict] = None):
        if self.args.save_result_only:
            return super()._save_one(epoch, idx, sample, pred, extras)
        self.make_dir(epoch, idx)
        extras = extras or {}
        max_depth = self.args.max_depth

        def path(name):
            return os.path.join(self.path_output, name)

        rgb = np.asarray(sample["rgb"], np.float32)
        rgb = np.clip(rgb * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)
        write_png(path("01_rgb.png"), (rgb * 255).astype(np.uint8))

        def depth_png(name: str, m: np.ndarray):
            img = colormap_255(255.0 * np.clip(m, 0, max_depth) / max_depth)
            write_png(path(name), (img * 255).astype(np.uint8))

        depth_png("02_dep.png", np.asarray(sample["dep"], np.float32)[..., 0])
        if "pred_init" in extras:
            depth_png("03_pred_init.png", extras["pred_init"][..., 0])
        if "pred_inter" in extras:  # (prop_time, H, W, 1), one map per step
            for k in range(extras["pred_inter"].shape[0]):
                depth_png(f"04_pred_prop_{k:02d}.png", extras["pred_inter"][k, ..., 0])
        depth_png("05_pred_final.png", pred)
        write_png(path("05_pred_final_gray.png"),
                  (255.0 * np.clip(pred / max_depth, 0, 1)).astype(np.uint8))
        depth_png("06_gt.png", np.asarray(sample["gt"], np.float32)[..., 0])

        for key in ("guidance", "offset", "aff", "gamma"):
            if key in extras:
                np.save(path(f"{key}.npy"), extras[key])
        if self.args.save_raw_npdepth:
            np.save(path("pred.npy"), pred)
