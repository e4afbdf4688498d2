"""KITTI Depth Completion dataset (port of ``diffusiondepth_tpu/data/kittidc.py``).

16-bit PNG depth decoded as value / 256, KITTI calibration parsing, and the
K-aware augmentation chain of training: top crop, hflip (fixes cx), ±5°
rotation (bicubic RGB, nearest depth), fixed-order colour jitter, a
1.0-1.5x shorter-side scale with K scaled and depth divided by the scale,
a random crop with the principal point shifted, ImageNet normalisation;
``depth_map`` is the sparse depth, densified by ip_basic under
``--ip_basic``.
Images are numpy arrays (``transforms``); the PNGs are decoded by the
port's own reader (``native/png.py``). The split JSON maps each of
'train', 'val' and 'test' to entries {rgb, depth, gt, K} of paths under
``dir_data``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np

from ..native.png import read_png
from . import transforms as T
from .ip_basic import densify_depth_map


def read_depth(file_name: str) -> np.ndarray:
    """16-bit PNG -> metres (/ 256)."""
    assert os.path.exists(file_name), f"file not found: {file_name}"
    image_depth = read_png(file_name)
    if image_depth.dtype != np.uint16 or image_depth.ndim != 2:
        raise ValueError(f"{file_name}: a depth map is a 16-bit grayscale PNG")
    assert (np.max(image_depth) == 0) or (np.max(image_depth) > 255), (
        f"np.max(depth_png)={np.max(image_depth)}, path={file_name}"
    )
    return image_depth.astype(np.float32) / 256.0


def read_calib_file(filepath: str) -> Dict[str, np.ndarray]:
    """KITTI calib txt -> {key: values}; lines whose values are not all
    numbers are left out."""
    data = {}
    with open(filepath) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


class KITTIDC:
    def __init__(self, args, mode):
        assert mode in ("train", "val", "test"), mode
        self.args = args
        self.mode = mode
        self.height = args.patch_height
        self.width = args.patch_width
        self.augment = args.augment
        with open(args.split_json) as f:
            self.sample_list = json.load(f)[mode]

    def __len__(self):
        return len(self.sample_list)

    def _load_data(self, idx):
        entry = self.sample_list[idx]
        dd = self.args.dir_data
        rgb = read_png(os.path.join(dd, entry["rgb"]))
        depth = read_depth(os.path.join(dd, entry["depth"]))
        gt = read_depth(os.path.join(dd, entry["gt"]))
        path_calib = os.path.join(dd, entry["K"])

        if self.mode in ("train", "val"):
            calib = read_calib_file(path_calib)
            if "image_02" in entry["rgb"]:
                K_cam = np.reshape(calib["P_rect_02"], (3, 4))
            elif "image_03" in entry["rgb"]:
                K_cam = np.reshape(calib["P_rect_03"], (3, 4))
            else:
                raise ValueError(entry["rgb"])
            K = [K_cam[0, 0], K_cam[1, 1], K_cam[0, 2], K_cam[1, 2]]
        else:
            with open(path_calib) as f:
                vals = f.readline().split(" ")
            K = [float(vals[0]), float(vals[4]), float(vals[2]), float(vals[5])]

        assert T.size(rgb) == T.size(depth) == T.size(gt)
        return rgb, depth, gt, list(map(float, K))

    def _top_crop(self, rgb, depth, gt, K):
        tc = self.args.top_crop
        if tc > 0:
            w, h = T.size(rgb)
            rgb = T.crop(rgb, tc, 0, h - tc, w)
            depth = T.crop(depth, tc, 0, h - tc, w)
            gt = T.crop(gt, tc, 0, h - tc, w)
            K[3] = K[3] - tc
        return rgb, depth, gt, K

    def __getitem__(self, idx, seed=None) -> Dict[str, np.ndarray]:
        rng = random.Random(seed)
        rgb, depth, gt, K = self._load_data(idx)

        if self.augment and self.mode == "train":
            rgb, depth, gt, K = self._top_crop(rgb, depth, gt, K)
            width, height = T.size(rgb)

            _scale = rng.uniform(1.0, 1.5)
            scale = int(height * _scale)
            degree = rng.uniform(-5.0, 5.0)
            flip = rng.uniform(0.0, 1.0)

            if flip > 0.5:
                rgb, depth, gt = T.hflip(rgb), T.hflip(depth), T.hflip(gt)
                K[2] = width - K[2]

            rgb = T.rotate(rgb, degree, T.BICUBIC)
            depth = T.rotate(depth, degree, T.NEAREST)
            gt = T.rotate(gt, degree, T.NEAREST)

            # fixed-order jitter
            rgb = T.adjust_brightness(rgb, rng.uniform(0.6, 1.4))
            rgb = T.adjust_contrast(rgb, rng.uniform(0.6, 1.4))
            rgb = T.adjust_saturation(rgb, rng.uniform(0.6, 1.4))

            rgb = T.resize_shorter(rgb, scale, T.BICUBIC)
            depth = T.resize_shorter(depth, scale, T.NEAREST)
            gt = T.resize_shorter(gt, scale, T.NEAREST)

            K = [K[0] * _scale, K[1] * _scale, K[2] * _scale, K[3] * _scale]

            width, height = T.size(rgb)
            assert self.height <= height and self.width <= width, (
                "patch size is larger than the input size"
            )
            h_start = rng.randint(0, height - self.height)
            w_start = rng.randint(0, width - self.width)
            rgb = T.crop(rgb, h_start, w_start, self.height, self.width)
            depth = T.crop(depth, h_start, w_start, self.height, self.width)
            gt = T.crop(gt, h_start, w_start, self.height, self.width)
            K[2] -= w_start
            K[3] -= h_start

            rgb_np = T.rgb_to_normalized_array(rgb)
            dep_np = T.depth_to_array(depth) / _scale
            gt_np = T.depth_to_array(gt) / _scale
        elif self.mode in ("train", "val"):
            rgb, depth, gt, K = self._top_crop(rgb, depth, gt, K)
            width, height = T.size(rgb)
            assert self.height <= height and self.width <= width
            h_start = rng.randint(0, height - self.height)
            w_start = rng.randint(0, width - self.width)
            rgb = T.crop(rgb, h_start, w_start, self.height, self.width)
            depth = T.crop(depth, h_start, w_start, self.height, self.width)
            gt = T.crop(gt, h_start, w_start, self.height, self.width)
            K[2] -= w_start
            K[3] -= h_start
            rgb_np = T.rgb_to_normalized_array(rgb)
            dep_np = T.depth_to_array(depth)
            gt_np = T.depth_to_array(gt)
        else:
            if self.args.top_crop > 0 and self.args.test_crop:
                rgb, depth, gt, K = self._top_crop(rgb, depth, gt, K)
            rgb_np = T.rgb_to_normalized_array(rgb)
            dep_np = T.depth_to_array(depth)
            gt_np = T.depth_to_array(gt)

        if self.args.num_sample > 0:
            dep_np = T.sparse_sample(dep_np, self.args.num_sample, rng)

        depth_mask = (dep_np > 0).astype(np.float32)
        # KITTI keeps the raw sparse map as depth_map, densified by ip_basic
        # under --ip_basic
        depth_map = dep_np.copy()
        if getattr(self.args, "ip_basic", False):
            depth_map = densify_depth_map(depth_map, depth_mask)
        return {
            "rgb": rgb_np,
            "dep": dep_np,
            "gt": gt_np,
            "K": np.asarray(K, np.float32),
            "depth_mask": depth_mask,
            "depth_map": depth_map,
        }
