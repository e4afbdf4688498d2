"""NYUDepthV2 dataset, HDF5 per-sample files (port of
``diffusiondepth_tpu/data/nyu.py``).

Each file holds ``rgb`` (3, 480, 640) uint8 and ``depth`` (480, 640)
float32, read by the port's own HDF5 reader (``native/hdf5.py``). Training
with augmentation draws a 1.0-1.5x scale, a ±5° rotation and a flip, then:
hflip, nearest rotation of both images, a bilinear resize of the shorter
side to ``int(240 * scale)``, colour jitter 0.4/0.4/0.4 in random order
(RGB), a centre crop to 228x304, depth / scale and the focal lengths
times the scale. Otherwise: the shorter side to 240, the centre crop. The
crop is always 228x304 (``--patch_height/width`` are not read). The
sparse depth is ``--num_sample`` points of the dense depth; ``depth_map``
is its scanline completion, or ``densify_depth_map`` under ``--ip_basic``.

Split json: {"train": [{"filename": ...}], "val": [...], "test": [...]},
paths under ``dir_data`` (``tools/generate_json.py`` writes it).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np

from ..native.hdf5 import read_datasets
from . import transforms as T
from .depth_completion import simple_depth_completion
from .ip_basic import densify_depth_map

HEIGHT, WIDTH = 240, 320
CROP_SIZE = (228, 304)

# the intrinsics at half resolution, shifted by the crop (reference
# src/data/nyu.py:75-80)
K_NYU = np.asarray(
    [
        5.1885790117450188e02 / 2.0,
        5.1946961112127485e02 / 2.0,
        3.2558244941119034e02 / 2.0 - 8.0,
        2.5373616633400465e02 / 2.0 - 6.0,
    ],
    np.float32,
)


class NYU:
    def __init__(self, args, mode):
        assert mode in ("train", "val", "test"), mode
        self.args = args
        self.mode = mode
        self.augment = args.augment
        with open(args.split_json) as f:
            self.sample_list = json.load(f)[mode]

    def __len__(self):
        return len(self.sample_list)

    def __getitem__(self, idx, seed=None) -> Dict[str, np.ndarray]:
        rng = random.Random(seed)
        path = os.path.join(self.args.dir_data, self.sample_list[idx]["filename"])
        f = read_datasets(path, ("rgb", "depth"))
        rgb = np.ascontiguousarray(f["rgb"].transpose(1, 2, 0))
        dep = f["depth"].astype(np.float32)

        if self.augment and self.mode == "train":
            _scale = rng.uniform(1.0, 1.5)
            scale = int(HEIGHT * _scale)
            degree = rng.uniform(-5.0, 5.0)
            flip = rng.uniform(0.0, 1.0)

            if flip > 0.5:
                rgb = T.hflip(rgb)
                dep = T.hflip(dep)

            rgb = T.rotate(rgb, degree, T.NEAREST)
            dep = T.rotate(dep, degree, T.NEAREST)

            rgb = T.resize_shorter(rgb, scale, T.BILINEAR)
            rgb = T.color_jitter(rgb, 0.4, 0.4, 0.4, rng)
            rgb = T.center_crop(rgb, CROP_SIZE)

            dep = T.resize_shorter(dep, scale, T.BILINEAR)
            dep = T.center_crop(dep, CROP_SIZE)

            rgb_np = T.rgb_to_normalized_array(rgb)
            dep_np = T.depth_to_array(dep) / _scale

            K = K_NYU.copy()
            K[0] *= _scale
            K[1] *= _scale
        else:
            rgb = T.center_crop(T.resize_shorter(rgb, HEIGHT, T.BILINEAR), CROP_SIZE)
            dep = T.center_crop(T.resize_shorter(dep, HEIGHT, T.BILINEAR), CROP_SIZE)
            rgb_np = T.rgb_to_normalized_array(rgb)
            dep_np = T.depth_to_array(dep)
            K = K_NYU.copy()

        dep_sp = T.sparse_sample(dep_np, self.args.num_sample, rng)

        depth_mask = (dep_sp > 0).astype(np.float32)
        if getattr(self.args, "ip_basic", False):
            depth_map = densify_depth_map(dep_sp[..., 0], depth_mask[..., 0])
        else:
            depth_map, _ = simple_depth_completion(dep_sp[..., 0])

        return {
            "rgb": rgb_np,
            "dep": dep_sp,
            "gt": dep_np,
            "K": K,
            "depth_mask": depth_mask,
            "depth_map": depth_map[..., None],
        }
