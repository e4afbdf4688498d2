"""Synthetic dataset for tests and benchmarks: random scenes with a
smooth depth field (no files needed). The same draws as the JAX package's
``Synthetic`` for the same seed and index."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .ip_basic import densify_depth_map


class Synthetic:
    def __init__(self, args, mode):
        self.args = args
        self.mode = mode
        self.height = args.patch_height
        self.width = args.patch_width
        self._len = {"train": 64, "val": 16, "test": 16}[mode]

    def __len__(self):
        return self._len

    def __getitem__(self, idx, seed=None) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(((seed or 0) * 100003 + idx) % (2**31 - 1))
        h, w = self.height, self.width
        # smooth random depth field in (0.5, max_depth * 0.9)
        base = rng.rand(h // 8 + 1, w // 8 + 1).astype(np.float32)
        gt = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
        gt = 0.5 + gt * min(self.args.max_depth * 0.9, 80.0)
        rgb = np.stack([gt / gt.max()] * 3, -1) + 0.1 * rng.randn(h, w, 3)
        gt = gt[..., None]
        dep = gt * (rng.rand(h, w, 1) > 0.95)
        depth_mask = (dep > 0).astype(np.float32)
        depth_map = dep.astype(np.float32)
        if getattr(self.args, "ip_basic", False):
            depth_map = densify_depth_map(depth_map, depth_mask)
        return {
            "rgb": rgb.astype(np.float32),
            "dep": dep.astype(np.float32),
            "gt": gt.astype(np.float32),
            "K": np.asarray([500.0, 500.0, w / 2, h / 2], np.float32),
            "depth_mask": depth_mask,
            "depth_map": depth_map,
        }
