"""Data layer: ``get(args)`` resolves the dataset class by
``args.data_name``. A dataset yields NHWC numpy dicts {rgb, dep, gt, K,
depth_mask, depth_map}; ``DataLoader`` shuffles, shards per host, decodes
on threads and batches."""

from .loader import DataLoader
from .synthetic import Synthetic


def get(args):
    name = args.data_name
    if name == "KITTIDC":
        from .kittidc import KITTIDC

        return KITTIDC
    if name == "Synthetic":
        return Synthetic
    if name == "NYU":
        from .nyu import NYU

        return NYU
    raise NotImplementedError(f"dataset {name!r}")


__all__ = ["get", "DataLoader", "Synthetic"]
