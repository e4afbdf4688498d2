"""Split-json generators for NYUDepthV2 and KITTI-DP (port of
``diffusiondepth_tpu/tools/generate_json.py``).

The reference's dataset-prep scripts (utils/generate_json_NYUDepthV2.py,
utils/generate_json_KITTI_DP.py) as one module with two entry points.
Output json schemas are byte-compatible:

  NYU:   {"train": [{"filename": ...}], "val": [...], "test": [...]}
  KITTI: {"train": [{"rgb", "depth", "gt", "K"}], "val": [...], "test": [...]}

Run:
  python -m diffusiondepth_tpu_torch.tools.generate_json nyu   --path_root ... [...]
  python -m diffusiondepth_tpu_torch.tools.generate_json kitti --path_root ... [...]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
from typing import Dict, List


def _exists(root: str, rel: str) -> bool:
    return os.path.exists(os.path.join(root, rel))


# ----------------------------------------------------------------- NYU
def generate_nyu_json(
    path_root: str,
    csv_train: str,
    csv_test: str,
    val_ratio: float = 0.05,
    num_train: int = 10**8,
    num_val: int = 10**8,
    num_test: int = 10**8,
    seed: int = 7240,
    csv_prefix_strip: int = 19,
) -> Dict[str, List[Dict]]:
    """NYU HDF5 split json (reference generate_json_NYUDepthV2.py:67-160):
    train/val sampled from the train csv by ratio; test = sorted
    ``val/official`` directory listing."""
    rng = random.Random(seed)

    def read_csv_col0(path):
        with open(path) as f:
            return [row[0] for row in csv.reader(f) if row]

    train_files = read_csv_col0(csv_train)
    idx = list(range(len(train_files)))
    rng.shuffle(idx)

    n_val = int(len(train_files) * val_ratio)
    n_train = len(train_files) - n_val
    idx_train = idx[: min(n_train, num_train)]
    idx_val = idx[n_train : n_train + min(n_val, num_val)]

    out: Dict[str, List[Dict]] = {
        # the reference strips the csv's leading path prefix (:98)
        "train": [{"filename": train_files[i][csv_prefix_strip:]} for i in idx_train],
        "val": [{"filename": train_files[i][csv_prefix_strip:]} for i in idx_val],
    }
    official = sorted(os.listdir(os.path.join(path_root, "val", "official")))
    out["test"] = [{"filename": f"val/official/{f}"} for f in official[:num_test]]
    return out


# ----------------------------------------------------------------- KITTI
def generate_kitti_json(
    path_root: str,
    num_train: int = 10**8,
    num_val: int = 10**8,
    num_test: int = 10**8,
    seed: int = 7240,
) -> Dict[str, List[Dict]]:
    """KITTI-DP split json (reference generate_json_KITTI_DP.py:56-170):
    walks train/val drives x {image_02, image_03}, pairs rgb / velodyne_raw /
    groundtruth / calib, validates existence; test split from
    depth_selection/val_selection_cropped with per-image intrinsics."""
    rng = random.Random(seed)
    out: Dict[str, List[Dict]] = {}

    for split in ("train", "val"):
        base = os.path.join(path_root, split)
        pairs = []
        for seq in sorted(os.listdir(base)) if os.path.isdir(base) else []:
            for cam in ("image_02", "image_03"):
                ddir = os.path.join(base, seq, "proj_depth", "velodyne_raw", cam)
                if not os.path.isdir(ddir):
                    continue
                for name in sorted(os.listdir(ddir)):
                    sample = {
                        "rgb": f"{split}/{seq}/{cam}/data/{name}",
                        "depth": f"{split}/{seq}/proj_depth/velodyne_raw/{cam}/{name}",
                        "gt": f"{split}/{seq}/proj_depth/groundtruth/{cam}/{name}",
                        "K": f"{split}/{seq}/calib_cam_to_cam.txt",
                    }
                    if all(_exists(path_root, v) for v in sample.values()):
                        pairs.append(sample)
        out[split] = pairs

    sel = "depth_selection/val_selection_cropped"
    vdir = os.path.join(path_root, sel, "velodyne_raw")
    pairs = []
    for name in sorted(os.listdir(vdir)) if os.path.isdir(vdir) else []:
        head, _, tail = name.partition("velodyne_raw")
        sample = {
            "rgb": f"{sel}/image/{head}image{tail}",
            "depth": f"{sel}/velodyne_raw/{name}",
            "gt": f"{sel}/groundtruth_depth/{head}groundtruth_depth{tail}",
            "K": f"{sel}/intrinsics/{head}image{tail[:-4]}.txt",
        }
        if all(_exists(path_root, v) for v in sample.values()):
            pairs.append(sample)
    out["test"] = pairs

    rng.shuffle(out["train"])
    for split, cap in (("train", num_train), ("val", num_val), ("test", num_test)):
        if len(out[split]) > cap:
            rng.shuffle(out[split])
            out[split] = out[split][:cap]
    return out


def generate_kitti_test_json(path_root: str) -> Dict[str, List[Dict]]:
    """KITTI online-submission ("anonymous") split json (reference
    generate_json_KITTI_DP.py:176-225, the ``--test_data`` mode): one
    test-only split over ``depth_selection/test_depth_prediction_anonymous``
    images + per-image intrinsics. The depth/gt fields point at the
    reference's dummy placeholder (a velodyne frame of the completion set,
    :190) - the prediction server provides no sparse depth or ground truth."""
    sel = "depth_selection/test_depth_prediction_anonymous"
    dummy = ("depth_selection/test_depth_completion_anonymous/"
             "velodyne_raw/0000000000.png")
    img_dir = os.path.join(path_root, sel, "image")
    pairs = []
    for name in sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []:
        sample = {
            "rgb": f"{sel}/image/{name}",
            "depth": dummy,
            "gt": dummy,
            "K": f"{sel}/intrinsics/{name[:-4]}.txt",
        }
        if all(_exists(path_root, v) for v in sample.values()):
            pairs.append(sample)
    return {"test": pairs}


def main(argv=None):
    p = argparse.ArgumentParser(description="split-json generator")
    p.add_argument("dataset", choices=("nyu", "kitti"))
    p.add_argument("--test_data", action="store_true",
                   help="KITTI online-submission (anonymous) test split")
    p.add_argument("--path_root", type=str, required=True)
    p.add_argument("--path_out", type=str, default="../data_json")
    p.add_argument("--name_out", type=str, default=None)
    p.add_argument("--val_ratio", type=float, default=0.05)
    p.add_argument("--csv_train", type=str, default="nyudepth_hdf5_train.csv")
    p.add_argument("--csv_test", type=str, default="nyudepth_hdf5_val.csv")
    p.add_argument("--num_train", type=int, default=10**8)
    p.add_argument("--num_val", type=int, default=10**8)
    p.add_argument("--num_test", type=int, default=10**8)
    p.add_argument("--seed", type=int, default=7240)
    args = p.parse_args(argv)

    if args.dataset == "nyu":
        data = generate_nyu_json(
            args.path_root, args.csv_train, args.csv_test, args.val_ratio,
            args.num_train, args.num_val, args.num_test, args.seed,
        )
        name = args.name_out or "nyu.json"
    elif args.test_data:
        data = generate_kitti_test_json(args.path_root)
        name = args.name_out or "kitti_dp_test.json"
    else:
        data = generate_kitti_json(
            args.path_root, args.num_train, args.num_val, args.num_test, args.seed
        )
        name = args.name_out or "kitti_dc.json"

    os.makedirs(args.path_out, exist_ok=True)
    out_path = os.path.join(args.path_out, name)
    with open(out_path, "w") as f:
        json.dump(data, f, indent=4)
    for split in ("train", "val", "test"):
        if split in data:
            print(f"{split} split : Total {len(data[split])} samples")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
