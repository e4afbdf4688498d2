"""KITTI raw -> the depth-completion layout (the port of
``diffusiondepth_tpu/tools/prepare_kitti.py``).

The reference's prep script (utils/prepare_KITTI_DP.py:45-100): for each
drive sequence under the depth-completion train and val trees it copies
the matching raw-KITTI stereo images (``image_02``, ``image_03``), the oxts
poses and the three calibration files beside the projected depths, the
layout the KITTIDC reader expects. What is already there is kept.

Run:
  python -m diffusiondepth_tpu_torch.tools.prepare_kitti \\
      --path_root_dc /data/kitti_depth --path_root_raw /data/kitti_raw [--symlink]
"""

from __future__ import annotations

import argparse
import os
import shutil

CALIB_FILES = ("calib_cam_to_cam.txt", "calib_imu_to_velo.txt", "calib_velo_to_cam.txt")


def reorganize(path_root_dc: str, path_root_raw: str, use_symlink: bool = False) -> None:
    for root in (path_root_dc, path_root_raw):
        if not os.path.isdir(root):
            raise FileNotFoundError(f"no directory {root}")

    def copy_tree(src, dst):
        if use_symlink:
            os.symlink(os.path.abspath(src), dst)
        else:
            shutil.copytree(src, dst)

    for split in ("train", "val"):
        path_dc = os.path.join(path_root_dc, split)
        if not os.path.isdir(path_dc):
            raise FileNotFoundError(f"no directory {path_dc}")
        for seq in sorted(os.listdir(path_dc)):
            date = seq[:10]  # a drive's name starts with its date directory
            src = os.path.join(path_root_raw, date, seq)
            dst = os.path.join(path_dc, seq)
            try:
                for sub in ("image_02", "image_03", "oxts"):
                    if not os.path.exists(os.path.join(dst, sub)):
                        print(f"copy {src}/{sub} -> {dst}/{sub}")
                        copy_tree(os.path.join(src, sub), os.path.join(dst, sub))
                for calib in CALIB_FILES:
                    target = os.path.join(dst, calib)
                    if not os.path.exists(target):
                        shutil.copy2(os.path.join(path_root_raw, date, calib), target)
            except OSError as e:
                print(f"failed for {seq}: {e}; skipping")
                continue
        print(f"reorganization for {split} finished")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="KITTI DC reorganizer")
    p.add_argument("--path_root_dc", type=str, required=True, help="depth-completion dataset root")
    p.add_argument("--path_root_raw", type=str, required=True, help="raw KITTI root")
    p.add_argument("--symlink", action="store_true", help="symlink instead of copying")
    args = p.parse_args(argv)
    reorganize(args.path_root_dc, args.path_root_raw, args.symlink)


if __name__ == "__main__":
    main()
