"""Batch serving from an exported artifact, with no model-building code:
the port of ``diffusiondepth_tpu/tools/serve.py``.

A serving host needs the ``.pt2`` artifact of ``tools/export_model.py``,
a port checkpoint and this file. It imports the kernels' operator
registrations (``ops/library.py``), the PNG codec (``native/png.py``) and
the checkpoint reader, and nothing of the models or the config system.

It reads RGB PNGs (values / 255, no mean or std: the reference normalises
with ToTensor only) and, optionally, 16-bit sparse-depth PNGs of the same
names (values / 256 m), batches them to the artifact's batch size (the
ragged tail padded by repeating its last frame, the pad then dropped),
draws each batch's starting latent from one ``torch.Generator`` seeded
with ``seed``, in order, runs the artifact, and writes KITTI-submission
PNGs: ``uint16(clip(pred, 0, 255) * 256)``, truncated as the JAX tool's
``_write_pred`` does. Images must be at the artifact's height and width.

CLI:  python -m diffusiondepth_tpu_torch.tools.serve \\
          --artifact model.pt2 --ckpt model_00030.ckpt \\
          --rgb_dir imgs/ [--dep_dir sparse/] --out_dir preds/ [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.export.graph_signature import InputKind
from torch.utils import _pytree as pytree

from ..device import resolve_device
from ..native.png import read_png, write_png
from ..ops import library  # noqa: F401  (the operators the artifact calls)
from ..utils.checkpoint import load_checkpoint


def _load_rgb(path: str) -> np.ndarray:
    img = read_png(path)
    if img.ndim == 2:  # grayscale -> RGB, as Image.convert("RGB")
        img = np.repeat(img[..., None], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def _load_dep(path: str) -> np.ndarray:
    d = read_png(path)
    if d.ndim != 2:
        raise ValueError(f"{path}: a depth PNG is one channel, got shape {d.shape}")
    return (d.astype(np.float32) / 256.0)[..., None]


def pred_to_png(pred: np.ndarray) -> np.ndarray:
    """(H, W, 1) depth in m -> the submission's uint16, 1/256 m per unit,
    by truncation."""
    arr = np.clip(np.asarray(pred[..., 0], np.float32), 0, 255) * 256.0
    return arr.astype(np.uint16)


def artifact_inputs(exported) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The artifact's (batch, init_latent) inputs as fake tensors: their
    shapes, types and device."""
    nodes = {n.name: n for n in exported.graph.nodes if n.op == "placeholder"}
    vals = [nodes[s.arg.name].meta["val"] for s in exported.graph_signature.input_specs
            if s.kind == InputKind.USER_INPUT]
    (batch, latent), _ = pytree.tree_unflatten(vals, exported.call_spec.in_spec)
    return batch, latent


def serve_dir(artifact: str, ckpt: str, rgb_dir: str, out_dir: str,
              dep_dir: Optional[str] = None, seed: int = 0, device=None) -> List[str]:
    """Run the artifact over every PNG of ``rgb_dir``; returns the output
    paths. ``device`` (default: the card) must be the artifact's."""
    dev = resolve_device(device)
    exported = torch.export.load(artifact)
    spec, lat_spec = artifact_inputs(exported)
    if spec["rgb"].device.type != dev.type:
        raise ValueError(f"the artifact runs on {spec['rgb'].device}, not on {dev}")
    module = exported.module()
    module.load_state_dict(load_checkpoint(ckpt)["state_dict"])
    B, H, W, _ = spec["rgb"].shape

    names = sorted(n for n in os.listdir(rgb_dir) if n.endswith(".png"))
    if not names:
        raise FileNotFoundError(f"no .png files in {rgb_dir}")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)

    written = []
    for i0 in range(0, len(names), B):
        chunk = names[i0:i0 + B]
        padded = chunk + [chunk[-1]] * (B - len(chunk))  # ragged tail: repeat the last frame
        rgb = np.stack([_load_rgb(os.path.join(rgb_dir, n)) for n in padded])
        if rgb.shape[1:3] != (H, W):
            raise ValueError(f"input {rgb.shape[1:3]} != artifact {H}x{W}")
        if dep_dir is not None:
            dep = np.stack([_load_dep(os.path.join(dep_dir, n)) for n in padded])
        else:
            dep = np.zeros((B, H, W, 1), np.float32)
        dep_t = torch.from_numpy(dep).to(dev)
        batch = {"rgb": torch.from_numpy(rgb).to(dev), "dep": dep_t, "gt": dep_t,
                 "depth_map": dep_t, "depth_mask": (dep_t > 0).float()}
        lat = torch.randn(tuple(lat_spec.shape), generator=gen, device=dev)
        with torch.no_grad():
            pred = module(batch, lat).float().cpu().numpy()
        for j, name in enumerate(chunk):
            out_path = os.path.join(out_dir, name)
            write_png(out_path, pred_to_png(pred[j]))
            written.append(out_path)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--artifact", required=True, help=".pt2 file of tools/export_model.py")
    p.add_argument("--ckpt", required=True, help="port checkpoint")
    p.add_argument("--rgb_dir", required=True)
    p.add_argument("--dep_dir", default=None,
                   help="optional sparse-depth 16-bit PNGs (the same file names)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="the artifact's device (default: the card)")
    args = p.parse_args(argv)
    written = serve_dir(args.artifact, args.ckpt, args.rgb_dir, args.out_dir,
                        dep_dir=args.dep_dir, seed=args.seed, device=args.device)
    print(f"wrote {len(written)} predictions to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
