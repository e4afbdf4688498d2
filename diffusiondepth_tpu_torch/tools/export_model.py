"""Export the inference step for serving (``torch.export``), the port of
``diffusiondepth_tpu/tools/export_model.py``.

The predict step is traced once into an ``ExportedProgram`` and saved as a
``.pt2`` file; ``tools/serve.py`` runs it with no model-building code. The
four kernels of the serving path are ``torch.library`` operators
(``ops/library.py``), so the program calls them as the eager path does.

Artifact contract:

* inputs: the batch of ``serving_batch_spec`` (five NHWC f32 maps) and
  ``init_latent``, the starting latent (2B rows under ``--tta``). A
  ``torch.Generator`` cannot be an input of an exported program, so the
  caller draws the latent (JAX's artifact takes an rng key in its place);
* output: ``pred`` (B, H, W, 1);
* weights: the program's lifted parameters and buffers under the model's
  own state-dict names, so ``load_exported(p).module().load_state_dict(sd)``
  serves any checkpoint of the same architecture;
* the program is traced with ``strict=False`` under ``torch.no_grad()`` and
  not decomposed: it keeps the ATen operators the eager path runs, and
  computes its bits. It runs on the device it was exported on.

CLI:  python -m diffusiondepth_tpu_torch.tools.export_model \\
          --ckpt experiments/.../model_00010.ckpt --out model.pt2 \\
          --batch_size 1 --height 352 --width 1216 [--tta] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

from ..ops import library  # noqa: F401  (registers the operators the program calls)
from ..training.steps import _hflip_batch

def make_predict_fn(model: nn.Module, tta_flip: bool = False) -> Callable:
    """``predict(batch, init_latent) -> pred``, the serving forward.

    Unlike ``make_eval_step`` it computes no metrics (a serving batch has
    no ground truth) and returns only the depth map. ``tta_flip`` is the
    leaderboard's flip ensemble as one doubled batch, as ``make_eval_step``
    runs it: every entry concatenated with its mirror along W, and pred =
    (pred[:B] + flip(pred[B:])) / 2; ``init_latent`` then has 2B rows."""

    def predict(batch: Dict[str, torch.Tensor], init_latent: torch.Tensor) -> torch.Tensor:
        if not tta_flip:
            return model(batch, init_latent=init_latent)["pred"]
        b = batch["rgb"].shape[0]
        flipped = _hflip_batch(batch)
        both = {k: torch.cat([v, flipped[k]]) for k, v in batch.items()}
        pred = model(both, init_latent=init_latent)["pred"]
        return 0.5 * (pred[:b] + torch.flip(pred[b:], dims=(2,)))

    return predict


def serving_batch_spec(batch_size: int, height: int, width: int) -> Dict[str, Tuple[int, ...]]:
    """The serving inputs' shapes, all f32 NHWC: RGB, the sparse depth and
    the three maps the eval contract names. The head sizes its latent from
    ``gt``'s shape only (the reference's gt-sized-latent quirk), so serving
    feeds the sparse map there."""
    img = (batch_size, height, width, 3)
    dep = (batch_size, height, width, 1)
    return {"rgb": img, "dep": dep, "gt": dep, "depth_map": dep, "depth_mask": dep}


def latent_shape(model: nn.Module, batch_size: int, height: int, width: int,
                 tta_flip: bool = False) -> Tuple[int, ...]:
    """The starting latent's shape for a batch: the depth transform's
    output size with the head's latent channels, worked out on fake
    tensors; 2B rows under ``tta_flip``. A model without a DDIM head
    (NLSPN) draws nothing: (rows, 0, 0, 0)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rows = 2 * batch_size if tta_flip else batch_size
    head = getattr(model, "depth_head", None)
    if head is None:
        return (rows, 0, 0, 0)
    dev = next(model.parameters()).device
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        t = head.depth_transform.t(torch.zeros((rows, height, width, 1), device=dev))
    return (rows, t.shape[1], t.shape[2], head.depth_feature_dim)


class PredictStep(nn.Module):
    """The predict step as a module whose parameters and buffers are the
    model's, under the model's own names (the model's children are this
    module's children), so the exported program's state dict is the
    model's."""

    def __init__(self, model: nn.Module, tta_flip: bool = False):
        super().__init__()
        self._modules = model._modules
        self._parameters = model._parameters
        self._buffers = model._buffers
        self._non_persistent_buffers_set = model._non_persistent_buffers_set
        self.predict = make_predict_fn(model, tta_flip)

    def forward(self, batch: Dict[str, torch.Tensor], init_latent: torch.Tensor) -> torch.Tensor:
        return self.predict(batch, init_latent)


def _example_inputs(model: nn.Module, batch_spec: Dict[str, Tuple[int, ...]],
                    tta_flip: bool = False):
    """(batch, init_latent) of zeros on the model's device."""
    dev = next(model.parameters()).device
    batch = {k: torch.zeros(s, device=dev) for k, s in batch_spec.items()}
    b, h, w, _ = batch_spec["rgb"]
    lat = torch.zeros(latent_shape(model, b, h, w, tta_flip), device=dev)
    return batch, lat


def export_predict(model: nn.Module, batch_spec: Dict[str, Tuple[int, ...]], *,
                   tta_flip: bool = False) -> torch.export.ExportedProgram:
    """Trace the predict step of ``model`` (in eval mode, on its device)
    for the inputs of ``batch_spec``. The program is not decomposed."""
    model.eval()
    args = _example_inputs(model, batch_spec, tta_flip)
    with torch.no_grad():
        return torch.export.export(PredictStep(model, tta_flip), args, strict=False)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load a ``.pt2`` artifact (the operators are registered on import
    of this module)."""
    return torch.export.load(path)


def main(argv=None) -> int:
    from ..models.diffusion_model import build_model
    from ..utils.checkpoint import load_checkpoint

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, help="port checkpoint (with its .args.json)")
    p.add_argument("--out", required=True, help="output artifact path (.pt2)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--height", type=int, default=352)
    p.add_argument("--width", type=int, default=1216)
    p.add_argument("--tta", action="store_true", help="the flip ensemble in the artifact")
    p.add_argument("--device", default=None,
                   help="device to export on, and so to serve on (default: the card)")
    args = p.parse_args(argv)

    payload = load_checkpoint(args.ckpt)
    if "args" not in payload:
        p.error(f"no .args.json beside {args.ckpt}")
    cfg = payload["args"]
    model = build_model(cfg, device=args.device)
    model.load_state_dict(payload["state_dict"])
    spec = serving_batch_spec(args.batch_size, args.height, args.width)
    exported = export_predict(model, spec, tta_flip=args.tta)
    save_exported(exported, args.out)
    dev = next(model.parameters()).device
    print(f"exported {cfg.model_name}/{cfg.backbone_name} bs{args.batch_size} "
          f"{args.height}x{args.width} tta={args.tta} device={dev} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
