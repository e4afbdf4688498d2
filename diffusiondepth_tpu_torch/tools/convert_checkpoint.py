"""CLI: a reference PyTorch checkpoint -> a port checkpoint (the port of
``diffusiondepth_tpu/tools/convert_checkpoint.py``).

One command takes a released reference ``model_EEEEE.pt`` (or any torch
save of the layouts ``utils/convert_torch_checkpoint.py`` reads: official
or mmcv Swin, mmbev ResNet, MPViT, NLSPN, full models) to a checkpoint that
``--pretrain``, ``tools/export_model.py``, ``tools/serve.py`` and
``tools/eval_parity.py`` read. The model flags are ``main``'s, so the
conversion is pinned to an explicit architecture; building the model
draws weights only for the tensors the file does not hold. It prints how
many of the model's tensors were replaced and returns 1 when none was (a
layout it does not know).

CLI:  python -m diffusiondepth_tpu_torch.tools.convert_checkpoint \\
          --torch model_00022.pt --out_dir converted/ [--epoch 0] [--device cpu] \\
          --model_name Diffusion_DCbase_ --backbone_module swin \\
          --backbone_name swin_large_naive_l4w722422k \\
          --head_specify DDIMDepthEstimate_Swin_ADDHAHI [...main's flags]
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--torch", required=True, dest="torch_path", help="reference .pt checkpoint")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch stamp of the output name model_EEEEE.ckpt")
    p.add_argument("--device", default=None,
                   help="device to build the model on (default: the card)")
    p.add_argument("--trust_pickle", action="store_true",
                   help="unpickle a file that weights_only loading refuses (runs the code "
                        "the file names: only for a trusted file)")
    args, model_flags = p.parse_known_args(argv)

    from ..config import parse_args
    from ..models.diffusion_model import build_model
    from ..utils.checkpoint import save_checkpoint
    from ..utils.convert_torch_checkpoint import load_reference_checkpoint

    cfg = parse_args(model_flags)
    model = build_model(cfg, device=args.device)
    target = model.state_dict()
    merged, replaced = load_reference_checkpoint(args.torch_path, target, args.trust_pickle)
    model.load_state_dict(merged)
    path = save_checkpoint(args.out_dir, args.epoch, SimpleNamespace(model=model, step=0), cfg)
    print(f"converted {args.torch_path} -> {path} ({replaced}/{len(target)} tensors replaced)")
    if replaced == 0:
        print("no tensor replaced: the checkpoint's layout was not recognised", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
