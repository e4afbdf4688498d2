"""Model FLOPs of a forward pass, for MFU (the port of
``diffusiondepth_tpu/tools/flops.py``).

The port counts with ``torch.utils.flop_counter.FlopCounterMode`` under
``FakeTensorMode`` on the CPU: the model is built and run on fake tensors,
so nothing is allocated and nothing computes, and Swin-L at 8 x 352x1216
counts in seconds. The kernels of the serving path are operators with
flop formulas (``ops/library.py``): K1 counts its 3x3 convolution, K4 and
K8 their two attention products, K3 nothing. The sampler is a Python loop,
so every step is counted (the JAX tool adds N - 1 steps to XLA's count of
one scan body).

FlopCounterMode counts matrix products and convolutions only, while XLA's
cost analysis also counts elementwise work, normalisation and reductions;
the products dominate, and each entry is within 0.3% of the JAX table's
(``PERF.md`` gives the ratios). Training entries count the forward of the
model in training mode (the sampler and the self-diffusion loss's denoiser
call); MFU takes 3x that for a step.

Results are kept in ``flops_table.json`` beside this file under the JAX
table's keys, so a benchmark never pays the count.

CLI: python -m diffusiondepth_tpu_torch.tools.flops [--refresh]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

CACHE = Path(__file__).with_name("flops_table.json")

# dense bf16 tensor-core peak (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS_BY_KIND = {"H100": 989.4e12}


def peak_flops(device_kind: str) -> float:
    """The bf16 dense peak of a device by its name
    (``torch.cuda.get_device_name``); raises for a device not in the table."""
    for k, v in PEAK_FLOPS_BY_KIND.items():
        if k.lower() in device_kind.lower():
            return v
    raise ValueError(f"no peak FLOP/s known for {device_kind!r}")


def _key(backbone: str, head: str, h: int, w: int, bs: int, steps: int) -> str:
    return f"{backbone}|{head}|{h}x{w}|bs{bs}|steps{steps}"


def compute_fwd_flops(backbone_module: str, backbone_name: str, head: str, h: int, w: int,
                      bs: int, steps: int, train: bool = False) -> int:
    """Forward model FLOPs of one batch (not per frame) under the bf16
    policy, counted on fake tensors."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..config import Config
    from ..models.diffusion_model import construct_model

    cfg = Config(model_name="Diffusion_DCbase_", backbone_module=backbone_module,
                 backbone_name=backbone_name, head_specify=head, inference_steps=steps,
                 opt_level="O1", batch_size=bs, patch_height=h, patch_width=w,
                 max_depth=88.0).finalize()
    with torch.device("meta"):  # no weights are drawn: initialisers return at once on meta
        model = construct_model(cfg)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        model = model.to_empty(device="cpu")  # fake CPU parameters and buffers
        model.train(train)
        gt = torch.full((bs, h, w, 1), 5.0)
        batch = {"rgb": torch.zeros(bs, h, w, 3), "gt": gt, "dep": gt}
        gen = torch.Generator().manual_seed(0)
        with counter:
            model(batch, generator=gen)
    return counter.get_total_flops()


SWIN_ARGS = ("swin", "swin_large_naive_l4w722422k", "DDIMDepthEstimate_Swin_ADDHAHI")

# (backbone_module, backbone_name, head, h, w, bs, steps, train): the
# entries of the JAX table, which bench.py reads
BENCH_SPECS = (
    SWIN_ARGS + (352, 1216, 8, 20, False),
    SWIN_ARGS + (352, 906, 8, 20, True),
    SWIN_ARGS + (352, 1216, 8, 50, False),  # the leaderboard protocol (x2 under TTA)
    ("mmbev_resnet", "mmbev_res50", "DDIMDepthEstimate_Res", 352, 1216, 8, 20, False),
    ("mpvit", "mpvit_small", "DDIMDepthEstimate_MPVIT_ADDHAHI", 352, 1216, 8, 20, False),
)


def entry(spec) -> Dict[str, object]:
    mod, name, head, h, w, bs, steps, train = spec
    f = compute_fwd_flops(mod, name, head, h, w, bs, steps, train=train)
    return {"fwd_flops_batch": float(f), "fwd_flops_frame": f / bs, "train": bool(train)}


def compute_entries(specs=BENCH_SPECS, existing: Optional[Dict] = None) -> Dict[str, Dict]:
    """The table entries of ``specs`` that ``existing`` lacks."""
    out = {}
    for spec in specs:
        key = _key(*spec[1:7])
        if not (existing and key in existing):
            out[key] = entry(spec)
    return out


def lookup(backbone_name: str, head: str, h: int, w: int, bs: int,
           steps: int) -> Optional[Dict[str, float]]:
    if not CACHE.exists():
        return None
    return json.loads(CACHE.read_text()).get(_key(backbone_name, head, h, w, bs, steps))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--refresh", action="store_true", help="recompute every entry")
    args = p.parse_args(argv)
    table = json.loads(CACHE.read_text()) if CACHE.exists() else {}
    new = compute_entries(existing=None if args.refresh else table)
    if new:
        table.update(new)
        CACHE.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    for k, v in sorted(table.items()):
        print(f"{k}: {v['fwd_flops_frame'] / 1e12:.3f} TFLOP/frame fwd")


if __name__ == "__main__":
    main()
