"""Eager serve latency of the flagship from two source trees, in turns, on
the card: the within-call comparison of a change against its parent.

Each turn is a fresh process that imports ``diffusiondepth_tpu_torch``
from its tree (first on ``PYTHONPATH``; each tree builds its own kernels),
builds the serve configuration (``swin_large_naive_l4w722422k`` +
``DDIMDepthEstimate_Swin_ADDHAHI``, bf16, 20 steps, weights from seed
7240), serves one warm-up and ``--requests`` timed requests of 8 x
352x1216 through ``make_eval_step`` and prints one JSON line. The turns
run A B B A, so a drift of the card or host falls on both trees alike.

  python -m diffusiondepth_tpu_torch.tools.serve_ab --trees PARENT_DIR . [--requests 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, sys, time
import torch
import diffusiondepth_tpu_torch as port

cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                  backbone_name="swin_large_naive_l4w722422k",
                  head_specify="DDIMDepthEstimate_Swin_ADDHAHI", inference_steps=20,
                  opt_level="O1", seed=7240).finalize()
model = port.build_model(cfg)
step = port.make_eval_step(model)
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(cfg.seed)


def request():
    depth = torch.rand(8, 352, 1216, 1, generator=g, device=dev) * 79 + 1
    valid = torch.rand(8, 352, 1216, 1, generator=g, device=dev) < 0.3
    return {"rgb": torch.randn(8, 352, 1216, 3, generator=g, device=dev), "gt": depth * valid}


step(request(), generator=g)
batches = [request() for _ in range(int(sys.argv[1]))]
torch.cuda.synchronize()
ms = []
for b in batches:
    t0 = time.perf_counter()
    step(b, generator=g)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t0))
print(json.dumps({"latency_ms": ms, "device": torch.cuda.get_device_name(0)}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"),
                   help="two directories that each hold diffusiondepth_tpu_torch/")
    p.add_argument("--requests", type=int, default=5)
    args = p.parse_args(argv)
    a, b = (os.path.abspath(t) for t in args.trees)
    for tree in (a, b, b, a):
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, "-c", _TURN, str(args.requests)], cwd=tree,
                             env=env, check=True, capture_output=True, text=True).stdout
        print(json.dumps({"tree": tree, **json.loads(out.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
