"""Readings of an eval cell's check on several seeds in one process: the
program's, and the control's, put in the program's place
(``drivers/eval.py::control_step``: the reference with every product in
fp8, e4m3 with one scale per tensor, the precision below the
configuration's bf16, and the metric row in bf16, the precision below the
program's f32 metric stage). Both go through the cell's own comparison and
verdict (``eval_gaps``, ``check.judge``). The limits in the configuration
files are set from these readings (PERF.md gives them).

    python3 h100bench/control.py --workload <cell> --seeds 1 2 3 [--control-seeds 3]

Each seed draws the weights and the inputs as a run of the cell does and
sends the traffic's ``check_requests`` requests; prints one JSON line a
seed. Exits 1 where the program fails its limits on a seed or the control
passes them on one. Needs a CUDA card, as a run does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds (the first) also read the control")
    args = p.parse_args(argv)
    import torch

    from harness import bench, check
    from harness.stats import subseed

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = bench.load_cell(HERE.parent, args.workload)
    config, traffic = cell["config"], cell["traffic"]
    ev = bench.load_driver(cell["bench_dir"], traffic["kind"])
    shape = ev.latent_shape(traffic, config)
    model = step = None
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    bad = 0
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ref = check.build_reference(config["reference"], subseed(seed, "weights"), dev)
        if model is None:
            model, step = ev.build_step(config, seed, ref.state_dict(), dev)
        else:
            model.load_state_dict(ref.state_dict())
        gen = torch.Generator(device=dev).manual_seed(subseed(seed, "inputs"))
        pool = ev.make_pool(traffic, gen, dev)
        sides = {"program": step}
        if k < args.control_seeds:
            sides["control"] = ev.control_step(ref)
        out = {"seed": seed}
        readings = {side: [] for side in sides}
        for r in range(traffic["check_requests"]):
            batch = pool[r % len(pool)]
            init = torch.randn(shape, generator=gen, device=dev)
            for side, fn in sides.items():
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
                    tf32 if side == "program" else (False, False)
                pred, met, _ = fn(batch, init_latent=init)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                readings[side].append(ev.eval_gaps(ref, batch["rgb"], batch["gt"], init, pred,
                                                   met))
        for side, rs in readings.items():
            checks, failed = check.judge(rs, config["limits"])
            out[side] = {"readings": rs, "checks": checks, "failed": failed,
                         "correct": failed == 0}
        bad += out["program"]["failed"] > 0
        bad += "control" in out and out["control"]["failed"] == 0
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del ref, pool
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
