"""The H100 benchmark of ``diffusiondepth_tpu_torch``: one run of one cell.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic and
metrics come from ``BENCHMARK.json`` and the files it names (``harness/bench.py``).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, the device's busy time and a breakdown. The last line of
standard output is the result's JSON object; the last lines of standard
error are the numbers the check compared, each beside its limit.

Exits 2, printing no result, without as many CUDA cards as the cell asks
for, and 3 when JAX or the JAX package was loaded in this process. Triton's
cache stays in ``h100bench/.cache/triton`` and the program builds its CUDA
kernels in its own ``_build`` directory, both inside the checkout; a trace
is written under TMPDIR and deleted.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffusiondepth_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole: ``diffusiondepth_tpu_torch`` is not ``diffusiondepth_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from harness import bench

    cell = bench.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100bench: cell {args.workload} needs {cell['chips']} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = bench.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                       T0)
    bad = loaded_forbidden()
    if bad:
        print(f"h100bench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
