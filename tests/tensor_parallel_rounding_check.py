"""Where a tensor-parallel step's f32 gradients part from the unsharded
step's, and why (a diagnostic, not a test; run on the CPU, one thread per
rank):

    python tests/tensor_parallel_rounding_check.py port swin --dtype f64 --weights fanin --seed 3
    python tests/tensor_parallel_rounding_check.py kink swin --weights fanin --seed 3
    python tests/tensor_parallel_rounding_check.py jax
    python tests/tensor_parallel_rounding_check.py card   # on a CUDA card

* ``port CASE``: the port's sharded training step of a
  ``test_torch_tensor_parallel_train`` case (``swin``: model:2, ``res18``:
  data:2,model:2) on gloo CPU ranks against the port's one process, the
  worst gradient leaves (each against its largest value, floored as
  ``close_leaves`` floors it) and the output channel that holds the worst
  leaf's difference. ``--dtype f64`` runs both in f64: the port casts to
  f32 in places, so this process and the ranks keep ``Tensor.float()`` of
  an f64 tensor in f64, set the compute dtype to f64 and draw every
  ``randn``/``rand`` in f32 before widening it, so that the f32 and f64
  runs share their draws. ``--weights fanin`` draws every kernel of two
  or more dims N(0, 1/fan-in) from ``--seed`` instead of the case's
  weights.
* ``kink CASE``: the one-process f32 step, and for each ``conv_up``
  layer the channels whose BatchNorm output (the ReLU's input) comes
  nearest to zero: a value within rounding of zero changes side under
  another order of f32 sums, and drops or keeps its pixel's gradient.
* ``jax``: JAX's res18 ``data:2,model:2`` step with ``state_sharding`` at
  ``min_size`` 2**12 against its ``data:2`` step, with the f32 parameters
  and with x64 on and f64 parameters; for ``conv_up.0.0.weight`` the
  output channel and kernel tap of the largest difference.
* ``card``: the flagship's training step as ``chip_smoke.py``'s tp phase
  runs it on one process (its weights, first batch and draws), once in
  bf16 and once in f32 with TF32 off: each gradient leaf's relative L2
  between the two, for the leaves whose Adam step parts most between the
  tp phase's ranks and one process. It needs no JAX.
"""

import argparse
import dataclasses
import functools
import os
import sys
import tempfile

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)


def _jax_on_cpu():
    import conftest  # noqa: F401  JAX on the CPU's virtual devices


def _f64_everywhere():
    from diffusiondepth_tpu_torch.config import Config

    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_f32(t, *a, **k)
    Config.compute_dtype = property(lambda self: torch.float64)
    for fn in ("randn", "rand"):
        def draw(*a, dtype=None, _draw=getattr(torch, fn), **k):
            if dtype == torch.float64:
                return _draw(*a, dtype=torch.float32, **k).double()
            return _draw(*a, dtype=dtype, **k)
        setattr(torch, fn, draw)


def _build(cfg, sd, f64):
    from diffusiondepth_tpu_torch import build_model

    model = build_model(cfg, device="cpu")
    model = model.double() if f64 else model
    model.load_state_dict(sd)
    return model


def _rank(case_dir, f64):
    import diffusiondepth_tpu_torch as port
    from test_torch_parallel_support import run_cases

    if f64:
        _f64_everywhere()
        build = port.build_model
        port.build_model = lambda *a, **k: build(*a, **k).double()
    run_cases(case_dir)


def _case(name, weights, seed, f64):
    _jax_on_cpu()
    import test_torch_tensor_parallel_train as T

    cfg, sd, batch, ebatch, draws = T._case(name)
    if weights == "fanin":
        rng = np.random.RandomState(seed)
        sd = {n: torch.from_numpy(rng.randn(*t.shape) / np.sqrt(t[0].numel())).to(t.dtype)
              if n.endswith("weight") and t.ndim >= 2 else t for n, t in sd.items()}
    dt = np.float64 if f64 else np.float32

    def cast(d):
        return None if d is None else {k: v.astype(dt) if v.dtype.kind == "f" else v
                                       for k, v in d.items()}

    return cfg, sd, cast(batch), cast(ebatch), cast(draws)


def _one_process_step(name, cfg, sd, batch, draws, f64, hook=None):
    """The port's one-process step; the model after it."""
    import test_torch_tensor_parallel_train as T
    from diffusiondepth_tpu_torch import LossComputer
    from diffusiondepth_tpu_torch.training.steps import make_train_step
    from diffusiondepth_tpu_torch.training.train_state import create_train_state
    from test_torch_parallel_support import _inject

    cfg = dataclasses.replace(cfg, mesh_shape=None)
    model = _build(cfg, sd, f64)
    if T.CASES[name][3]:
        _inject(model, draws, 0, 1)
    if hook is not None:
        hook(model)
    state = create_train_state(model, cfg, 10)
    step = make_train_step(model, LossComputer(cfg), state.optimizer, cfg.accum_steps)
    step({k: torch.from_numpy(v) for k, v in batch.items()},
         torch.Generator().manual_seed(T.SEED))
    return model


def _worst(got, ref, n=3):
    floor = 1e-4 * max(float(g.abs().max()) for g in ref.values())
    errs = sorted(((float((got[k].double() - g.double()).abs().max())
                    / max(float(g.abs().max()), floor), k) for k, g in ref.items()),
                  reverse=True)
    return errs[:n]


def port_check(args):
    import test_torch_tensor_parallel_train as T
    from diffusiondepth_tpu_torch.parallel import launch
    from test_torch_support import free_port

    f64 = args.dtype == "f64"
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    cfg, sd, batch, ebatch, draws = _case(args.case, args.weights, args.seed, f64)
    _, spec, ranks, inject = T.CASES[args.case]
    with tempfile.TemporaryDirectory() as case_dir:
        torch.save([{"name": args.case, "mesh_shape": spec, "config": cfg.to_dict(),
                     "state_dict": sd, "batch": batch, "eval_batch": ebatch, "seed": T.SEED,
                     "min_size": T.MIN_SIZE, "inject": draws if inject else None}],
                   os.path.join(case_dir, "cases.pt"))
        launch(_rank, [torch.device("cpu")] * ranks, free_port(), (case_dir, f64))
        r0 = torch.load(os.path.join(case_dir, f"{args.case}_0.pt"), weights_only=False)
    if f64:
        _f64_everywhere()
    model = _one_process_step(args.case, cfg, sd, batch, draws, f64)
    ref = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    print(f"{args.case} {spec} {args.dtype} weights={args.weights} seed={args.seed}: "
          "the sharded step's gradients against one process's")
    worst = _worst(r0["grads"], ref)
    for err, n in worst:
        print(f"  {n}: {err:.3e} of the leaf")
    name = worst[0][1]
    d = (r0["grads"][name].double() - ref[name].double()).abs()
    if d.ndim == 4:  # (O, I, kh, kw), or (I, O, kh, kw) for a ConvTranspose2d
        out = 1 if "conv_up" in name and name.endswith(".0.weight") else 0
        per = d.amax(tuple(i for i in range(4) if i != out))
        top = per.topk(2)
        print(f"  {name}: largest difference in output channel {int(top.indices[0])} "
              f"({float(top.values[0]):.3e}; next channel {float(top.values[1]):.3e})")


def kink_check(args):
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    cfg, sd, batch, _, draws = _case(args.case, args.weights, args.seed, False)
    seen = []

    def hook(model):
        for i, up in enumerate(model.depth_head.conv_up):
            up[1].register_forward_hook(
                lambda m, a, o, i=i: seen.append((i, o.detach().double())))

    _one_process_step(args.case, cfg, sd, batch, draws, False, hook)
    calls = {}
    for i, out in seen:  # one call per layer and micro-batch
        calls[i] = calls.get(i, -1) + 1
        flat = out.reshape(-1, out.shape[-1]).abs()
        low = flat.min(0)
        top = low.values.topk(3, largest=False)
        ch = int(top.indices[0])
        b, h, w = np.unravel_index(int(low.indices[ch]), out.shape[:3])
        print(f"conv_up.{i} micro-batch {calls[i]} {tuple(out.shape)}: "
              f"|BatchNorm output| nearest zero "
              f"{top.values.tolist()} in channels {top.indices.tolist()}; channel {ch} at "
              f"(row {b}, y {h}, x {w})")


def jax_check(args):
    _jax_on_cpu()
    import jax
    import jax.numpy as jnp

    from diffusiondepth_tpu import config as jconfig
    from diffusiondepth_tpu.losses import LossComputer as JLossComputer
    from diffusiondepth_tpu.models.heads import ddim_head as jhead
    from diffusiondepth_tpu.parallel import mesh as jmesh
    from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer
    from diffusiondepth_tpu.training.steps import make_train_step as jmake_train_step
    from diffusiondepth_tpu.training.train_state import TrainState
    from test_torch_support import dp_family as _family
    from test_torch_support import Draws, FixedLatent, named

    cfg, jm, variables, _, batch, _, draws = _family("res18")
    jcfg = dataclasses.replace(
        jconfig.Config(), loss=cfg.loss, batch_size=cfg.batch_size, accum_steps=1,
        max_depth=cfg.max_depth, optimizer="SGD", momentum=0.0, lr=1.0, warm_up=False,
        weight_decay=0.0)
    jhead.jax = Draws(draws["noise"], draws["ts"])
    model = FixedLatent(jm, jnp.asarray(draws["lat"]))
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
    for x64 in (False, True):
        dt = np.float64 if x64 else np.float32

        def cast(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dt)), tree)

        grads = {}
        with jax.enable_x64(x64):
            params, stats = cast(variables["params"]), cast(variables["batch_stats"])
            tx = jmake_optimizer(jcfg, 10, params)
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               opt_state=jax.jit(tx.init)(params), tx=tx)
            for spec, n in (("data:2,model:2", 4), ("data:2", 2)):
                mesh = jmesh.create_mesh(spec, jax.devices()[:n])
                kw, st = {}, state
                if "model" in spec:
                    kw["state_shardings"] = jmesh.state_sharding(state, mesh, min_size=2**12)
                    st = jax.device_put(state, kw["state_shardings"])
                step = jmake_train_step(model, JLossComputer(jcfg), mesh=mesh, donate=False,
                                        **kw)
                new = step(st, jmesh.shard_batch(cast(batch), mesh), jax.random.PRNGKey(0))[0]
                grads[spec] = {k: torch.from_numpy(v) for k, v in named(to_np(
                    jax.tree_util.tree_map(lambda a, b: a - b, params, new.params))).items()}
        worst = _worst(grads["data:2,model:2"], grads["data:2"])
        print(f"JAX res18 sharded against data:2, {'x64, f64 parameters' if x64 else 'f32'}:")
        for err, n in worst:
            print(f"  {n}: {err:.3e} of the leaf")
        name = "depth_head.conv_up.0.0.weight"
        d = (grads["data:2,model:2"][name] - grads["data:2"][name]).abs()  # (I, O, kh, kw)
        o = int(d.amax((0, 2, 3)).argmax())
        taps = d[:, o].amax(0)
        print(f"  {name}: largest difference in output channel {o}, per kernel tap "
              f"{taps.flatten().tolist()}")


# the leaves whose Adam step parted most from one process's in chip_smoke's
# tp phase (model:2 and data:2,model:2 alike)
CARD_LEAVES = ("depth_backbone.stages.3.blocks.0.ffn.layers.1.weight",
               "depth_backbone.stages.3.blocks.0.ffn.layers.0.0.weight",
               "depth_backbone.stages.3.blocks.1.attn.w_msa.qkv.weight")


def card_check(args):
    import json

    import chip_smoke as cs
    import diffusiondepth_tpu_torch as port

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = port.Config(**cs.DDP_TRAIN).finalize()
    dgen = torch.Generator(device=dev).manual_seed(1)
    gt = (torch.rand(cs.B_T, cs.H_T, cs.W_T, 1, generator=dgen, device=dev) * 80).clamp(0, 88)
    batch = {"rgb": torch.randn(cs.B_T, cs.H_T, cs.W_T, 3, generator=dgen, device=dev), "gt": gt}
    grads, sd = {}, None
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = port.build_model(c, device=dev)
        if sd is None:
            sd = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(sd)
        step = port.make_train_step(model, port.LossComputer(c), port.make_optimizer(c, 100, model),
                                    accum_steps=cs.ACCUM)
        step(batch, torch.Generator(device=dev).manual_seed(cs.DDP_SEED))
        grads[dtype] = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                        if p.grad is not None}
        del model, step
        torch.cuda.empty_cache()
    b16, f32 = grads["bfloat16"], grads["float32"]
    top = max(float(g.abs().max()) for g in f32.values())
    both = [n for n in f32 if n in b16]
    rel = {n: float((b16[n] - f32[n]).norm() / f32[n].norm()) for n in both if f32[n].norm() > 0}
    stage3 = sorted(v for n, v in rel.items() if ".stages.3." in n and n.endswith("weight"))
    flat = [torch.cat([g[n].reshape(-1) for n in both]) for g in (b16, f32)]
    print(json.dumps({
        "bf16_vs_f32_whole_gradient_rel_l2": float((flat[0] - flat[1]).norm() / flat[1].norm()),
        "leaves": {n: {"rel_l2": rel[n], "largest_over_model": float(f32[n].abs().max()) / top}
                   for n in CARD_LEAVES},
        "stage3_weights_rel_l2": {"n": len(stage3), "median": stage3[len(stage3) // 2],
                                  "max": stage3[-1]},
        "leaves_over_0.1": sum(v > 0.1 for v in rel.values()), "n_leaves": len(rel),
        "only_one_dtype": sorted(set(f32) ^ set(b16))}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("port", "kink", "jax", "card"))
    ap.add_argument("case", nargs="?", default="swin", choices=("swin", "res18"))
    ap.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    ap.add_argument("--weights", default="case", choices=("case", "fanin"))
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    {"port": port_check, "kink": kink_check, "jax": jax_check, "card": card_check}[args.mode](args)


if __name__ == "__main__":
    main()
