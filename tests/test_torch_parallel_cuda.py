"""Two data-parallel ranks sharing one card (gloo: NCCL refuses two ranks
on one device), started by the port's launcher, against one process on the
card: swin_micro under the flagship head at ``accum_steps=2``, f32 with
TF32 and cuDNN off, 4 x 64x96, 2 DDIM steps; and two tensor-parallel ranks
(``model:2``) of every sharded-layer route in f64 (gloo's gathers of CUDA
tensors), against the same layers whole on the CPU to 1e-10. Marked ``cuda``: skips where
there is no CUDA device. On a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py

Tolerances are ``test_torch_parallel_train``'s for the same comparison on
the CPU: loss and loss row 1e-5, metric row 1e-4, every gradient 1e-3 of its
leaf's largest value, parameters after Adam's first update within 2 lr,
pred 1e-5; the ranks end bit-equal.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch

from diffusiondepth_tpu_torch import Config, LossComputer, build_model
from diffusiondepth_tpu_torch.parallel import launch
from diffusiondepth_tpu_torch.training.optim import make_lr_schedule
from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step
from diffusiondepth_tpu_torch.training.train_state import create_train_state

import test_torch_parallel_support as support

pytestmark = pytest.mark.cuda

SEED = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN picks algorithms by the batch's rows (2 on a rank, 4 in one
    # process), whose f32 roundings parted by 3% of a gradient leaf (an
    # NVIDIA H100 80GB HBM3 at 700 W): both sides take PyTorch's own
    # convolutions, as the ranks do (test_torch_parallel_support)
    with torch.backends.cudnn.flags(enabled=False):
        yield torch.device("cuda", 0)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(seed, b=4, h=64, w=96):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * 8 + 1).astype(np.float32)
    gt[:2, :40] = 0.0  # rank 0's rows mostly invalid
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "gt": gt}


def test_two_ranks_on_one_card_match_one_process(dev, tmp_path):
    cfg = Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                 backbone_name="swin_micro", head_specify="DDIMDepthEstimate_Swin_ADDHAHI",
                 head_in_channels="32,64,128,256", inference_steps=2, batch_size=4,
                 accum_steps=2, max_depth=88.0, mesh_shape="data:2").finalize()
    one_cfg = dataclasses.replace(cfg, mesh_shape=None)
    model = build_model(one_cfg, device=dev)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    batch, ebatch = _batch(1), _batch(2)
    torch.save([{"name": "swin", "mesh_shape": cfg.mesh_shape, "config": cfg.to_dict(),
                 "state_dict": sd, "batch": batch, "eval_batch": ebatch, "seed": SEED}],
               tmp_path / "cases.pt")
    launch(support.run_cases, [dev, dev], _free_port(), (str(tmp_path),))
    r0, r1 = (torch.load(tmp_path / f"swin_{r}.pt", weights_only=False) for r in range(2))

    pred, emet, _ = make_eval_step(model)({k: torch.from_numpy(v).to(dev)
                                           for k, v in ebatch.items()},
                                          generator=torch.Generator(dev).manual_seed(SEED + 1))
    state = create_train_state(model, one_cfg, 10)
    step = make_train_step(model, LossComputer(one_cfg), state.optimizer, 2)
    loss, lval, met = step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                           torch.Generator(dev).manual_seed(SEED))

    def rel(a, b):
        return ((a.double().cpu() - b.double().cpu()).abs().max()
                / b.double().cpu().abs().max().clamp_min(1e-30)).item()

    assert rel(r0["loss"], loss) <= 1e-5 and rel(r0["loss_val"], lval) <= 1e-5
    assert rel(r0["metric"], met) <= 1e-4
    assert rel(r0["pred"], pred) <= 1e-5 and rel(r0["eval_metric"], emet) <= 1e-4
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert r0["grads"].keys() == grads.keys()
    gmax = max(g.abs().max().item() for g in grads.values())
    for n, g in grads.items():
        err = (r0["grads"][n].double().cpu() - g.double().cpu()).abs().max().item()
        assert err <= 1e-3 * max(g.abs().max().item(), 1e-4 * gmax), (n, err)
    lr0 = make_lr_schedule(one_cfg, 10)(0)
    for n, p in model.named_parameters():
        assert (r0["params"][n].cpu() - p.detach().cpu()).abs().max().item() <= 2 * lr0, n
    for key in ("params", "buffers", "grads"):
        for n in r0[key]:
            assert torch.equal(r0[key][n], r1[key][n]), (key, n)


def test_sharded_layer_routes_on_one_card(dev, tmp_path):
    """The routes of ``test_torch_parallel_support.tp_layers`` (column-
    parallel Conv2d, ConvTranspose2d, Linear and attention shards;
    weight-gather of a depthwise conv and an embedding) on two ranks
    sharing the card, f64: output, dX and every whole gradient within 1e-10
    of the whole layers on the CPU (each leaf against its largest value,
    floored at 1e-4 of the largest leaf: the key bias's gradient is
    analytically zero). The card's and the CPU's f64 sums run in other
    orders: a Linear weight gradient lay 1.5e-12 of its leaf from the
    CPU's (NVIDIA H100 80GB HBM3, 700 W), where a wrong route errs by O(1)."""
    rng = np.random.RandomState(3)
    case = {"name": "layers", "mesh_shape": "model:2", "min_size": 256,
            "x": rng.randn(2, 4, 6, 8), "t": np.array([3, 7]), "w": rng.randn(2, 96, 32)}
    torch.save([case], tmp_path / "cases.pt")
    launch(support.run_cases, [dev, dev], _free_port(), (str(tmp_path),))
    layers = support.tp_layers()
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = layers(x, torch.from_numpy(case["t"]))
    (y * torch.from_numpy(case["w"])).sum().backward()
    gmax = max(p.grad.abs().max().item() for p in layers.parameters())
    for r in range(2):
        out = torch.load(tmp_path / f"layers_{r}.pt", weights_only=False)
        for got, ref in [(out["y"], y.detach()), (out["dx"], x.grad)] + [
                (out["grads"][n], p.grad) for n, p in layers.named_parameters()]:
            err = (got - ref).abs().max().item()
            assert err <= 1e-10 * max(ref.abs().max().item(), 1e-4 * gmax), err
