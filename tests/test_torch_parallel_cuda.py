"""Two data-parallel ranks sharing one card (gloo: NCCL refuses two ranks
on one device), started by the port's launcher, against one process on the
card: swin_micro under the flagship head at ``accum_steps=2``, f32 with
TF32 and cuDNN off, 4 x 64x96, 2 DDIM steps. Marked ``cuda``: skips where
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
