"""The plain reference against the port at micro widths on the CPU: the same
state dict loads into both, the f32 program computes the reference's depth
and metric row, and the cell's check passes the bf16 program and fails the
control put in its place (the reference with fp8 products, and the metric
row in bf16), as it does at the cells' own sizes on the card (PERF.md)."""

import json

import pytest
import torch

import diffusiondepth_tpu_torch as port
from harness import bench, check
from harness.stats import subseed
from conftest import BENCH, MICRO

EV = bench.load_driver(BENCH, "eval")
SWIN = json.loads((MICRO / "swin_micro.json").read_text())
RES = {  # the res50 cell's model at res18 depth
    "program": {"model_name": "Diffusion_DCbase_", "backbone_module": "mmbev_resnet",
                "backbone_name": "mmbev_res18", "head_specify": "DDIMDepthEstimate_Res",
                "inference_steps": 20},
    "reference": {"backbone": "mmbev_resnet", "num_layer": [2, 2, 2, 2],
                  "channels": [64, 128, 256, 512], "fuse": "add", "hahi": False,
                  "inference_steps": 20, "fpn_dim": 256, "latent_channels": 16,
                  "latent_stride": 2},
}
TRAFFIC = json.loads((MICRO / "eval_micro.json").read_text())
SEED = 4000000001


def _case(config, opt_level):
    dev = torch.device("cpu")
    ref = check.build_reference(config["reference"], subseed(SEED, "weights"), dev)
    cfg = port.Config(**dict(config["program"], opt_level=opt_level), seed=1).finalize()
    model = port.build_model(cfg, device="cpu")
    assert set(model.state_dict()) == set(ref.state_dict())
    model.load_state_dict(ref.state_dict())
    gen = torch.Generator().manual_seed(subseed(SEED, "inputs"))
    batch = EV.make_pool(TRAFFIC, gen, dev)[0]
    init = torch.randn(EV.latent_shape(TRAFFIC, config), generator=gen)
    return ref, batch, init, port.make_eval_step(model)


@pytest.mark.parametrize("config", [SWIN, RES], ids=["swin_micro", "res18"])
def test_f32_program_computes_the_reference(config):
    ref, batch, init, step = _case(config, "O0")
    pred, met, _ = step(batch, init_latent=init)
    s_ref = EV.reference_map(ref, batch["rgb"], batch["gt"], init)
    s = 1.0 / (pred + 1.0)
    assert EV.distance(s, s_ref) / EV.distance(torch.zeros_like(s_ref), s_ref) < 1e-4
    assert EV.metric_gap(pred, batch["gt"], met) < 1e-6


@pytest.mark.parametrize("config", [SWIN, RES], ids=["swin_micro", "res18"])
def test_check_separates_the_program_from_the_control(config):
    ref, batch, init, step = _case(config, "O1")
    limits = SWIN["limits"]
    read = {}
    for side, fn in (("program", step), ("control", EV.control_step(ref))):
        pred, met, _ = fn(batch, init_latent=init)
        read[side] = EV.eval_gaps(ref, batch["rgb"], batch["gt"], init, pred, met)
    program, control = read["program"], read["control"]
    assert program["depth_gap"] < limits["depth_gap"] < control["depth_gap"]
    assert program["metric_gap"] < limits["metric_gap"] < control["metric_gap"]
    assert control["depth_gap"] > 3 * program["depth_gap"]
    assert check.judge([program], limits)[1] == 0
    assert check.judge([control], limits)[1] == 1
