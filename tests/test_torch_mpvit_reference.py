"""MPViT-Small DiffusionDepth (``DDIMDepthEstimate_MPVIT_ADDHAHI``) against the
benchmark's plain reference (``h100bench/reference/backbones/mpvit.py``) on
the CPU, at mpvit_small's widths with 2 frames of 64 x 128: one state dict
loads into both; the f32 program computes the reference's pyramid, sigmoid
map and metric row; the cell's check passes the bf16 program and fails the
fp8 control put in its place. Also the program's MPViT spans under a CPU
profiler session, and the benchmark's counts of the encoders' and the
sampler's work against ``FlopCounterMode`` and the configuration's frozen
numbers. ``h100bench`` goes on ``sys.path`` as ``h100bench/run.py`` puts it."""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import diffusiondepth_tpu_torch as port
from diffusiondepth_tpu_torch import trace

BENCH = Path(__file__).resolve().parent.parent / "h100bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import bench, check  # noqa: E402
from harness.stats import subseed  # noqa: E402
from reference import model as R, work  # noqa: E402

EV = bench.load_driver(BENCH, "eval")
CONFIG = json.loads((BENCH / "configs" / "mpvit_small_hahi_kitti.json").read_text())
TRAFFIC = dict(json.loads((BENCH / "traffic" / "eval_bs8_kitti.json").read_text()),
               batch=2, height=64, width=128, pool=1)
SEED = 4000000021
STAGES = 4


@pytest.fixture(autouse=True)
def _cpu_setup():
    mkldnn, threads = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.backends.mkldnn.enabled = False  # oneDNN's conv loses precision at some shapes
    torch.set_num_threads(min(threads, 4))
    yield
    torch.backends.mkldnn.enabled = mkldnn
    torch.set_num_threads(threads)


def _case(opt_level):
    """(reference, program model, a batch, its starting latent)."""
    dev = torch.device("cpu")
    ref = check.build_reference(CONFIG["reference"], subseed(SEED, "weights"), dev)
    cfg = port.Config(**dict(CONFIG["program"], opt_level=opt_level), seed=1).finalize()
    model = port.build_model(cfg, device="cpu")
    model.load_state_dict(ref.state_dict())
    gen = torch.Generator().manual_seed(subseed(SEED, "inputs"))
    batch = EV.make_pool(TRAFFIC, gen, dev)[0]
    init = torch.randn(EV.latent_shape(TRAFFIC, CONFIG), generator=gen)
    return ref, model.eval(), batch, init


@pytest.fixture(scope="module")
def f32_case():
    return _case("O0")


def test_state_dict_keys_are_the_programs():
    with torch.device("meta"):
        ref = R.build(CONFIG["reference"])
    model = port.build_model(port.Config(**CONFIG["program"], seed=1).finalize(), device="cpu")
    assert set(model.state_dict()) == set(ref.state_dict())


@torch.no_grad()
def test_f32_pyramid_matches_the_reference(f32_case):
    """The four levels (1/2 .. 1/16), each within 2e-5 of its norm: both
    sides compute in f32 and differ only in the order of their sums (NHWC
    against NCHW convs, einsum against matmul), which leaves ~2e-6 after
    the 13 blocks of the deepest path."""
    ref, model, batch, _ = f32_case
    got = model.depth_backbone(batch["rgb"])
    want = ref.depth_backbone(batch["rgb"].permute(0, 3, 1, 2))
    assert [tuple(g.shape[1:3]) for g in got] == [(32, 64), (16, 32), (8, 16), (4, 8)]
    for g, w in zip(got, want):
        w = w.permute(0, 2, 3, 1)
        assert g.shape == w.shape
        assert ((g - w).norm() / w.norm()).item() < 2e-5


@torch.no_grad()
def test_f32_program_computes_the_reference(f32_case):
    """The sigmoid map within 1e-4 of its norm (the f32 order-of-sums gap
    of the pyramid, carried through the HAHI neck, the FPN and 20 DDIM
    steps) and the metric row within 1e-6 (the metric stage alone, f32
    against float64)."""
    ref, model, batch, init = f32_case
    pred, met, _ = port.make_eval_step(model)(batch, init_latent=init)
    s_ref = EV.reference_map(ref, batch["rgb"], batch["gt"], init)
    s = 1.0 / (pred + 1.0)
    assert EV.distance(s, s_ref) / EV.distance(torch.zeros_like(s_ref), s_ref) < 1e-4
    assert EV.metric_gap(pred, batch["gt"], met) < 1e-6


def test_check_passes_bf16_and_fails_the_fp8_control():
    """The cell's own comparison and limits: the bf16 program passes, the
    control (the reference with fp8 products, its metric row in bf16)
    fails on both numbers."""
    ref, model, batch, init = _case("O1")
    limits = CONFIG["limits"]
    read = {}
    for side, fn in (("program", port.make_eval_step(model)), ("control", EV.control_step(ref))):
        pred, met, _ = fn(batch, init_latent=init)
        read[side] = EV.eval_gaps(ref, batch["rgb"], batch["gt"], init, pred, met)
    program, control = read["program"], read["control"]
    assert program["depth_gap"] < limits["depth_gap"] < control["depth_gap"]
    assert program["metric_gap"] < limits["metric_gap"] < control["metric_gap"]
    assert check.judge([program], limits)[1] == 0
    assert check.judge([control], limits)[1] == 1


# ---- spans


def _span_tree():
    """name -> parent of every span MPViT records inside ``backbone``."""
    tree = {"backbone.stem": "backbone"}
    for s in range(STAGES):
        tree[f"backbone.stage{s}"] = "backbone"
        for part in ("embed", "invres", "mhca", "aggregate"):
            tree[f"backbone.stage{s}.{part}"] = f"backbone.stage{s}"
    return tree


def test_mpvit_request_records_its_spans():
    """One eval request under a CPU profiler session: ``backbone.stem``
    and each ``backbone.stage{s}`` once under ``backbone``, each stage with
    its four children once, in order, inside its interval; the request's
    counters move by nothing (no copy to a card, no launch); without a
    session no record is made."""
    cfg = port.Config(**dict(CONFIG["program"], inference_steps=2, opt_level="O0"),
                      seed=1).finalize()
    step = port.make_eval_step(port.build_model(cfg, device="cpu"))
    batch = {"rgb": torch.randn(2, 32, 64, 3), "gt": torch.rand(2, 32, 64, 1) * 8 + 1}
    step(batch)
    with profile(activities=[ProfilerActivity.CPU]):
        step(batch)
    spans = trace.spans()
    tree = _span_tree()
    mine = [s for s in spans if s.name in tree]
    assert sorted(s.name for s in mine) == sorted(tree)
    for s in mine:
        parent = spans[s.parent]
        assert parent.name == tree[s.name]
        assert parent.host_start_ns <= s.host_start_ns <= s.host_end_ns <= parent.host_end_ns
    for st in range(STAGES):
        parent = next(s for s in mine if s.name == f"backbone.stage{st}")
        assert [s.name.rsplit(".", 1)[1] for s in mine if s.parent == parent.index] == \
            ["embed", "invres", "mhca", "aggregate"]
    (request,) = [s for s in spans if s.name == "request"]
    assert request.counters["h2d_copies"] == 0 and not any(
        v for k, v in request.counters.items() if k.startswith("launches."))

    step(batch)  # no session: the last session's records stay as they were
    assert len(trace.spans()) == len(spans)


# ---- the benchmark's counts of work


@pytest.mark.parametrize("layer", ["mhca", "sampler"])
def test_frozen_work_is_the_counting_functions(layer):
    """The configuration's frozen numbers are the counting functions' at
    the traffic's 352 x 1216."""
    count = {"mhca": work.mhca_work, "sampler": work.sampler_work}[layer]
    flops, nbytes = count(CONFIG["reference"], 352, 1216)
    assert CONFIG[layer]["flops_per_frame"] == flops
    assert CONFIG[layer]["bytes_per_frame"] == nbytes


def test_frozen_forward_flops_are_the_references():
    """The reference's own count equals the program's frozen count
    (``tools/flops_table.json``) exactly: the two models run the same
    convolutions and products."""
    count = work.forward_flops(CONFIG["reference"], 352, 1216)
    assert CONFIG["flops"]["reference_count_per_frame"] == count
    assert CONFIG["flops"]["forward_per_frame"] == count


@pytest.mark.parametrize("hw", [(32, 64), (40, 72)], ids=["32x64", "40x72"])
def test_mhca_flops_equal_flop_counter_over_the_encoders(hw):
    """The closed form against ``FlopCounterMode`` over the reference's
    path encoders at a small size (an odd stage size included), every
    stage's maps from the reference's own patch embeds."""
    ref = check.build_reference(CONFIG["reference"], 3, torch.device("cpu")).depth_backbone
    x = torch.randn(1, 3, *hw)
    counted = 0
    with torch.no_grad():
        for m in ref.stem:
            x = m(x)
        for s, stage in enumerate(ref.mhca_stages):
            maps = ref.embed(s, x)
            counted += work.counted_flops(ref.encoders, s, maps)
            x = stage.aggregate(torch.cat([stage.InvRes(maps[0]), *ref.encoders(s, maps)], 1))
    assert work.mhca_work(CONFIG["reference"], *hw)[0] == counted
