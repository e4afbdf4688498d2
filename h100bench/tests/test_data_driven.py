"""A later change adds a configuration, a traffic mix, a metric, a kind of
traffic with its driver and check, or a backbone of the reference, as new
files and entries, and the harness picks them up by name without an edit to
any file it already has."""

import json
import sys
import time

import torch

import reference.backbones
from harness import bench, check

READER = '''
"""Request count of the window (a throwaway metric of this test)."""


def read(ctx):
    return ctx["requests"] if ctx["kind"] == "eval" else None
'''


def test_new_files_are_found_by_name(micro_root):
    bench_dir = micro_root / "h100bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    # the new files
    cfg = json.loads((bench_dir / "configs" / "swin_micro.json").read_text())
    cfg["name"] = "swin_micro_b"
    (bench_dir / "configs" / "swin_micro_b.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "eval_micro.json").read_text())
    (bench_dir / "traffic" / "eval_micro_b.json").write_text(json.dumps(dict(traffic, pool=3)))
    (bench_dir / "metrics" / "requests_seen.eval.py").write_text(READER)
    # the new entries
    spec = json.loads((micro_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="swin_micro_b",
                                file="h100bench/configs/swin_micro_b.json"))
    spec["workloads"].append({"name": "micro-eval-b", "config": "swin_micro_b",
                              "traffic": "eval_micro_b", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "requests_seen.eval", "unit": "requests",
                              "better": "higher", "source": "host_clock", "layer": "entry",
                              "moves": "eval_frames_per_s", "workloads": ["micro-eval-b"]})
    (micro_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = bench.load_cell(micro_root, "micro-eval-b", bench_dir=bench_dir)
    assert cell["config"]["name"] == "swin_micro_b" and cell["traffic"]["pool"] == 3
    assert [m["name"] for m in cell["per_layer"]] == ["requests_seen.eval"]
    res = bench.run(cell, 77, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_seen.eval"]["value"] == res["attempted"]
    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data


DRIVER = '''
"""A throwaway kind of traffic: products of a random matrix with itself,
checked against float64."""

import time

import torch


class Driver:
    def __init__(self, cell, seed, device, mark):
        n = cell["traffic"]["n"]
        self.a = torch.randn(n, n, generator=torch.Generator().manual_seed(seed))
        self.trace_units = 1
        self.out = None
        mark("matrix drawn")

    def attach(self, spans):
        pass

    def unit(self):
        self.out = self.a @ self.a

    def window(self, seconds):
        n, w0 = 0, time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            self.unit()
            n += 1
        return {"attempted": n, "products": n, "window_s": time.perf_counter() - w0}

    def release(self):
        pass

    def readings(self):
        want = self.a.double() @ self.a.double()
        gap = (self.out.double() - want).abs().max() / want.abs().max()
        return [{"product_gap": gap.item()}]
'''

RATE = '''
"""Products over the whole window's wall time (a throwaway metric of this test)."""


def read(ctx):
    return ctx["products"] / ctx["window_s"] if ctx["kind"] == "products" else None
'''


def test_new_kind_is_found_by_name(micro_root):
    bench_dir = micro_root / "h100bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "drivers" / "products.py").write_text(DRIVER)
    (bench_dir / "metrics" / "products_per_s.py").write_text(RATE)
    (bench_dir / "traffic" / "products_64.json").write_text(json.dumps({"kind": "products",
                                                                         "n": 64}))
    (bench_dir / "configs" / "products.json").write_text(json.dumps(
        {"name": "products", "limits": {"product_gap": 1e-5}}))
    spec = json.loads((micro_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="products",
                                file="h100bench/configs/products.json"))
    spec["workloads"].append({"name": "products-64", "config": "products",
                              "traffic": "products_64", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "products_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["products-64"]})
    (micro_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = bench.load_cell(micro_root, "products-64", bench_dir=bench_dir)
    res = bench.run(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"products_per_s", "setup_s"}
    assert res["metrics"]["products_per_s"]["value"] > 0 and res["attempted"] >= 1
    assert list(res["checks"]) == ["product_gap"]
    for p, data in before.items():
        assert p.read_bytes() == data


BACKBONE = '''
"""A throwaway backbone of the reference: four strided 3x3 convs."""

import torch
import torch.nn as nn

from ..model import conv


class Tiny(nn.Module):
    def __init__(self, channels):
        super().__init__()
        cins = [3] + list(channels[:-1])
        self.convs = nn.ModuleList([nn.Conv2d(a, b, 3, 2, 1) for a, b in zip(cins, channels)])

    def forward(self, x):
        outs = []
        for m in self.convs:
            x = torch.relu(conv(x, m))
            outs.append(x)
        return outs


def build(spec):
    return Tiny(spec["channels"]), list(spec["channels"])
'''


def test_new_reference_backbone_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "tiny_conv.py").write_text(BACKBONE)
    monkeypatch.setattr(reference.backbones, "__path__",
                        list(reference.backbones.__path__) + [str(tmp_path)])
    monkeypatch.delitem(sys.modules, "reference.backbones.tiny_conv", raising=False)
    spec = {"backbone": "tiny_conv", "channels": [8, 16, 32, 64], "fuse": "add",
            "hahi": False, "inference_steps": 2, "fpn_dim": 32, "latent_channels": 16,
            "latent_stride": 2}
    ref = check.build_reference(spec, 3, torch.device("cpu"))
    assert type(ref.depth_backbone).__name__ == "Tiny"
    g = torch.Generator().manual_seed(3)
    s = ref(torch.randn(1, 32, 64, 3, generator=g), torch.rand(1, 32, 64, 1, generator=g),
            torch.randn(1, 16, 32, 16, generator=g))
    assert s.shape == (1, 32, 64, 1) and torch.isfinite(s).all()
    sys.modules.pop("reference.backbones.tiny_conv", None)
