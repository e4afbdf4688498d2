"""Traffic of kind ``eval``: a closed loop of one client sending batches to
the program's eval step, and the comparison that decides ``correct``.

The generator reads the mix's parameters (``traffic/<name>.json``): each
request is a batch of ``batch`` frames at ``height`` x ``width``, taken in
turn from a pool of ``pool`` distinct batches made on the device from the
seed (RGB standard normal; ground truth uniform in [``depth_min``,
``depth_max``] metres on a ``valid_share`` of the pixels, 0 elsewhere, as
sparse LiDAR is), with a starting latent drawn from the seed for each
request and handed in as ``init_latent``. The client sends the next request
when the result of the previous one is on the device and synchronised; a
request's latency runs from its submission to that point.
``warmup_requests`` go before the window, ``trace_requests`` into the traced
slice, and ``check_requests`` of the window's requests, a sample drawn from
the seed, are checked.

The check. After the window has closed and the program's state is freed,
the plain reference (``reference/model.py``, float32, TF32 off) is built
again from the seed and run on the inputs of each sampled request, the
whole batch at once. Two numbers per request, each held against a limit of
the configuration file (``limits``), the worst request's reading counting:

* ``depth_gap``: the program's depth ``pred`` is taken back to the
  decoder's sigmoid map, ``s = 1 / (pred + 1)`` (the decode is
  ``pred = 1 / clamp(s, 1e-6) - 1``, so this is exact up to the clamp), and
  its distance from the reference's map is measured in units of the
  distance that rounding every product's inputs to bf16 gives at the same
  weights and inputs: ``||s - s_ref|| / ||s_bf16 - s_ref||``, ``s_bf16``
  being the reference with ``PRODUCT_PRECISION = "bf16"``. The raw relative
  distance ``||s - s_ref|| / ||s_ref||`` moves up to 7x from seed to seed with
  the drawn weights, the program's and the fp8 control's together; the
  ratio does not. The depth itself is not compared: it is the reciprocal
  of a quantity that random weights put near 0, where bf16 rounding alone
  moves it by orders of magnitude.
* ``metric_gap``: the program's metric row against the reference's metric
  row of the program's own ``pred`` and the request's ground truth, entry
  by entry, ``|a - b| / max(|b|, 1)``: the metric stage on its own.

``control_step`` is the control put in the program's place: the reference
with fp8 products, decoded as the program decodes, and its metric row in
bf16 (``control.py`` reads it).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from harness import check, program
from harness.stats import Reservoir, subseed
from reference import model as R


def make_pool(traffic: dict, gen: torch.Generator, device) -> List[Dict[str, torch.Tensor]]:
    """``pool`` batches of (rgb, gt), NHWC, drawn in three calls."""
    p, b, h, w = traffic["pool"], traffic["batch"], traffic["height"], traffic["width"]
    rgb = torch.randn(p, b, h, w, 3, generator=gen, device=device)
    lo, hi = traffic["depth_min"], traffic["depth_max"]
    depth = torch.rand(p, b, h, w, 1, generator=gen, device=device) * (hi - lo) + lo
    valid = torch.rand(p, b, h, w, 1, generator=gen, device=device) < traffic["valid_share"]
    gt = depth * valid
    return [{"rgb": rgb[i], "gt": gt[i]} for i in range(p)]


def latent_shape(traffic: dict, config: dict):
    ref = config["reference"]
    s = ref["latent_stride"]
    return (traffic["batch"], traffic["height"] // s, traffic["width"] // s,
            ref["latent_channels"])


def build_step(config: dict, seed: int, state: Dict, device):
    """(model, eval step) of the program, loaded with ``state``."""
    model = program.build_model(config, seed, state, device)
    return model, program.port().make_eval_step(model)


class Driver:
    """Set-up (weights, program, pool, warm-up) on construction; then
    ``window``, ``unit`` for the traced slice, ``release`` and
    ``readings`` (harness/bench.py)."""

    def __init__(self, cell: dict, seed: int, device, mark):
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device, self.mark = seed, device, mark
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        ref = check.build_reference(self.config["reference"], subseed(seed, "weights"), device)
        self.sync()
        mark("reference weights drawn")
        self.model, self.step = build_step(self.config, seed, ref.state_dict(), device)
        del ref
        self.sync()
        mark("program built and loaded")
        self.gen = torch.Generator(device=device).manual_seed(subseed(seed, "inputs"))
        self.pool = make_pool(self.traffic, self.gen, device)
        self.shape = latent_shape(self.traffic, self.config)
        self.aside = torch.Generator(device=device).manual_seed(subseed(seed, "warm-up"))
        self.units = 0
        for _ in range(self.traffic["warmup_requests"]):
            self.unit()
        self.trace_units = self.traffic["trace_requests"]
        self.sample = Reservoir(self.traffic["check_requests"], subseed(seed, "sample"))

    def attach(self, spans) -> None:
        """Spans around the backbone's forward and the head's sampler; a layer
        the program no longer has leaves its metric silent."""
        if isinstance(getattr(self.model, "depth_backbone", None), torch.nn.Module):
            spans.around_module(self.model.depth_backbone, "backbone")
        if callable(getattr(getattr(self.model, "depth_head", None), "_sample", None)):
            spans.around_method(self.model.depth_head, "_sample", "sampler")

    def unit(self) -> None:
        """One request outside the window (warm-up, traced slice), its
        starting latent from a stream of its own."""
        init = torch.randn(self.shape, generator=self.aside, device=self.device)
        self.step(self.pool[self.units % len(self.pool)], init_latent=init)
        self.sync()
        self.units += 1

    def window(self, seconds: float) -> dict:
        """Requests back to back until ``seconds`` have passed; the window
        ends when the last request sent before then has completed."""
        lat, n, pool = [], 0, self.pool
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            idx = n % len(pool)
            init = torch.randn(self.shape, generator=self.gen, device=self.device)
            t0 = time.perf_counter()
            pred, met, _ = self.step(pool[idx], init_latent=init)
            self.sync()
            lat.append(time.perf_counter() - t0)
            self.sample.offer(lambda: (idx, init, pred.clone(), met.clone()))
            n += 1
        window_s = time.perf_counter() - w0
        ms = [round(1e3 * t, 2) for t in lat]
        self.mark(f"window closed after {n} requests (latency ms: first {ms[:5]}, "
                  f"min {min(ms)}, max {max(ms)})")
        return {"attempted": n, "requests": n, "frames": n * pool[0]["rgb"].shape[0],
                "window_s": window_s, "latency_s": lat}

    def release(self) -> None:
        self.model = self.step = None

    def readings(self) -> List[Dict[str, float]]:
        ref = check.build_reference(self.config["reference"], subseed(self.seed, "weights"),
                                    self.device)
        return [eval_gaps(ref, self.pool[idx]["rgb"], self.pool[idx]["gt"], init, pred, met)
                for idx, init, pred, met in self.sample.items]


@torch.no_grad()
def reference_map(ref: R.DiffusionDepth, rgb, gt, init_latent, precision=None) -> torch.Tensor:
    """The reference's sigmoid map of one request, with its products' inputs
    rounded to ``precision``."""
    R.PRODUCT_PRECISION = precision
    try:
        return ref(rgb, gt, init_latent)
    finally:
        R.PRODUCT_PRECISION = None


def distance(s: torch.Tensor, s_ref: torch.Tensor) -> float:
    return torch.linalg.vector_norm((s.float() - s_ref).double()).item()


def metric_gap(pred: torch.Tensor, gt: torch.Tensor, metric_row: torch.Tensor) -> float:
    want = R.metric_row(pred, gt)
    got = metric_row.reshape(-1).double()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def eval_gaps(ref: R.DiffusionDepth, rgb, gt, init_latent, pred, metric_row) -> Dict[str, float]:
    """The numbers of one request (module docstring), and the raw relative
    distance of its map beside them."""
    s_ref = reference_map(ref, rgb, gt, init_latent)
    unit = distance(reference_map(ref, rgb, gt, init_latent, "bf16"), s_ref)
    d = distance(1.0 / (pred.float() + 1.0), s_ref)
    return {"depth_gap": d / unit, "metric_gap": metric_gap(pred, gt, metric_row),
            "depth_rel": d / distance(torch.zeros_like(s_ref), s_ref)}


def control_step(ref: R.DiffusionDepth):
    """An eval step of the control, called as the program's is: the
    reference with fp8 products, its map decoded to depth, its metric row
    in bf16."""

    def step(batch, init_latent):
        pred = R.depth_of_map(reference_map(ref, batch["rgb"], batch["gt"], init_latent, "fp8"))
        return pred, R.metric_row(pred, batch["gt"], dtype=torch.bfloat16), None

    return step
