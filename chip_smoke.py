#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build and kernel checks only

Phases, one JSON line each:

1. env     - torch/CUDA versions; the card's name and power limit (also
             printed raw, as nvidia-smi gives them);
2. build   - the CUDA kernels compiled with nvcc for sm_90a, one process
             per source, all at once;
3. kernel  - every kernel of the eval path against its plain PyTorch
             version at the flagship shapes, in bf16: the conv link (K1) at
             its six configurations on the (8, 176, 608) latent, the DDIM
             step (K3) on that latent, window attention (K4) at the four
             Swin-L stages of a 352x1216 batch of 8, plain and shifted.
             Each reports its error against its tolerance, its time, the
             plain version's time, a library call's time where one exists
             and the least time the card could take (bound);
4. reference - swin_micro under the flagship head on the card against the
             same weights on the CPU (plain versions): backbone pyramid,
             condition map and one denoiser call;
5. serve   - the flagship configuration (Swin-L + HAHI + DDIM head, FPN 256,
             20 steps, bf16) with weights from a seed serves 3 requests of
             8 x 352x1216 through make_eval_step after one warm-up request;
             reports latency, frames/s, peak memory and the metric row, and
             requires the kernels' launch counts of exactly 120 (K1), 20
             (K3) and 24 (K4) per request; then the device time of one
             request split into backbone, depth encode, HAHI + FPN +
             upsample, the 20-step sampler and the decode.

Then a line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor cores
F32_FLOPS = 67e12  # outside the tensor cores

B, H_IMG, W_IMG = 8, 352, 1216
STEPS = 20
SWIN_L = dict(depths=(2, 2, 18, 2), heads=(6, 12, 24, 48), dims=(192, 384, 768, 1536))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + msg)


def bound(nbytes: float, flops: float, peak: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="build and kernel checks only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    import diffusiondepth_tpu_torch as port
    from diffusiondepth_tpu_torch.diffusion.ddim import DDIMSchedule
    from diffusiondepth_tpu_torch.models.backbones.swin import shifted_window_mask
    from diffusiondepth_tpu_torch.ops import native
    from diffusiondepth_tpu_torch.ops.fused_denoiser import (
        _link_input_plain, conv_link, conv_link_plain, ddim_step, ddim_step_plain,
    )
    from diffusiondepth_tpu_torch.ops.window_attention import (
        window_attention, window_attention_plain,
    )

    # plain versions and references compute f32 in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize()

    def cuda_ms(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    # ---- 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    # ---- 2. build
    t0 = time.perf_counter()
    logs = native.build()
    secs = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in logs.items()}
    emit({"phase": "build", "seconds": secs, "sources": list(native.CUDA_SOURCES),
          "ptxas": ptxas})
    sync()

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    bf = torch.bfloat16
    iters = 3 if args.quick else 10
    summary = {}

    # ---- 3a. K1 conv link, six configurations of the chain at the bs8 eval latent
    lh, lw = H_IMG // 2, W_IMG // 2
    links = [  # (name, cin, cout, gn+relu, add+te, stats)
        ("ne0", 16, 64, False, False, True),
        ("ne1", 64, 256, True, False, True),
        ("fa", 256, 256, True, True, False),
        ("fb", 256, 256, False, False, False),
        ("pr0", 256, 64, False, False, True),
        ("pr1", 64, 16, True, False, True),
    ]
    k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
              flops=0.0, bytes=0.0)
    for lname, cin, cout, gn, add, stats in links:
        x = randn(B, lh, lw, cin, dtype=bf)
        w = randn(3, 3, cin, cout, dtype=bf, scale=(9 * cin) ** -0.5)
        bias = randn(cout, scale=0.1)
        kw = dict(stats=stats)
        if gn:
            kw.update(aeff=(1.0 + randn(B, cin, scale=0.1)).contiguous(),
                      beff=randn(B, cin, scale=0.1), relu=True)
        if add:
            kw.update(add=randn(B, lh, lw, cin, dtype=bf), te=randn(B, cin, dtype=bf, scale=0.1))
        y_k, ps_k = conv_link(x, w, bias, **kw)
        y_p, ps_p = conv_link_plain(x, w, bias, **kw)
        sync()
        err = (y_k.float() - y_p.float()).abs().max().item()
        ref = y_p.float().abs().max().item()
        # bf16 y: f32 sums in another order may round to the neighbouring
        # bf16 value (2^-8 relative); 1e-2 of the map's largest value
        tol = 1e-2 * ref
        rec = {"phase": "kernel", "kernel": "conv_link", "link": lname, "cin": cin,
               "cout": cout, "shape": [B, lh, lw], "max_abs_err": err, "tol": tol}
        check(math.isfinite(err) and err <= tol, f"conv_link {lname}: {err} > {tol}")
        if stats:
            sk = ps_k.sum(1)
            sp = ps_p.sum(1)
            serr = ((sk - sp).abs().max() / sp.abs().max()).item()
            rec["stats_rel_err"] = serr
            # f32 sums of ~1e6 terms in another order
            check(serr <= 1e-4, f"conv_link {lname} stats: {serr}")
        ms = cuda_ms(lambda: conv_link(x, w, bias, **kw), iters)
        plain_ms = cuda_ms(lambda: conv_link_plain(x, w, bias, **kw), max(1, iters // 3), 1)
        v = _link_input_plain(x, kw.get("aeff"), kw.get("beff"), gn, kw.get("add"),
                              kw.get("te")).to(bf).permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = bias.to(bf)
        lib_ms = cuda_ms(lambda: F.conv2d(v, w_lib, b_lib, padding=1), iters)
        n_pix = B * lh * lw
        nbytes = (n_pix * cin * 2 * (2 if add else 1) + 9 * cin * cout * 2 + cout * 4
                  + n_pix * cout * 2 + (2 * B * cin * 4 if gn else 0)
                  + (B * cin * 2 if add else 0)
                  + (B * lh * math.ceil(lw / 128) * 2 * cout * 4 if stats else 0))
        flops = 2.0 * n_pix * 9 * cin * cout
        bms, by = bound(nbytes, flops, BF16_FLOPS)
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                   tflops=flops / ms / 1e9)
        emit(rec)
        for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                       ("library_ms", lib_ms), ("flops", flops), ("bytes", nbytes)):
            k1[k] += val
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        del x, w, y_k, y_p, v
    k1["bound_by"] = bound(k1["bytes"], k1["flops"], BF16_FLOPS)[1]
    summary["conv_link"] = k1
    sync()

    # ---- 3b. K3 DDIM step on the latent, scalars of a mid-trajectory step
    sched_rows = torch.from_numpy(DDIMSchedule().inference_tables(STEPS).sched()).to(dev)
    u6 = randn(B, lh, lw, 16, dtype=bf)
    xl = randn(B, lh, lw, 16)
    a3 = (1.0 + randn(B, 16, scale=0.1)).contiguous()
    b3 = randn(B, 16, scale=0.1)
    k3 = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    for i in (0, STEPS // 2, STEPS - 1):
        s = sched_rows[i]
        out_k = ddim_step(u6, a3, b3, xl, s)
        out_p = ddim_step_plain(u6, a3, b3, xl, s)
        sync()
        err = (out_k - out_p).abs().max().item()
        ref = out_p.abs().max().item()
        # f32 update; contraction into FMAs and division rounding: ulps,
        # amplified by 1/sqrt(a_t) (up to ~160 at t=950)
        tol = 1e-5 * ref
        emit({"phase": "kernel", "kernel": "ddim_step", "step": i, "max_abs_err": err,
              "tol": tol})
        check(math.isfinite(err) and err <= tol, f"ddim_step {i}: {err} > {tol}")
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
    s = sched_rows[STEPS // 2]
    k3["ms"] = cuda_ms(lambda: ddim_step(u6, a3, b3, xl, s), iters * 5)
    k3["plain_ms"] = cuda_ms(lambda: ddim_step_plain(u6, a3, b3, xl, s), iters)
    n = u6.numel()
    k3_bytes = n * (2 + 4 + 4) + 2 * B * 16 * 4 + 16
    k3["bound_ms"], k3["bound_by"] = bound(k3_bytes, 12.0 * n, F32_FLOPS)
    k3["library_ms"] = None
    emit({"phase": "kernel", "kernel": "ddim_step", **k3})
    summary["ddim_step"] = k3
    del u6, xl
    sync()

    # ---- 3c. K4 window attention at the four Swin-L stages, bs8 352x1216
    k4 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    for stage, (depth, heads, c) in enumerate(zip(SWIN_L["depths"], SWIN_L["heads"],
                                                  SWIN_L["dims"])):
        # tokens of the stage: H/4 x W/4 halved per stage, odd sizes padded up
        hh, ww = -(-H_IMG // (4 << stage)), -(-W_IMG // (4 << stage))
        h_pad, w_pad = hh + (-hh) % 7, ww + (-ww) % 7
        nw = (h_pad // 7) * (w_pad // 7)
        qkv = randn(B, nw, 49, 3 * c, dtype=bf)
        bias = randn(heads, 49, 49, scale=0.1)
        scale = (c // heads) ** -0.5
        for shifted in (False, True):
            mask = (torch.from_numpy(shifted_window_mask(h_pad, w_pad, 7, 3)).to(dev)
                    if shifted else None)
            out_k = window_attention(qkv, bias, mask, scale, heads)
            out_p = window_attention_plain(qkv, bias, mask, scale, heads)
            sync()
            err = (out_k.float() - out_p.float()).abs().max().item()
            # bf16 output and bf16 probabilities: a probability or the
            # output may round to the neighbouring bf16 value
            tol = 2e-2
            check(math.isfinite(err) and err <= tol, f"window_attention s{stage}: {err}")
            ms = cuda_ms(lambda: window_attention(qkv, bias, mask, scale, heads), iters)
            plain_ms = cuda_ms(lambda: window_attention_plain(qkv, bias, mask, scale, heads),
                               max(1, iters // 3), 1)
            q, k, v = (t.reshape(B * nw, heads, 49, c // heads) for t in
                       qkv.view(B, nw, 49, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5))
            if mask is None:
                amask = bias[None].to(bf)
            else:
                amask = (bias[None] + mask[:, None]).to(bf)
                amask = amask.expand(B, nw, heads, 49, 49).reshape(B * nw, heads, 49, 49)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=amask, scale=scale), iters)
            nbytes = qkv.numel() * 2 + B * nw * 49 * c * 2 + bias.numel() * 4 + (
                mask.numel() * 4 if shifted else 0)
            flops = 4.0 * B * nw * heads * 49 * 49 * (c // heads)
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            emit({"phase": "kernel", "kernel": "window_attention", "stage": stage,
                  "shifted": shifted, "shape": [B, nw, 49, 3 * c], "heads": heads,
                  "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                  "gbps": nbytes / ms / 1e6})
            reps = depth // 2  # half the blocks of a stage are shifted
            k4["ms"] += reps * ms
            k4["plain_ms"] += reps * plain_ms
            k4["library_ms"] += reps * lib_ms
            k4["bound_ms"] += reps * bms
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
        del qkv, out_k, out_p
    k4["bound_by"] = "bytes"
    summary["window_attention"] = k4
    sync()

    launches = {k: 0 for k in port.LAUNCHES}
    if not args.quick:
        # ---- 4. a small input against the CPU plain versions
        def micro_cfg(opt):
            return port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                               backbone_name="swin_micro",
                               head_specify="DDIMDepthEstimate_Swin_ADDHAHI",
                               inference_steps=2, opt_level=opt,
                               head_in_channels="32,64,128,256").finalize()

        cpu_gen = torch.Generator().manual_seed(1)
        rgb = torch.randn(2, 64, 96, 3, generator=cpu_gen)
        gt = torch.rand(2, 64, 96, 1, generator=cpu_gen) * 8 + 1
        ref = {}
        for opt, tol in (("O0", 1e-3), ("O1", 2e-2)):
            gpu_m = port.build_model(micro_cfg(opt))
            cpu_m = port.build_model(micro_cfg(opt), device="cpu")
            cpu_m.load_state_dict(gpu_m.state_dict())
            errs = {}
            with torch.no_grad():
                outs = []
                for m, d in ((gpu_m, dev), (cpu_m, torch.device("cpu"))):
                    fp = m.depth_backbone(rgb.to(d))
                    head = m.depth_head
                    gt_t = head.depth_transform.t(gt.to(d))
                    cond = head.model.upsample_condition(
                        head.fpn_condition(head.hahineck(fp)), gt_t.shape[1:3])
                    lat = torch.randn(2, 32, 48, 16, generator=torch.Generator().manual_seed(2))
                    eps = head.model(lat.to(d), 500, cond)
                    outs.append([t.float().cpu() for t in (*fp, cond, eps)])
                for i, (a, b_) in enumerate(zip(*outs)):
                    errs[i] = ((a - b_).abs().max() / b_.abs().max()).item()
            # f32 (O0): another summation order; bf16 (O1): 8-bit rounding
            # at other points, renormalised by the GroupNorms
            ref[opt] = {"rel_err": list(errs.values()), "tol": tol}
            check(all(math.isfinite(e) and e <= tol for e in errs.values()),
                  f"reference {opt}: {errs}")
            pred, met, _ = port.make_eval_step(gpu_m)(
                {"rgb": rgb.to(dev), "gt": gt.to(dev)},
                generator=torch.Generator(device=dev).manual_seed(3))
            check(tuple(pred.shape) == (2, 64, 96, 1) and bool(torch.isfinite(pred).all())
                  and bool(torch.isfinite(met).all()), f"micro eval {opt} not finite")
            del gpu_m, cpu_m
        emit({"phase": "reference", "what": "swin_micro + flagship head, card vs CPU plain; "
              "outputs: 4 pyramid levels, condition map, one denoiser call", **ref})
        sync()

        # ---- 5. serve the flagship configuration
        cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                          backbone_name="swin_large_naive_l4w722422k",
                          head_specify="DDIMDepthEstimate_Swin_ADDHAHI",
                          inference_steps=STEPS, opt_level="O1", seed=7240).finalize()
        t0 = time.perf_counter()
        model = port.build_model(cfg)
        step = port.make_eval_step(model)
        n_params = sum(p.numel() for p in model.parameters())
        sync()
        build_s = time.perf_counter() - t0
        dgen = torch.Generator(device=dev).manual_seed(cfg.seed)

        def request():
            rgb = torch.randn(B, H_IMG, W_IMG, 3, generator=dgen, device=dev)
            depth = torch.rand(B, H_IMG, W_IMG, 1, generator=dgen, device=dev) * 79 + 1
            valid = torch.rand(B, H_IMG, W_IMG, 1, generator=dgen, device=dev) < 0.3
            return {"rgb": rgb, "gt": depth * valid}

        warm = request()
        sync()
        t0 = time.perf_counter()
        step(warm, generator=dgen)
        sync()
        warm_s = time.perf_counter() - t0

        n_req = 3
        batches = [request() for _ in range(n_req)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        port.reset_launch_counts()
        lat_ms, rows = [], []
        for batch in batches:
            t0 = time.perf_counter()
            pred, met, _ = step(batch, generator=dgen)
            sync()
            lat_ms.append(1e3 * (time.perf_counter() - t0))
            check(tuple(pred.shape) == (B, H_IMG, W_IMG, 1), f"pred shape {tuple(pred.shape)}")
            check(bool(torch.isfinite(pred).all()), "pred has non-finite values")
            check(bool(torch.isfinite(met).all()), f"metric row not finite: {met}")
            rows.append(met[0].tolist())
        launches = dict(port.LAUNCHES)
        expect = {"conv_link": 6 * STEPS * n_req, "ddim_step": STEPS * n_req,
                  "window_attention": sum(SWIN_L["depths"]) * n_req}
        check(launches == expect, f"launch counts {launches} != {expect}")
        # where the time of one request goes, device time by part
        batch = batches[0]
        head = model.depth_head
        parts = {}

        def part(name, fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            sync()
            parts[name] = start.elapsed_time(end)
            return out

        with torch.no_grad():
            fp = part("backbone_ms", lambda: model.depth_backbone(batch["rgb"]))
            gt_t = part("depth_encode_ms", lambda: head.depth_transform.t(batch["gt"]))
            cond = part("hahi_fpn_upsample_ms", lambda: head.model.upsample_condition(
                head.fpn_condition(head.hahineck(fp)), gt_t.shape[1:3]))
            lat = part("sampler_ms", lambda: head._sample(
                cond, (B, gt_t.shape[1], gt_t.shape[2], 16), dgen))
            part("depth_decode_ms", lambda: head.depth_transform.inv_t(lat))
        emit({"phase": "breakdown", "request": "bs8 352x1216, 20 steps", **parts})
        del fp, cond, lat
        sync()

        emit({"phase": "serve", "config": "Diffusion_DCbase_ swin_large_naive_l4w722422k "
              "DDIMDepthEstimate_Swin_ADDHAHI O1", "batch": B, "image": [H_IMG, W_IMG],
              "steps": STEPS, "params": n_params, "build_s": build_s, "warmup_s": warm_s,
              "latency_ms": lat_ms, "frames_per_s": B * n_req / (sum(lat_ms) / 1e3),
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "metric_names": ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"],
              "metric_rows": rows, "launches": launches, "expected_launches": expect})
        sync()

    sources = {"conv_link": ("cuda", "diffusiondepth_tpu_torch/csrc/conv_link.cu",
                             "diffusiondepth_tpu/ops/fused_denoiser.py:63"),
               "ddim_step": ("triton", "diffusiondepth_tpu_torch/csrc/ddim_step.py",
                             "diffusiondepth_tpu/ops/fused_denoiser.py:1583"),
               "window_attention": ("cuda", "diffusiondepth_tpu_torch/csrc/window_attention.cu",
                                    "diffusiondepth_tpu/ops/window_attention.py:294")}
    emit({"kernels": [
        {"name": k, "route": sources[k][0], "source": sources[k][1], "replaces": sources[k][2],
         "launches": launches[k], "max_abs_err": summary[k]["max_abs_err"],
         "ms": summary[k]["ms"], "plain_ms": summary[k]["plain_ms"],
         "bound_ms": summary[k]["bound_ms"], "bound_by": summary[k]["bound_by"],
         "library_ms": summary[k]["library_ms"]}
        for k in ("conv_link", "ddim_step", "window_attention")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
