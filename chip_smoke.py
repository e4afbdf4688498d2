#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build and kernel checks only

Phases, one JSON line each:

1. env     - torch/CUDA versions; the card's name and power limit (also
             printed raw, as nvidia-smi gives them);
2. build   - the CUDA kernels compiled with nvcc for sm_90a, one process
             per source, all at once; -Xptxas -v of the attention kernels
             (K4, K7, K8) and of K10 by kernel, and the count of
             tensor-core, ldmatrix and cp.async instructions in each
             library's SASS (cuobjdump);
3. kernel  - every kernel against its plain PyTorch version at the
             flagship shapes, in bf16. Eval: the conv link (K1) at its six
             configurations on the (8, 176, 608) latent, and again on the
             (4, 176, 453) latent of a training micro-batch, the DDIM step
             (K3) on the eval latent, window attention (K4) at the four
             Swin-L stages of a 352x1216 batch of 8, plain and shifted, and
             again at those of a 352x906 batch of 4 (training). Training:
             the scheduler step (K2) and its backward (K6) on the
             (4, 176, 453) latent, the conv-link backward (K5) at its six
             configurations there (run twice: the two results must be
             bit-equal), the window-attention backward (K7) at the four
             Swin-L stages of a 352x906 batch of 4, plain and shifted.
             The X4 model's quarter-resolution latents: K1 and K3 on
             (8, 88, 304) (serve), K1, K2, K6 and K5 (two launches
             bit-equal) on (4, 88, 226) (a micro-batch of 352x904 crops).
             Opt-in paths: the split q/k/v window attention (K8) at the K4
             shapes, against its plain version and, bit for bit, against
             K4 on the same data; the bf16 LayerNorm forward (K9) and
             backward (K10, run twice: bit-equal) at each (rows, channels)
             of the Swin-L norms of a 352x906 batch of 4, with K10's plan
             and the share of the bound per shape and per pass, then at
             every kind of width beyond Swin's (LN_ANY_SHAPES: C = 1 to
             65536, K10's staged rows and wide variant, K9's looped
             variant) with exact launch counts. Each
             reports its error against its tolerance, its time, the plain
             version's time, a library call's time where one exists and the
             least time the card could take (bound). The kernels that may take
             under 0.1 ms (K2, K3, K6, K9, K10, and the library's LayerNorm)
             are timed by replaying a CUDA graph of 100 launches, which
             leaves the host's launch cost out, beside the event-timed loop;
4. reference - swin_micro under the flagship head on the card against the
             same weights on the CPU (plain versions): backbone pyramid,
             condition map and one denoiser call; then one training step
             (loss and every parameter's gradient), f32 and bf16;
5. serve   - the flagship configuration (Swin-L + HAHI + DDIM head, FPN 256,
             20 steps, bf16) with weights from a seed serves 3 requests of
             8 x 352x1216 through make_eval_step after one warm-up request;
             reports latency, frames/s, peak memory and the metric row, and
             requires the kernels' launch counts of exactly 120 (K1), 20
             (K3) and 24 (K4) per request; then the device time of one
             request split into backbone, depth encode, HAHI + FPN +
             upsample, the 20-step sampler and the decode;
   serve-pallas - the same model and batches with use_pallas: 3 requests
             after one warm-up, exactly 24 K8, 0 K4, 120 K1 and 20 K3
             launches per request, and a backbone pyramid within 1e-2 of
             the default route's;
   leaderboard - the same weights at 50 steps with flip-TTA (batch 8,
             16 after doubling): 2 requests after one warm-up, exactly
             300 K1, 50 K3 and 24 K4 launches per request;
6. train   - the flagship training configuration (352x906 crops, global
             batch 8 as 2 accumulated micro-batches of 4, 1.0*L1+1.0*L2+
             1.0*DDIM, Adam, drop-path 0.1, per-block rematerialisation)
             takes one warm-up and 3 timed steps through make_train_step;
             reports step time, samples/s, peak memory and the loss terms,
             requires finite losses and gradients, non-zero gradients in
             every part of the model and exact launch counts of every
             kernel; then the device time of one step split into backbone
             forward, head forward, sampler, ddim_loss + decode, backward
             and optimizer;
   reference (hahi-att) - swin_micro + DDIMDepthEstimate_Swin_ADDHAHI
             built with hahi_self_att and hahi_cross_att (random MSDA
             offset and weight projections), 2 x 64x96, 4 steps from a fixed
             latent, f32 with TF32 off: pred card against CPU (1e-3), one
             training step's loss and per-leaf gradients (2e-2); and
             PureMSDEnTransformer and PixelTransformerDecoder (classify on
             and off) card against CPU (1e-4);
   serve-hahi-att - the serve configuration with both attentions on
             (embed 512, 8 heads, 8 points, 256 encoding features): 3
             requests after one warm-up, exactly 120 K1, 20 K3 and 24 K4
             per request, latency, frames/s and peak memory beside phase 5's
             latency; the device time of one request by part, the neck split
             into its conv path, self-attention and cross-attention, and the
             attention's share; the sampler's top kernels; the MSDA core
             alone at the serve shapes in bf16 (the cross-attention's 26752
             level-0 queries and the self-attention's 8778 fused tokens per
             image): time, bound, top kernels;
   train-hahi-att - the training recipe of phase 6 with both attentions
             on: one warm-up and 2 timed steps, finite losses and gradients,
             non-zero gradients in level_embed, each MSDA's four projections
             and reference_points_fc, phase 6's launch counts, peak memory and
             the device time of one step by part (the attentions' forward
             split out);
7. layernorm - LayerNorm(dtype=bf16) forward and backward through
             LayerNormBF16, card against CPU, at the largest Swin-L norm,
             the same from a view that does not start on 16 bytes, and
             C = 7 from such a view, with exactly one K9 and one K10
             launch each;
8. reference (families) - mmbev_res18 + DDIMDepthEstimate_Res and
             mpvit_tiny + DDIMDepthEstimate_MPVIT_ADDHAHI at the micro
             shapes, card against CPU, f32 and bf16, module by module from
             the CPU's inputs (each backbone stage, neck + FPN + upsample,
             one denoiser call), and one training step, at the flagship
             reference's tolerances;
9. serve-res50 - bench.py's res50 cell (mmbev_res50 + DDIMDepthEstimate_Res,
             bf16, 20 steps, 8 x 352x1216): 3 requests after one warm-up,
             latency, frames/s, peak memory, the metric rows, and exactly 0
             launches of every kernel per request (the 'add' denoiser runs
             on cuDNN);
   serve-mpvit_small - bench.py's mpvit_small cell (mpvit_small +
             DDIMDepthEstimate_MPVIT_ADDHAHI, same batches): 3 requests
             after one warm-up, exactly 120 K1 and 20 K3 per request and 0
             of every other kernel, and the device time of one request by
             part;
10. train-mpvit_small - the flagship training recipe on mpvit_small: one
             warm-up and 2 timed steps, finite losses, non-zero gradients
             in the backbone, neck, FPN and denoiser, every backbone
             BatchNorm statistic bit-unchanged (norm_eval) while every head
             statistic moves, the flagship train launch counts of K1, K2,
             K5, K6 and 0 of K4 and K7; the device time of one step by part;
11. cli    - the runtime, through diffusiondepth_tpu_torch.main: a KITTI-DC
             tree written with the port's PNG writer (16 train and 8 val
             frames at 375x1242, 8 test frames at 352x1216); main.train with
             the README's flags (flagship, bf16, 352x906 crops, global batch
             8 = 2 x 4, 1 epoch, --save_full): 2 steps, a val and a test
             pass, exact K1-K7 launch counts, finite logged losses, the
             metric logs, the event files' records and CRCs; the loader's
             throughput alone with a thread per core; --test_only on the
             checkpoint (bit-equal reload, KITTI submission PNGs that decode
             to uint16(pred * 256), the "Average processing time"); --resume
             (starts at epoch 2, the optimizer count going on from 2).
             Reports step times, the share of each step spent waiting on
             the loader, the loader's frames/s, eval times and peak memory.

12. reference (nlspn) - NLSPN resnet18 (prop_time 3, 2 x 32x48, random
             offset-conv weights) on the card against the CPU, f32 and bf16,
             at radius 6 (the stencil) and 0 (the gather): every output,
             then one training step's loss and per-leaf gradients;
13. serve-nlspn - the NLSPN recipe (resnet34, 18 steps, TGASS, conf_prop,
             f32, weights from seed 7240 with a random offset conv) serves 3
             requests of 8 x 240x1216 after one warm-up, at radius 6 and at
             radius 0: latency, frames/s, peak memory, the device time of one
             request by part (encoder-decoder, offset/affinity + stencil
             build, the 18-step propagation), 0 launches of every kernel;
             the two radii's propagations agree on the serve batch's own
             operands with the offsets held to [-6, 6]; one propagation step
             alone at each radius against its bound;
14. train-nlspn - the recipe at global batch 8, 240x1216, 1.0*L1+1.0*L2,
             Adam, radius 6: one warm-up and 2 timed steps, step time,
             samples/s, peak memory, the device time by part, finite and
             non-zero gradients in the encoder, the decoders, the offset conv
             and aff_scale_const, 0 launches;
15. cli-nlspn - phase 11 with the recipe's flags (--model_name NLSPN ...):
             NLSPNSummary's gamma scalar and 5-column panels on the card.
16. cli-nyu - the CLI's default run, NLSPN on NYUv2 with its authors'
             flags (resnet34, 18 steps, TGASS, conf_prop, --max_depth 10
             --num_sample 500, batch 12 of the 228x304 crop): an NYU tree
             written with the port's HDF5 writer (48 frames in the train
             csv, split by the port's generate_json into 36 train and 12
             val, and 12 test frames under val/official, all 480x640), one
             file read back bit-equal; main.train for one epoch (3 steps, a
             val and a test pass, finite logs), --test_only on the
             checkpoint (bit-equal reload), the val split under --ip_basic,
             the loader alone at 1 thread and a thread per core; step
             times, each step's loader-wait share, eval seconds per batch,
             peak memory, and 0 launches of every kernel.
17. reference (x4, bins) - Diffusion_DCx4base_ (the X4 depth transform)
             under the flagship head and Diffusion_DCbase_ under the concat
             head DDIMDepthEstimate_Swin, both on swin_micro at 2 x 64x96,
             card against CPU, f32 and bf16: pyramid, condition map at the
             latent, one denoiser call, one training step (loss and every
             parameter's gradient); one eval step on the card;
18. serve-x4 - Diffusion_DCx4base_ at the serve configuration: 3 requests
             after one warm-up, exactly 120 K1, 20 K3 and 24 K4 per request
             (K1 and K3 at the (8, 88, 304) latent), latency, frames/s, peak
             memory, the device time by part and the sampler's top kernels;
19. serve-bins - DDIMDepthEstimate_Swin on Swin-L at the serve
             configuration: 3 requests after one warm-up, exactly 24 K4 and
             0 of every other kernel per request (the concat denoiser runs on
             cuDNN), the same reports;
20. train-x4 - Diffusion_DCx4base_ with the flagship training recipe on
             352x904 crops (906 % 4 == 2 would widen its prediction to 908):
             one warm-up and 2 timed steps, finite losses, non-zero gradients
             in the backbone, neck, FPN, denoiser and the X4 decoder's three
             layers, the flagship train launch counts, the device time of one
             step by part.
21. export-serve - the deployment path at the serve configuration: the
             seed-7240 weights written as a reference-layout .pt
             ({"net": state dict}) and converted by tools/convert_checkpoint
             (every tensor replaced); three artifacts exported by
             tools/export_model with seed-7241 weights at 8 x 352x1216, 20
             steps, bf16 (plain, --tta, use_pallas; export seconds and file
             size); each loaded, given the converted checkpoint and served 1
             warm-up and 3 timed requests (latency, frames/s, peak memory)
             beside the eager make_eval_step on the same batches and starting
             latents: pred bit-equal (else the first operator where the two
             parted is reported) and exactly 120 K1, 20 K3 and 24 K4 (K8
             under use_pallas) per request; tools/serve.serve_dir over 11 PNGs
             (a batch of 8 and a ragged 3) against the eager predictions; one
             served request traced with torch.profiler and summarised by
             tools/analyze_trace (the three kernels with their counts in the
             trace, beside ops.native.LAUNCHES counted around the same
             request: both exact); the
             operators' dispatch cost (1000 K3 calls through the operator and
             direct); tools/eval_parity with 2 seeds on phase 11's 8 KITTI-DC
             test frames at batch 1 (finite statistics).
22. ddp    - data parallelism (parallel/): two ranks sharing the one card
             (gloo: NCCL refuses two ranks on one device), started by the
             port's launcher. (a) phase 6's recipe at global batch 8 = 2
             micro-batches x (2 ranks x 2 rows), weights from seed 7240:
             the first step against one process on rank 0 from the same
             weights, batch and generator seed (loss and its row, the
             all-reduced gradient's relative L2 distance, the BatchNorm
             statistics; bf16 tolerances by DDP_BF16_*), then 2 timed
             steps: step ms, all-reduce ms and bytes and peak memory per
             rank, the train launch counts on every rank, and both ranks'
             parameters and buffers bit-equal; (b) serve's batch of 8 split
             4 + 4, 20 steps: each rank's rows bit-equal to one process on
             them from the same latent rows, the metric row equal to
             evaluate_depth_metrics on the gathered pred (1e-6), pred
             against one process on all 8 (reported), serve's launch counts
             on every rank; (c) in f32 with TF32 and cuDNN off, swin_micro
             under the flagship head (accum 2), two ranks against one
             process at the CPU tests' tolerances, and phase 12's NLSPN
             micro model reported beside one process's own repeat; then
             main's train at --mesh_shape data:1 (a one-rank NCCL group) on
             an 8-frame KITTI-DC tree against the run with no mesh: logs
             and checkpoint bit for bit, the same launch counts.
23. tp     - tensor parallelism (parallel/tensor.py): gloo ranks sharing
             the one card, as phase 22, the state cut by state_sharding at
             min_size 2**16. (a) model:2, phase 6's recipe (global batch 8
             = 2 x 4, 352x906, bf16, drop-path 0.1, seed 7240), 1 + 2
             steps: the first against one process on rank 0 from the same
             weights, batch and generator seed (loss and row, the whole
             gradient rebuilt from the shards, BatchNorm statistics, at
             phase 22's bf16 tolerances; each leaf's change by Adam's
             first update against one process's, relative L2 weighted by
             one process's |gradient|, over the leaves of >= 2 dims whose
             gradient is not float noise, every cut tensor among them:
             TP_ADAM_STEP_TOL),
             then step ms, the bytes of each collective kind (the last
             step synchronises each collective to time it) and peak
             memory per rank, the train launch counts on every rank, each
             rank's parameter and Adam elements equal to the sharding's
             reckoning, and the ranks' whole tensors bit-equal; one served bs8 request on the
             sharded serve model (no warm-up: its collectives dominate):
             serve's launch counts per rank, the metric row against the
             gathered pred (1e-6), the condition features and the first
             DDIM step's change of the latent against one process
             (TP_SERVE_TOL), pred against one process (reported: 20 bf16
             steps amplify the other rounding);
             (b) data:2,model:2 on four ranks, the same recipe for 1 + 1
             steps and checks (the second step times its collectives).

Then a line {"kernels": [...]} (each kernel's "dispatch": "op" for the
four torch.library operators, "direct" for the rest), the run's seconds and, last,
{"ok": true, "device": {...}}.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor cores
F32_FLOPS = 67e12  # outside the tensor cores

B, H_IMG, W_IMG = 8, 352, 1216
STEPS = 20
SWIN_L = dict(depths=(2, 2, 18, 2), heads=(6, 12, 24, 48), dims=(192, 384, 768, 1536))
# training: global batch 8 as 2 micro-batches of 4 on 352x906 crops
B_T, ACCUM, H_T, W_T = 8, 2, 352, 906
# the X4 model's training crops: 906 % 4 == 2 widens its prediction to 908,
# which both packages refuse against a 906-wide ground truth
W_X4T = 904
# the kernels of K5's three passes, by a part of their names
K5_PASSES = ("data_grad_kernel", "weight_grad_kernel", "reduce_kernel")
LINKS = [  # (name, cin, cout, gn+relu in, add+te, stats out)
    ("ne0", 16, 64, False, False, True),
    ("ne1", 64, 256, True, False, True),
    ("fa", 256, 256, True, True, False),
    ("fb", 256, 256, False, False, False),
    ("pr0", 256, 64, False, False, True),
    ("pr1", 64, 16, True, False, True),
]


def swin_stage_grid(h_img, w_img, stage):
    """(height, width) of a Swin stage's token grid: the patch embedding
    and each PatchMerging round up."""
    return -(-h_img // (4 << stage)), -(-w_img // (4 << stage))


def swin_stage_windows(h_img, w_img, stage):
    """(padded height, padded width, windows) of a Swin-L stage's 7x7 grid."""
    hh, ww = swin_stage_grid(h_img, w_img, stage)
    h_pad, w_pad = hh + (-hh) % 7, ww + (-ww) % 7
    return h_pad, w_pad, (h_pad // 7) * (w_pad // 7)


# (rows, channels) of the LayerNorm kernels beyond the Swin-L widths: C = 1,
# odd, C % 8 != 0, above 3072, above K10's ring and above K9's
# one-program row
LN_ANY_SHAPES = ((1001, 1), (777, 7), (513, 100), (300, 3080), (129, 4100), (33, 9000),
                 (3, 65536))


def swin_norm_shapes(b, h_img, w_img):
    """{(rows, channels): norms per Swin-L forward}: the patch-embedding
    norm, two per block and one output norm per stage at the stage's
    tokens, and each PatchMerging norm at the next stage's tokens and four
    times the channels."""
    shapes = {}
    for stage, (depth, c) in enumerate(zip(SWIN_L["depths"], SWIN_L["dims"])):
        hh, ww = swin_stage_grid(h_img, w_img, stage)
        m = b * hh * ww
        shapes[(m, c)] = shapes.get((m, c), 0) + 2 * depth + 1 + (stage == 0)
        if stage + 1 < len(SWIN_L["dims"]):
            hn, wn = swin_stage_grid(h_img, w_img, stage + 1)
            shapes[(b * hn * wn, 4 * c)] = 1
    return shapes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError("check failed: " + msg)


def bound(nbytes: float, flops: float, peak: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


# the KITTI-DC tree of phase 11: split -> (frames, height, width)
KITTI_TREE = {"train": (16, 375, 1242), "val": (8, 375, 1242), "test": (8, 352, 1216)}
# phase 11's model and data flags: the flagship at the README's crop
CLI_FLAGS = ["--model_name", "Diffusion_DCbase_", "--backbone_module", "swin",
             "--backbone_name", "swin_large_naive_l4w722422k",
             "--head_specify", "DDIMDepthEstimate_Swin_ADDHAHI",
             "--loss", "1.0*L1+1.0*L2+1.0*DDIM", "--opt_level", "O1",
             "--patch_height", "352", "--patch_width", "906", "--top_crop", "16"]


def write_kitti_tree(root: str, tree=None, seed: int = 0) -> None:
    """A KITTI-DC tree under ``root``, written with the port's PNG writer:
    16 train and 8 val frames at KITTI's raw 375x1242 (RGB8 images, gray16
    sparse depth and ground truth with ~5% of the pixels set, calib files
    with P_rect_02) and 8 test frames at 352x1216 (KITTI-DC's selection
    size, single-line intrinsics), and its split JSON."""
    import numpy as np

    from diffusiondepth_tpu_torch.native.png import write_png

    rng = np.random.RandomState(seed)
    p_rect = ("7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 "
              "7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 "
              "1.000000e+00 2.745884e-03")
    split = {}
    for mode, (n, h, w) in (tree or KITTI_TREE).items():
        entries = []
        for i in range(n):
            d = os.path.join(mode, f"drive_{i:04d}")
            os.makedirs(os.path.join(root, d), exist_ok=True)
            # a smooth scene with noise: a ramp of depth and colour
            ramp = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
            rgb = (200 * ramp[..., None] * rng.rand(1, 1, 3) + 40 * rng.rand(h, w, 3))
            write_png(os.path.join(root, d, "image_02.png"), rgb.astype(np.uint8))
            depth = (5.0 + 70.0 * ramp + rng.rand(h, w)) * 256.0
            for name in ("velodyne_raw", "groundtruth"):
                keep = rng.rand(h, w) < 0.05
                write_png(os.path.join(root, d, name + ".png"),
                          np.where(keep, depth, 0).astype(np.uint16))
            if mode == "test":
                calib = "intrinsics.txt"
                with open(os.path.join(root, d, calib), "w") as f:
                    f.write("721.5377 0.0 596.5593 0.0 721.5377 149.854 0.0 0.0 1.0\n")
            else:
                calib = "calib_cam_to_cam.txt"
                with open(os.path.join(root, d, calib), "w") as f:
                    f.write(f"calib_time: 09-Jan-2012 13:57:47\nP_rect_02: {p_rect}\n")
            entries.append({"rgb": f"{d}/image_02.png", "depth": f"{d}/velodyne_raw.png",
                            "gt": f"{d}/groundtruth.png", "K": f"{d}/{calib}"})
        split[mode] = entries
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump(split, f)


def run_main(port, torch, device, argv, save_dir, fn):
    """``fn`` (``main.train`` or ``main.test``) on the config that ``argv``
    parses to, saving under ``save_dir``, with the launch counts set to 0
    just before: (cfg, state, launch counts, seconds)."""
    from diffusiondepth_tpu_torch.config import parse_args

    cfg = parse_args(argv)
    cfg.save_dir = save_dir
    port.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = fn(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return cfg, state, dict(port.LAUNCHES), time.perf_counter() - t0


def logged(path, names):
    """The values of each line of a text log, checked to hold ``names`` in
    order and finite values."""
    rows = []
    with open(path) as f:
        for line in f:
            pairs = [kv.split(": ") for kv in line.split("|", 2)[2].split("  ") if ": " in kv]
            check([k.strip() for k, _ in pairs] == list(names),
                  f"{path}: names {[k for k, _ in pairs]} != {names}")
            vals = [float(v) for _, v in pairs]
            check(all(math.isfinite(v) for v in vals), f"{path}: {line}")
            rows.append(vals)
    return rows


def check_train_logs(cfg):
    """The files of one ``main.train`` epoch under ``cfg.save_dir``: the
    loss and metric logs (finite), the event files' records and CRCs
    (``read_events`` checks both; NLSPN adds Etc/gamma at val and test) and
    the val/test panels. Returns the logged loss rows."""
    from diffusiondepth_tpu_torch.losses import get_loss_names
    from diffusiondepth_tpu_torch.metrics import METRIC_NAMES
    from diffusiondepth_tpu_torch.native.png import read_png
    from diffusiondepth_tpu_torch.summary.tb_events import read_events

    losses = logged(os.path.join(cfg.save_dir, "loss_train.txt"), get_loss_names(cfg))
    for mode in ("train", "val", "test"):
        logged(os.path.join(cfg.save_dir, f"metric_{mode}.txt"), METRIC_NAMES)
    nlspn = cfg.model_name == "NLSPN"
    n_records = {"train": 1 + len(get_loss_names(cfg)) + 8, "val": 1 + 8 + 1 + nlspn,
                 "test": 1 + 8 + 1 + nlspn}
    for mode, n in n_records.items():
        (ev_file,) = [f for f in os.listdir(os.path.join(cfg.save_dir, mode))
                      if f.startswith("events.out.tfevents")]
        events = read_events(os.path.join(cfg.save_dir, mode, ev_file))
        check(len(events) == n, f"{mode} event file: {len(events)} records != {n}")
        check(events[0].get("file_version") == "brain.Event:2", "event file version")
        if mode != "train":
            panel = read_png(os.path.join(cfg.save_dir, mode, "images", "step_000001.png"))
            cols = 5 if nlspn else 4  # rgb | dep | pred | gt (| confidence)
            check(panel.shape[1] == cols * cfg.patch_width if mode == "val" else
                  panel.shape[1] % cols == 0, f"{mode} panel {panel.shape}")
    return losses


def cli_phase(port, torch, device, step_launches, eval_launches, flags=None, tree=None,
              phase="cli") -> dict:
    """Phase 11: main's train -> val -> test loop on a KITTI-DC tree, then
    --test_only on the saved checkpoint, then --resume, on ``device``, each
    required to launch ``step_launches`` per training step and
    ``eval_launches`` per eval batch. ``flags`` and ``tree`` default to the
    flagship's (``CLI_FLAGS``, ``KITTI_TREE``); the CPU tests rehearse the
    phase at a small size. NLSPN's val and test logs also hold its
    ``Etc/gamma`` scalar, and its panels the confidence strip (5 columns).
    Records are emitted under ``phase``. Returns the training run's launch
    counts."""
    import tempfile

    import numpy as np

    from diffusiondepth_tpu_torch import main as pmain
    from diffusiondepth_tpu_torch.data import DataLoader, get as get_data
    from diffusiondepth_tpu_torch.metrics import METRIC_NAMES
    from diffusiondepth_tpu_torch.native.png import read_png

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kitti_dc_")
    try:
        write_kitti_tree(root, tree)
        tree_s = time.perf_counter() - t_phase
        model_flags = ["--data_name", "KITTIDC", "--dir_data", root,
                       "--split_json", os.path.join(root, "split.json"), *(flags or CLI_FLAGS)]
        train_flags = model_flags + ["--batch_size", "8", "--accum_steps", "2",
                                     "--test_batch_size", "8", "--epochs", "1", "--save_full"]

        def run(argv, save_dir, fn):
            return run_main(port, torch, device, argv, os.path.join(root, save_dir), fn)

        def expect(train_steps, eval_batches):
            return {k: train_steps * step_launches.get(k, 0)
                    + eval_batches * eval_launches.get(k, 0) for k in port.LAUNCHES}

        # ---- train: 2 steps (16 frames, batch 8), a val and a test pass
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        cfg, state, launches, train_s = run(train_flags, "train", pmain.train)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        check(launches == expect(2, 2), f"cli train launch counts {launches} != "
              f"{expect(2, 2)}")
        check(state.step == 2 and state.optimizer.count == 2, f"cli train: step {state.step}")
        tm = state.timings
        losses = check_train_logs(cfg)
        ckpt = os.path.join(cfg.save_dir, "model_00001.ckpt")
        check(os.path.exists(ckpt), "no model_00001.ckpt")
        waits, steps = tm["wait_s"], tm["step_s"]
        emit({"phase": phase, "run": "train", "flags": " ".join(train_flags[6:]),
              "seconds": train_s, "tree_seconds": tree_s, "step_ms": [1e3 * x for x in steps],
              "loader_wait_ms": [1e3 * x for x in waits],
              "loader_wait_share": [w / (w + t) for w, t in zip(waits, steps)],
              "loader_batch_ms": [1e3 * x for x in tm["load_s"]],
              "loader_frames_per_s": 8 * len(tm["load_s"]) / sum(tm["load_s"]),
              "loader_threads": cfg.num_threads,
              "val_batch_ms": [1e3 * x for x in tm["val_s"]],
              "test_batch_ms": [1e3 * x for x in tm["test_s"]],
              "max_memory_allocated_gb": peak_gb, "loss_rows": losses,
              "launches": launches})

        # the same epoch's loader alone with a thread per core, for scale
        threads = os.cpu_count()
        loader = DataLoader(get_data(cfg)(cfg, "train"), cfg.batch_size, shuffle=True,
                            drop_last=True, num_threads=threads, prefetch=cfg.prefetch,
                            seed=cfg.seed)
        loader.set_epoch(1)
        t0 = time.perf_counter()
        frames = sum(b["rgb"].shape[0] for b in loader)
        emit({"phase": phase, "run": "loader", "threads": threads,
              "frames_per_s": frames / (time.perf_counter() - t0)})

        # ---- evaluate the checkpoint: --test_only, KITTI submission PNGs
        test_flags = model_flags + ["--test_only", "--pretrain", ckpt, "--test_batch_size", "4",
                                    "--save_image", "--save_result_only", "--save_raw_npdepth"]
        tcfg, tstate, t_launches, test_s = run(test_flags, "test_only", pmain.test)
        check(t_launches == expect(0, 2), f"cli test launch counts {t_launches} != "
              f"{expect(0, 2)}")
        trained, reloaded = state.model.state_dict(), tstate.model.state_dict()
        check(trained.keys() == reloaded.keys() and all(
            torch.equal(trained[k], reloaded[k]) for k in trained),
            "the reloaded checkpoint differs from the trained state")
        out_dir = os.path.join(tcfg.save_dir, "test", "epoch0000")
        pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        check(pngs == [f"{i:010d}.png" for i in range(8)], f"submission files {pngs}")
        for f in pngs:
            pred = np.load(os.path.join(out_dir, f.replace(".png", ".npy")))
            check(np.array_equal(read_png(os.path.join(out_dir, f)),
                                 (pred * 256.0).astype(np.uint16)),
                  f"{f} does not decode to uint16(pred * 256)")
        logged(os.path.join(tcfg.save_dir, "metric_test.txt"), METRIC_NAMES)
        timed = tstate.timings["test_s"][1:]  # batch 0 left out, as main's report
        emit({"phase": phase, "run": "test_only", "seconds": test_s,
              "test_batch_ms": [1e3 * x for x in tstate.timings["test_s"]],
              "average_processing_s": sum(timed) / (4 * len(timed)),
              "reload_bit_equal": True, "submission_pngs": len(pngs),
              "launches": t_launches})
        del tstate, trained, reloaded

        # ---- resume. The resume rule takes every arg but a few from the
        # checkpoint's args file, epochs too (as the reference does), so the
        # file is given the 2 epochs of a run stopped after its first
        args_json = ckpt.replace(".ckpt", ".args.json")
        with open(args_json) as f:
            saved = json.load(f)
        saved["epochs"] = 2
        with open(args_json, "w") as f:
            json.dump(saved, f, indent=2)
        resume_flags = model_flags + ["--resume", "--pretrain", ckpt, "--epochs", "2"]
        rcfg, rstate, r_launches, resume_s = run(resume_flags, "resume", pmain.train)
        check(r_launches == expect(2, 2), f"cli resume launch counts {r_launches}")
        check(rstate.optimizer.count == 4 and rstate.step == 4,
              f"resume: optimizer count {rstate.optimizer.count}, step {rstate.step}")
        with open(os.path.join(rcfg.save_dir, "loss_train.txt")) as f:
            epochs_logged = [line.split(" |")[0] for line in f]
        check(epochs_logged == ["0002"], f"resume logged epochs {epochs_logged}")
        check(sorted(f for f in os.listdir(rcfg.save_dir) if f.endswith(".ckpt"))
              == ["model_00002.ckpt"], "resume: checkpoint names")
        emit({"phase": phase, "run": "resume", "seconds": resume_s,
              "epochs_logged": epochs_logged, "optimizer_count": rstate.optimizer.count,
              "step_ms": [1e3 * x for x in rstate.timings["step_s"]],
              "loader_wait_ms": [1e3 * x for x in rstate.timings["wait_s"]],
              "launches": r_launches})
        del state, rstate
        sync()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": phase, "seconds": time.perf_counter() - t_phase})
    return launches


# NLSPN's recipe: the authors' KITTI-DC flags (resnet34, 18 steps, TGASS
# with gamma 0.5, confidence propagation, 240x1216 crops, f32)
NLSPN_FLAGS = ["--model_name", "NLSPN", "--network", "resnet34", "--prop_time", "18",
               "--prop_kernel", "3", "--affinity", "TGASS", "--affinity_gamma", "0.5",
               "--conf_prop", "--patch_height", "240", "--patch_width", "1216",
               "--top_crop", "100", "--test_crop", "--max_depth", "90",
               "--loss", "1.0*L1+1.0*L2", "--opt_level", "O0"]
B_N, H_N, W_N = 8, 240, 1216


def randomize_offset_conv(torch, model, seed, offset_scale):
    """Random weights for ``prop_layer.conv_offset_aff``, zero at init (where
    every offset is 0 and the propagation is the identity): N(0, 1 /
    fan-in), the offset channels scaled by ``offset_scale``, the bias
    N(0, 0.1^2); drawn from ``seed``."""
    conv = model.prop_layer.conv_offset_aff
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(conv.weight.shape, generator=g) / conv.weight[0].numel() ** 0.5
    w[:2 * model.prop_layer.num] *= offset_scale
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=g))


def attention_model(port, torch, cfg, device=None):
    """``port.build_model(cfg, device)`` with its head rebuilt with both of
    HAHI's deformable attentions on (``hahi_self_att``,
    ``hahi_cross_att``: no Config field reaches them, as in JAX), the
    head's weights drawn from ``cfg.seed + 1``; in eval mode."""
    model = port.build_model(cfg, device=device)
    head = model.depth_head
    dev = next(model.parameters()).device
    hic = cfg.head_in_channels
    if isinstance(hic, str):
        hic = tuple(int(c) for c in hic.split(","))
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(cfg.seed + 1)
        model.depth_head = type(head)(
            in_channels=hic, inference_steps=cfg.inference_steps,
            num_train_timesteps=cfg.num_train_timesteps, timestep_schedule=cfg.timestep_schedule,
            use_fused_denoiser=cfg.fused_denoiser, dtype=head.dtype, hahi_self_att=True,
            hahi_cross_att=True)
    return model.eval()


def randomize_msda(torch, model, seed, offset_scale=3.0):
    """Random ``sampling_offsets`` and ``attention_weights`` weights (zero
    at init, where only the bias path would be held) in every MSDA of
    ``model``: N(0, 1 / fan-in), the offsets scaled by ``offset_scale`` so
    that some points leave the maps; drawn from ``seed``."""
    from diffusiondepth_tpu_torch.ops.msda import MultiScaleDeformableAttention

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MultiScaleDeformableAttention):
                for lin, scale in ((m.sampling_offsets, offset_scale), (m.attention_weights, 1.0)):
                    w = torch.randn(lin.weight.shape, generator=g) / lin.weight.shape[1] ** 0.5
                    lin.weight.copy_(scale * w)


def nlspn_phases(port, torch, dev) -> dict:
    """Phases 12-15, NLSPN: the micro model card vs CPU, serving and
    training the recipe's model at 8 x 240x1216, and main's loop on it.
    Returns the launch counts of each path (every kernel 0)."""
    import numpy as np

    def sync():
        torch.cuda.synchronize()

    def timed(fn):
        """(result, device ms) of one call."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        sync()
        return out, start.elapsed_time(end)

    zero = {k: 0 for k in port.LAUNCHES}
    path_launches = {}

    # ---- 12. the micro model of the tests, card vs CPU, f32 and bf16, both
    # radii, with random offset-conv weights: every output, then one
    # training step
    def micro_batch(seed):
        rng = np.random.RandomState(seed)
        gt = (rng.rand(2, 32, 48, 1) * 80 + 1).astype(np.float32)
        gt[:, :3] = 0.0
        return {"rgb": torch.from_numpy(rng.randn(2, 32, 48, 3).astype(np.float32)),
                "dep": torch.from_numpy(gt * (rng.rand(2, 32, 48, 1) > 0.9)),
                "gt": torch.from_numpy(gt)}

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    t0 = time.perf_counter()
    ref = {}
    # f32: another summation order, amplified by the offsets through the
    # bilinear reads (1e-3; gradients 2e-2 RMS, as the flagship's micro
    # step). bf16: 8-bit rounding at other points (5e-2; gradients 0.25)
    for opt, tol, gtol in (("O0", 1e-3, 2e-2), ("O1", 5e-2, 0.25)):
        for radius in (6, 0):
            cfg = port.Config(model_name="NLSPN", network="resnet18", prop_time=3,
                              prop_stencil_radius=radius, opt_level=opt, loss="1.0*L1+1.0*L2",
                              max_depth=90.0, seed=11).finalize()
            gm = port.build_model(cfg)
            randomize_offset_conv(torch, gm, 11, 2.0)
            cm = port.build_model(cfg, device="cpu")
            cm.load_state_dict(gm.state_dict())
            batch = micro_batch(1)
            outs = []
            with torch.no_grad():
                for m, d in ((gm, dev), (cm, torch.device("cpu"))):
                    outs.append(m({k: v.to(d) for k, v in batch.items()}))
            errs = {k: rel(outs[0][k], outs[1][k]) for k in
                    ("pred", "pred_init", "pred_inter", "guidance", "offset", "aff", "confidence")}
            lc = port.LossComputer(cfg)
            losses, grads = [], []
            for m, d in ((gm, dev), (cm, torch.device("cpu"))):
                m.train()
                mb = {k: v.to(d) for k, v in batch.items()}
                loss = lc(mb, m(mb))[0] / 2
                loss.backward()
                losses.append(loss.item())
                grads.append({n: p.grad.double().cpu() for n, p in m.named_parameters()})
            rms = {n: g.square().mean().sqrt().item() for n, g in grads[1].items()}
            floor = 1e-3 * max(rms.values())
            dist = {n: (grads[0][n] - g).square().mean().sqrt().item() / max(rms[n], floor)
                    for n, g in grads[1].items()}
            worst = max(dist, key=dist.get)
            rec = {"rel_err": errs, "tol": tol, "loss": losses,
                   "loss_rel_err": abs(losses[0] - losses[1]) / abs(losses[1]),
                   "worst_leaf": worst, "worst_rms_dist": dist[worst], "grad_tol": gtol,
                   "offset_beyond_6": float((outs[1]["offset"].abs() > 6).float().mean())}
            ref[f"{opt} r{radius}"] = rec
            check(all(math.isfinite(e) and e <= tol for e in errs.values())
                  and rec["loss_rel_err"] <= tol and dist[worst] <= gtol,
                  f"reference (nlspn) {opt} r{radius}: {rec}")
            del gm, cm
    emit({"phase": "reference (nlspn)", "what": "NLSPN resnet18, prop_time 3, 2 x 32x48, card "
          "vs CPU: every output (relative max error), one training step (loss, per-leaf "
          "gradient RMS distance)", **ref, "seconds": time.perf_counter() - t0})

    # ---- 13. serve the recipe's model: 8 x 240x1216, 3 requests after one
    # warm-up, at radius 6 and at radius 0
    def nlspn_cfg(**kw):
        return port.Config(model_name="NLSPN", network="resnet34", prop_time=18, prop_kernel=3,
                           affinity="TGASS", affinity_gamma=0.5, conf_prop=True,
                           patch_height=H_N, patch_width=W_N, top_crop=100, test_crop=True,
                           max_depth=90.0, loss="1.0*L1+1.0*L2", opt_level="O0", seed=7240,
                           **kw).finalize()

    def request(g):
        depth = torch.rand(B_N, H_N, W_N, 1, generator=g, device=dev) * 79 + 1
        return {"rgb": torch.randn(B_N, H_N, W_N, 3, generator=g, device=dev),
                "dep": depth * (torch.rand(B_N, H_N, W_N, 1, generator=g, device=dev) < 0.05),
                "gt": depth * (torch.rand(B_N, H_N, W_N, 1, generator=g, device=dev) < 0.3)}

    def request_parts(model, batch):
        """Device ms of one request by part; the propagation's operands."""
        prop = model.prop_layer
        with torch.no_grad():
            (pred_init, guide, conf), enc = timed(lambda: model.heads(batch))

            def offset_aff():
                offset, aff = prop.offset_affinity(guide, conf)
                return offset, aff, prop.stencil(offset, aff, pred_init.dtype)

            (offset, aff, stencil), oa = timed(offset_aff)
            _, pr = timed(lambda: prop.propagate(pred_init, offset, aff, stencil, batch["dep"]))
        return ({"encoder_decoder_ms": enc, "offset_affinity_stencil_ms": oa,
                 "propagation_ms": pr}, (pred_init, offset, aff))

    serve = {}
    operands = None
    for radius in (6, 0):
        t_phase = t0 = time.perf_counter()
        cfg = nlspn_cfg(prop_stencil_radius=radius)
        model = port.build_model(cfg)
        randomize_offset_conv(torch, model, 7240, 3.0)
        step = port.make_eval_step(model)
        n_params = sum(p.numel() for p in model.parameters())
        sync()
        build_s = time.perf_counter() - t0
        g = torch.Generator(device=dev).manual_seed(7240)
        warm = request(g)
        t0 = time.perf_counter()
        step(warm)
        sync()
        warm_s = time.perf_counter() - t0
        batches = [request(g) for _ in range(3)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        lat, rows = [], []
        for batch in batches:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            pred, met, _ = step(batch)
            sync()
            lat.append(1e3 * (time.perf_counter() - t0))
            launches = dict(port.LAUNCHES)
            check(launches == zero, f"serve-nlspn r{radius} launch counts {launches}")
            check(tuple(pred.shape) == (B_N, H_N, W_N, 1) and bool(torch.isfinite(pred).all())
                  and bool(torch.isfinite(met).all()), f"serve-nlspn r{radius} not finite")
            rows.append(met[0].tolist())
        peak = torch.cuda.max_memory_allocated() / 1e9
        parts, ops = request_parts(model, batches[0])
        if radius == 6:
            operands = ops
        if radius == 6:
            # PyTorch's default for cuDNN, which the command line keeps:
            # f32 convolutions on the tensor cores in TF32
            torch.backends.cudnn.allow_tf32 = True
            step(warm)
            sync()
            tf32_ms = []
            for batch in batches:
                t0 = time.perf_counter()
                pred32, _, _ = step(batch)
                sync()
                tf32_ms.append(1e3 * (time.perf_counter() - t0))
            torch.backends.cudnn.allow_tf32 = False
            tf32 = {"latency_ms": tf32_ms, "pred_rel_err_vs_f32": rel(pred32, pred)}
        path_launches[f"serve-nlspn-r{radius}"] = launches
        serve[radius] = {"phase": "serve-nlspn", "radius": radius,
                         "config": "NLSPN resnet34 prop_time 18 TGASS conf_prop O0",
                         "batch": B_N, "image": [H_N, W_N], "params": n_params,
                         "build_s": build_s, "warmup_s": warm_s, "latency_ms": lat,
                         "frames_per_s": B_N * len(lat) / (sum(lat) / 1e3),
                         "max_memory_allocated_gb": peak, "metric_rows": rows,
                         "breakdown": parts, "launches_per_request": launches,
                         "offset_beyond_6": float((ops[1].abs() > 6).float().mean()),
                         **({"tf32_convolutions": tf32} if radius == 6 else {}),
                         "seconds": time.perf_counter() - t_phase}
        emit(serve[radius])
        if radius == 6:
            prop6 = model.prop_layer
        del step, batches, warm
        sync()

    # the two radii on the serve batch's own operands with the offsets held
    # to [-6, 6], where the stencil is exact: every pixel of pred agrees
    pred_init, offset, aff = operands
    off_c = offset.clamp(-6, 6)
    with torch.no_grad():
        p6, _ = prop6.propagate(pred_init, off_c, aff, prop6.stencil(off_c, aff, pred_init.dtype))
        p0, _ = model.prop_layer.propagate(pred_init, off_c, aff, None)
    agree = rel(p6, p0)
    check(agree <= 1e-4, f"serve-nlspn: radius 6 vs 0 on offsets within 6: {agree}")

    # one propagation step alone at each radius, and the least time the card
    # could take for it: the operands read once, the map written once
    def step_ms(fn, n=10):
        for _ in range(2):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / n

    from diffusiondepth_tpu_torch.ops.deform_conv import modulated_deform_conv
    from diffusiondepth_tpu_torch.ops.stencil_prop import build_stencil, stencil_apply

    px = B_N * H_N * W_N
    with torch.no_grad():
        M = build_stencil(offset, aff, 6)
        ones = torch.ones(3, 3, 1, 1, device=dev)
        prop_rec = {
            "phase": "propagation", "shape": [B_N, H_N, W_N],
            "stencil_step_ms": step_ms(lambda: stencil_apply(M, pred_init, 6)),
            "stencil_build_ms": step_ms(lambda: build_stencil(offset, aff, 6), 3),
            "gather_step_ms": step_ms(lambda: modulated_deform_conv(pred_init, offset, aff, ones,
                                                                    padding=1)),
            # stencil: M (256 f32) + the map in and out; gather: 18 offsets +
            # 9 affinities + the map in and out, per pixel
            "stencil_step_bound_ms": 1e3 * px * (256 + 2) * 4 / HBM_BYTES_PER_S,
            "gather_step_bound_ms": 1e3 * px * (18 + 9 + 2) * 4 / HBM_BYTES_PER_S,
            "stencil_step_flops": 2 * 256 * px, "gather_step_flops": 9 * 4 * 3 * px,
            "agree_rel_err_offsets_within_6": agree}
        del M
    emit(prop_rec)
    del model, prop6, operands, pred_init, offset, aff, off_c, p6, p0
    sync()

    # ---- 14. train the recipe's model: global batch 8 at 240x1216,
    # 1.0*L1+1.0*L2, Adam, radius 6; one warm-up and 2 timed steps
    t_phase = t0 = time.perf_counter()
    tcfg = nlspn_cfg(prop_stencil_radius=6, optimizer="ADAM", batch_size=B_N)
    model = port.build_model(tcfg)
    randomize_offset_conv(torch, model, 7240, 3.0)
    optimizer = port.make_optimizer(tcfg, 100, model)
    lc = port.LossComputer(tcfg)
    step = port.make_train_step(model, lc, optimizer)
    sync()
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(7240)
    t0 = time.perf_counter()
    step(request(g))
    sync()
    warm_s = time.perf_counter() - t0
    batches = [request(g) for _ in range(2)]
    sync()
    torch.cuda.reset_peak_memory_stats()
    step_ms_, terms = [], []
    for batch in batches:
        port.reset_launch_counts()
        t0 = time.perf_counter()
        loss, loss_val, met = step(batch)
        sync()
        step_ms_.append(1e3 * (time.perf_counter() - t0))
        t_launches = dict(port.LAUNCHES)
        check(t_launches == zero, f"train-nlspn launch counts {t_launches}")
        check(bool(torch.isfinite(loss_val).all()) and bool(torch.isfinite(met).all()),
              f"train-nlspn step not finite: {loss_val} {met}")
        terms.append(loss_val[0].tolist())
    peak = torch.cuda.max_memory_allocated() / 1e9
    groups = {"encoder": ("conv1_", "conv2.", "conv3.", "conv4.", "conv5.", "conv6."),
              "decoders": ("dec", "id_dec", "gd_dec", "cf_dec"),
              "conv_offset_aff": ("prop_layer.conv_offset_aff",),
              "aff_scale_const": ("prop_layer.aff_scale_const",)}
    gsum = {k: 0.0 for k in groups}
    for n_, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"train-nlspn: no or non-finite gradient in {n_}")
        for k, prefixes in groups.items():
            if n_.startswith(prefixes):
                gsum[k] += p.grad.abs().sum().item()
    check(all(v > 0 for v in gsum.values()), f"train-nlspn: zero gradients in a part: {gsum}")

    # where the time of one step goes, device time by part
    def train_parts(batch):
        parts = {}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        prop = model.prop_layer
        (pred_init, guide, conf), parts["encoder_decoder_fwd_ms"] = timed(
            lambda: model.heads(batch))

        def offset_aff():
            offset, aff = prop.offset_affinity(guide, conf)
            return offset, aff, prop.stencil(offset, aff, pred_init.dtype)

        (offset, aff, stencil), parts["offset_affinity_stencil_fwd_ms"] = timed(offset_aff)
        (y, _), parts["propagation_fwd_ms"] = timed(
            lambda: prop.propagate(pred_init, offset, aff, stencil, batch["dep"]))
        loss, parts["loss_ms"] = timed(
            lambda: lc(batch, {"pred": torch.clamp_min(y, 0.0)})[0] / B_N)
        cot = torch.autograd.grad(loss, y, retain_graph=True)[0]
        _, parts["backward_ms"] = timed(loss.backward)
        _, parts["optimizer_ms"] = timed(optimizer.step)
        parts["sum_ms"] = sum(parts.values())
        # the propagation's share of the backward: the stencil build and the
        # 18 steps alone, from detached operands, under the same cotangent
        leaves = [t.detach().requires_grad_() for t in (pred_init, offset, aff)]
        st = prop.stencil(leaves[1], leaves[2], pred_init.dtype)
        y2, _ = prop.propagate(leaves[0], leaves[1], leaves[2], st, batch["dep"])
        _, parts["of_which_propagation_bwd_ms"] = timed(lambda: y2.backward(cot))
        return parts

    emit({"phase": "train-nlspn", "config": "NLSPN resnet34 prop_time 18 TGASS conf_prop O0 "
          "radius 6 1.0*L1+1.0*L2 ADAM", "global_batch": B_N, "crop": [H_N, W_N],
          "build_s": build_s, "warmup_s": warm_s, "step_ms": step_ms_,
          "samples_per_s": B_N * len(step_ms_) / (sum(step_ms_) / 1e3),
          "max_memory_allocated_gb": peak, "loss_rows": terms, "grad_abs_sum": gsum,
          "gamma": model.prop_layer.aff_scale_const.item(),
          "breakdown": train_parts(batches[0]), "launches_per_step": t_launches,
          "seconds": time.perf_counter() - t_phase})
    path_launches["train-nlspn"] = t_launches
    del model, optimizer, step, batches, batch
    sync()

    # ---- 15. main's train -> val -> test, --test_only and --resume with the
    # recipe's flags on the KITTI-DC tree: NLSPNSummary's logs, gamma scalar
    # and panels, on the card
    path_launches["cli-nlspn"] = cli_phase(port, torch, dev, {}, {}, flags=NLSPN_FLAGS,
                                           phase="cli-nlspn")
    check(path_launches["cli-nlspn"] == zero, "cli-nlspn launched a kernel")
    return path_launches


# the NYUv2 tree of phase 16: frames of the train csv (split by generate_json
# into train and val at NYU_VAL_RATIO) and of val/official (the test split),
# at NYU's 480x640
NYU_TREE = {"train": 48, "test": 12}
NYU_HW = (480, 640)
NYU_VAL_RATIO = 0.25
# the reference's csv rows start with a 19-character prefix that
# generate_nyu_json strips
NYU_CSV_PREFIX = "/data/nyu_depth_v2/"
# the CLI's default run: NLSPN with its authors' NYUv2 settings (resnet34,
# 18 steps, TGASS with gamma 0.5, confidence propagation, f32), batch 12 of
# the fixed 228x304 crop, 500 sparse points
NYU_FLAGS = ["--model_name", "NLSPN", "--network", "resnet34", "--prop_time", "18",
             "--prop_kernel", "3", "--affinity", "TGASS", "--affinity_gamma", "0.5",
             "--conf_prop", "--max_depth", "10", "--num_sample", "500",
             "--loss", "1.0*L1+1.0*L2", "--opt_level", "O0"]


def write_nyu_tree(root: str, tree=None, hw=NYU_HW, seed: int = 0) -> dict:
    """An NYUv2 tree under ``root`` in the files' own layout, written with
    the port's HDF5 writer: ``tree["train"]`` frames under
    ``train/scene_XX/`` (four scenes) listed in a train csv, and
    ``tree["test"]`` under ``val/official/``; each file holds ``rgb`` (3, H,
    W) uint8 (a smooth scene with noise) and ``depth`` (H, W) float32 of
    0.5-10 m with ~20% holes. The split json (``split.json``) comes from
    the port's ``generate_nyu_json``. One file is read back and must be
    bit-equal to what was written. Returns the split."""
    import numpy as np

    from diffusiondepth_tpu_torch.native.hdf5 import read_datasets, write_datasets
    from diffusiondepth_tpu_torch.tools.generate_json import generate_nyu_json

    tree = tree or NYU_TREE
    h, w = hw
    rng = np.random.RandomState(seed)
    ramp = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    files = [f"train/scene_{i % 4:02d}/{i:05d}.h5" for i in range(tree["train"])]
    files += [f"val/official/{i:05d}.h5" for i in range(tree["test"])]
    written = None
    for name in files:
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        rgb = 200 * ramp[None] * rng.rand(3, 1, 1) + 40 * rng.rand(3, h, w)
        depth = (0.5 + 9.0 * ramp + 0.5 * rng.rand(h, w)).astype(np.float32)
        depth[rng.rand(h, w) < 0.2] = 0.0
        arrays = {"rgb": rgb.astype(np.uint8), "depth": depth}
        write_datasets(os.path.join(root, name), arrays)
        written = written or (name, arrays)
    back = read_datasets(os.path.join(root, written[0]), ("rgb", "depth"))
    check(all(back[k].dtype == v.dtype and np.array_equal(back[k], v)
              for k, v in written[1].items()), "HDF5 round trip is not bit-equal")
    csv_train = os.path.join(root, "nyudepth_hdf5_train.csv")
    with open(csv_train, "w") as f:
        f.writelines(f"{NYU_CSV_PREFIX}{n}\n" for n in files if n.startswith("train/"))
    csv_test = os.path.join(root, "nyudepth_hdf5_val.csv")
    open(csv_test, "w").close()
    split = generate_nyu_json(root, csv_train, csv_test, val_ratio=NYU_VAL_RATIO)
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump(split, f, indent=4)
    return split


def nyu_sample_stages(path, cfg, reps=5) -> dict:
    """Median ms of each stage of one augmented NYU training sample on one
    thread, in ``NYU.__getitem__``'s order (its draws fixed)."""
    import random

    import numpy as np

    from diffusiondepth_tpu_torch.data import transforms as T
    from diffusiondepth_tpu_torch.data.depth_completion import simple_depth_completion
    from diffusiondepth_tpu_torch.data.ip_basic import densify_depth_map
    from diffusiondepth_tpu_torch.data.nyu import CROP_SIZE
    from diffusiondepth_tpu_torch.native.hdf5 import read_datasets

    scale, degree = 1.25, 3.0
    size = int(240 * scale)
    stages = {
        "hdf5_read": lambda x: read_datasets(path, ("rgb", "depth")),
        "to_hwc": lambda f: (np.ascontiguousarray(f["rgb"].transpose(1, 2, 0)), f["depth"]),
        "hflip": lambda x: (T.hflip(x[0]), T.hflip(x[1])),
        "rotate_nearest": lambda x: (T.rotate(x[0], degree, T.NEAREST),
                                     T.rotate(x[1], degree, T.NEAREST)),
        "resize_rgb_bilinear": lambda x: (T.resize_shorter(x[0], size, T.BILINEAR), x[1]),
        "color_jitter": lambda x: (T.color_jitter(x[0], 0.4, 0.4, 0.4, random.Random(0)), x[1]),
        "resize_depth_bilinear": lambda x: (x[0], T.resize_shorter(x[1], size, T.BILINEAR)),
        "center_crop_normalize": lambda x: (
            T.rgb_to_normalized_array(T.center_crop(x[0], CROP_SIZE)),
            T.depth_to_array(T.center_crop(x[1], CROP_SIZE)) / scale),
        "sparse_sample": lambda x: T.sparse_sample(x[1], cfg.num_sample, random.Random(0)),
        "scanline_completion": lambda d: (simple_depth_completion(d[..., 0]), d)[1],
        "ip_basic_densify": lambda d: densify_depth_map(d[..., 0], (d[..., 0] > 0)),
    }
    out, x = {}, None
    for name, fn in stages.items():
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            y = fn(x)
            times.append(1e3 * (time.perf_counter() - t0))
        out[name], x = statistics.median(times), y
    return out


def cli_nyu_phase(port, torch, device, flags=None, tree=None, hw=NYU_HW, batch=12,
                  phase="cli-nyu") -> dict:
    """Phase 16: the CLI's default run, NLSPN on NYUv2, through main on an
    NYU tree (``write_nyu_tree``): one epoch of training (the train split
    in batches of ``batch``), a val and a test pass; --test_only on the
    checkpoint (a bit-equal reload); the val split under --ip_basic through
    main.test; the training loader alone at one thread and at a thread per
    core. ``flags`` default to ``NYU_FLAGS``; the CPU tests rehearse the
    phase at a small size. Every run must launch no kernel. Records are
    emitted under ``phase``. Returns the training run's launch counts."""
    import tempfile

    from diffusiondepth_tpu_torch import main as pmain
    from diffusiondepth_tpu_torch.data import DataLoader, get as get_data
    from diffusiondepth_tpu_torch.metrics import METRIC_NAMES

    cuda = device.type == "cuda"
    zero = {k: 0 for k in port.LAUNCHES}
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nyu_v2_")
    try:
        tree = tree or NYU_TREE
        split = write_nyu_tree(root, tree, hw)
        tree_s = time.perf_counter() - t_phase
        n_val = int(tree["train"] * NYU_VAL_RATIO)
        n_train = tree["train"] - n_val
        check([len(split[m]) for m in ("train", "val", "test")] == [n_train, n_val, tree["test"]],
              f"split sizes {[len(v) for v in split.values()]}")
        data_flags = ["--data_name", "NYU", "--dir_data", root,
                      "--split_json", os.path.join(root, "split.json"), *(flags or NYU_FLAGS)]
        train_flags = data_flags + ["--batch_size", str(batch), "--test_batch_size", str(batch),
                                    "--epochs", "1"]

        def run(argv, save_dir, fn):
            return run_main(port, torch, device, argv, os.path.join(root, save_dir), fn)

        # ---- train: one epoch, a val and a test pass
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        cfg, state, launches, train_s = run(train_flags, "train", pmain.train)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        check(launches == zero, f"{phase} train launched a kernel: {launches}")
        steps = n_train // batch
        check(state.step == steps, f"{phase} train: step {state.step} != {steps}")
        losses = check_train_logs(cfg)
        ckpt = os.path.join(cfg.save_dir, "model_00001.ckpt")
        check(os.path.exists(ckpt), "no model_00001.ckpt")
        tm = state.timings
        waits, step_s = tm["wait_s"], tm["step_s"]
        emit({"phase": phase, "run": "train", "flags": " ".join(train_flags[6:]),
              "seconds": train_s, "tree_seconds": tree_s, "frames": hw,
              "split": {k: len(v) for k, v in split.items()},
              "step_ms": [1e3 * x for x in step_s], "loader_wait_ms": [1e3 * x for x in waits],
              "loader_wait_share": [w / (w + t) for w, t in zip(waits, step_s)],
              "loader_batch_ms": [1e3 * x for x in tm["load_s"]],
              "loader_frames_per_s": batch * len(tm["load_s"]) / sum(tm["load_s"]),
              "loader_threads": cfg.num_threads,
              # the prefetch hides the loader behind the first (slow) step of
              # so short an epoch; a long one waits max(0, load - step) per step
              "steady_wait_share": max(0.0, 1.0 - statistics.mean(step_s[1:] or step_s)
                                       / statistics.mean(tm["load_s"])),
              "val_batch_ms": [1e3 * x for x in tm["val_s"]],
              "test_batch_ms": [1e3 * x for x in tm["test_s"]],
              "max_memory_allocated_gb": peak_gb, "loss_rows": losses, "launches": launches})

        # ---- the training loader alone, at one thread and a thread per core
        rates = {}
        for threads in (1, os.cpu_count()):
            loader = DataLoader(get_data(cfg)(cfg, "train"), batch, shuffle=True,
                                drop_last=True, num_threads=threads, prefetch=cfg.prefetch,
                                seed=cfg.seed)
            loader.set_epoch(1)
            t0 = time.perf_counter()
            frames = sum(b["rgb"].shape[0] for b in loader)
            rates[threads] = frames / (time.perf_counter() - t0)
        emit({"phase": phase, "run": "loader", "frames_per_s_by_threads": rates,
              "train_sample_stage_ms": nyu_sample_stages(os.path.join(
                  root, split["train"][0]["filename"]), cfg)})

        # ---- --test_only on the checkpoint: the reload is bit-equal
        test_flags = data_flags + ["--test_only", "--pretrain", ckpt,
                                   "--test_batch_size", str(batch)]
        tcfg, tstate, t_launches, test_s = run(test_flags, "test_only", pmain.test)
        check(t_launches == zero, f"{phase} test launched a kernel: {t_launches}")
        trained, reloaded = state.model.state_dict(), tstate.model.state_dict()
        check(trained.keys() == reloaded.keys() and all(
            torch.equal(trained[k], reloaded[k]) for k in trained),
            "the reloaded checkpoint differs from the trained state")
        metrics = logged(os.path.join(tcfg.save_dir, "metric_test.txt"), METRIC_NAMES)
        emit({"phase": phase, "run": "test_only", "seconds": test_s,
              "test_batch_ms": [1e3 * x for x in tstate.timings["test_s"]],
              "metric_rows": metrics, "reload_bit_equal": True, "launches": t_launches})
        del tstate, trained, reloaded

        # ---- the val split under --ip_basic, through main.test
        with open(os.path.join(root, "split_val.json"), "w") as f:
            json.dump({"test": split["val"]}, f)
        ip_flags = [x if x != os.path.join(root, "split.json")
                    else os.path.join(root, "split_val.json") for x in test_flags]
        icfg, istate, i_launches, ip_s = run(ip_flags + ["--ip_basic"], "val_ip_basic",
                                             pmain.test)
        check(i_launches == zero, f"{phase} --ip_basic launched a kernel: {i_launches}")
        metrics = logged(os.path.join(icfg.save_dir, "metric_test.txt"), METRIC_NAMES)
        emit({"phase": phase, "run": "val_ip_basic", "seconds": ip_s,
              "batch_ms": [1e3 * x for x in istate.timings["test_s"]],
              "metric_rows": metrics, "launches": i_launches})
        del state, istate
        if cuda:
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": phase, "seconds": time.perf_counter() - t_phase})
    return launches


# phase 21's flagship: the serve configuration as main's flags, seed 7240
FLAGSHIP_FLAGS = ["--model_name", "Diffusion_DCbase_", "--backbone_module", "swin",
                  "--backbone_name", "swin_large_naive_l4w722422k",
                  "--head_specify", "DDIMDepthEstimate_Swin_ADDHAHI",
                  "--inference_steps", str(STEPS), "--opt_level", "O1", "--seed", "7240"]
# the artifacts are exported with another seed's weights: serving them the
# converted checkpoint shows that the weights come from the checkpoint
EXPORT_SEED = 7241
# the kernels that are torch.library operators (ops/library.py)
OP_KERNELS = ("conv_link", "ddim_step", "window_attention", "window_attention_split")


def first_divergence(torch, run_a, run_b):
    """Where two runs of the same computation part: each runs under a
    dispatch mode that logs every ATen (or custom) operator with the shape
    and float64 sum of its first output; returns (index, operator, sums)
    of the first entry that differs, or None."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            first = out[0] if isinstance(out, (tuple, list)) and out else out
            if torch.is_tensor(first) and first.is_floating_point():
                self.rows.append((str(func), tuple(first.shape), first.double().sum().item()))
            else:
                self.rows.append((str(func), None, None))
            return out

    logs = []
    for run in (run_a, run_b):
        with torch.no_grad(), Log() as log:
            run()
        logs.append(log.rows)
    for i, (a, b_) in enumerate(zip(*logs)):
        if a != b_ and not (a[2] != a[2] and b_[2] != b_[2]):  # NaN sums agree
            return i, a, b_
    return None if len(logs[0]) == len(logs[1]) else (min(map(len, logs)), "length", None)


def _trace_and_dispatch(torch, module, batch, lat_shape, gen0, steps, n_blk, root):
    """Phase 21 (e) and (f): one request served from the plain artifact
    traced with torch.profiler and summarised by tools/analyze_trace.py
    (K1, K4 and K3 among the top kernels with their exact counts, and the
    wrappers' launch counts around the same request, printed beside them
    before either is checked: a miss in the trace alone is a lost event),
    then the operators' dispatch cost: 1000 K3 launches at a small shape
    through the operator and through its CUDA implementation."""
    from torch.profiler import ProfilerActivity, profile

    from diffusiondepth_tpu_torch.ops import fused_denoiser as fd
    from diffusiondepth_tpu_torch.ops import native
    from diffusiondepth_tpu_torch.tools import analyze_trace

    def sync():
        torch.cuda.synchronize()

    dev = torch.device("cuda")
    # ---- (e) one served request traced with torch.profiler
    trace = os.path.join(root, "trace.json")
    before = dict(native.LAUNCHES)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        module(batch, torch.randn(lat_shape, generator=gen0, device=dev))
        sync()
    launched = {k: native.LAUNCHES[k] - before[k] for k in native.LAUNCHES}
    prof.export_chrome_trace(trace)
    summary_text = analyze_trace.summarize(trace, top=40)
    print(summary_text, flush=True)
    total_us, dur, cnt = analyze_trace.breakdown(analyze_trace.load_events(trace), "kernel")
    top = [ln.split("  ", 2)[-1] for ln in summary_text.splitlines() if " n=" in ln]
    want = {"conv_link": 6 * steps, "window_attention": n_blk, "ddim_step": steps}
    counts = {k: sum(c for name_, c in cnt.items() if k in name_) for k in want}
    emit({"phase": "export-serve", "step": "trace-counts", "expected": want,
          "launches": {k: launched[k] for k in want}, "trace": counts,
          "other_launches": {k: v for k, v in launched.items() if k not in want and v}})
    check(launched == {k: want.get(k, 0) for k in launched},
          f"traced request: launches {launched}, expected {want}")
    for k in want:
        check(counts[k] == want[k], f"trace: {counts[k]} {k} kernels, expected {want[k]}, "
              f"{launched[k]} launched")
        check(any(k in t for t in top), f"trace: no {k} kernel among the top kernels")
    emit({"phase": "export-serve", "step": "trace", "device_ms": total_us / 1e3,
          "kernels": sum(cnt.values()), "op_kernel_counts": counts,
          "op_kernel_ms": {k: sum(v for n_, v in dur.items() if k in n_) / 1e3
                           for k in counts}})

    # ---- (f) the operators' dispatch cost: 1000 K3 launches at a small
    # shape through the operator and through its CUDA implementation
    g = torch.Generator(device=dev).manual_seed(1)
    u6 = torch.randn(1, 8, 8, 16, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(1, 8, 8, 16, generator=g, device=dev)
    a, o = torch.ones(1, 16, device=dev), torch.zeros(1, 16, device=dev)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)

    def per_call_us(fn, n=1000):
        for _ in range(20):
            fn(u6, a, o, x, sched)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(u6, a, o, x, sched)
        sync()
        return 1e6 * (time.perf_counter() - t0) / n

    with torch.no_grad():
        runs = {"op": [], "direct": []}
        for which in ("op", "direct", "direct", "op"):
            runs[which].append(per_call_us(fd.ddim_step if which == "op"
                                           else fd.ddim_step_cuda))
    op_us, direct_us = statistics.mean(runs["op"]), statistics.mean(runs["direct"])
    emit({"phase": "export-serve", "step": "dispatch", "kernel": "ddim_step",
          "shape": [1, 8, 8, 16], "calls": 1000, "op_us_per_call": runs["op"],
          "direct_us_per_call": runs["direct"], "op_overhead_us": op_us - direct_us,
          "op_calls_per_request": 7 * steps + n_blk,
          "overhead_ms_per_request": (op_us - direct_us) * (7 * steps + n_blk) / 1e3})


def _eval_parity_step(port, torch, dev, flags, ckpt, root, test_tree):
    """Phase 21 (g): eval_parity with 2 latent seeds over phase 11's
    KITTI-DC test frames (``test_tree``), batch 1, on the converted
    checkpoint; the statistics must be finite."""
    import contextlib
    import io

    from diffusiondepth_tpu_torch.config import parse_args
    from diffusiondepth_tpu_torch.tools import eval_parity

    test_tree = test_tree or KITTI_TREE["test"]
    kroot = os.path.join(root, "kitti")
    write_kitti_tree(kroot, {"test": test_tree})
    pcfg = parse_args(flags + ["--data_name", "KITTIDC", "--dir_data", kroot,
                               "--split_json", os.path.join(kroot, "split.json"),
                               "--test_batch_size", "1", "--pretrain", ckpt])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report = eval_parity.run_parity_eval(pcfg, n_seeds=2, device=dev)
    parity_s = time.perf_counter() - t0
    stats = {k: [v["mean"], v["std"]] for k, v in report["metrics"].items()}
    check(all(math.isfinite(x_) for v in stats.values() for x_ in v),
          f"eval_parity: non-finite statistics {stats}")
    check(report["protocol"]["num_samples"] == test_tree[0], f"eval_parity: {report['protocol']}")
    emit({"phase": "export-serve", "step": "eval_parity", "protocol": report["protocol"],
          "mean_std": stats, "seconds": parity_s})


def export_serve_phase(port, torch, device, flags=None, shape=(B, H_IMG, W_IMG), frames=11,
                       test_tree=None) -> dict:
    """Phase 21, the deployment path at the flagship's full width: a
    reference checkpoint converted, three artifacts exported and served,
    PNG directories served, a served request traced, the operators'
    dispatch cost and eval_parity's two seeds, on ``device``. ``flags``
    (main's model flags, ``FLAGSHIP_FLAGS`` by default), the serving
    ``shape`` (B, H, W), the PNG ``frames`` and the eval ``test_tree``
    let a CPU run rehearse the phase at a small size; the trace and the
    dispatch cost need the card. Returns the plain artifact's launches per
    request."""
    import contextlib
    import io
    import re
    import tempfile

    import numpy as np

    from diffusiondepth_tpu_torch.config import parse_args
    from diffusiondepth_tpu_torch.native.png import read_png, write_png
    from diffusiondepth_tpu_torch.tools import convert_checkpoint
    from diffusiondepth_tpu_torch.tools import export_model as em
    from diffusiondepth_tpu_torch.tools.serve import pred_to_png, serve_dir
    from diffusiondepth_tpu_torch.utils.checkpoint import load_checkpoint

    cuda = device.type == "cuda"
    dev = str(device)
    flags = flags or FLAGSHIP_FLAGS
    B, H_IMG, W_IMG = shape

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="export_serve_")
    try:
        # ---- (a) a reference-layout .pt of the seed-7240 weights -> a port checkpoint
        cfg = parse_args(flags)
        steps = cfg.inference_steps
        ref = port.build_model(cfg, device=dev)
        n_blk = sum(len(st.blocks) for st in ref.depth_backbone.stages)
        sd = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
        del ref
        ref_pt = os.path.join(root, "model_00000.pt")
        torch.save({"net": sd}, ref_pt)
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = convert_checkpoint.main(["--torch", ref_pt, "--out_dir",
                                          os.path.join(root, "converted"), "--device", dev,
                                          *flags])
        convert_s = time.perf_counter() - t0
        m = re.search(r"\((\d+)/(\d+) tensors replaced\)", text.getvalue())
        check(rc == 0 and m is not None, f"convert_checkpoint: rc {rc}, {text.getvalue()!r}")
        replaced, total = int(m.group(1)), int(m.group(2))
        check(replaced == total == len(sd), f"convert_checkpoint replaced {replaced}/{total}, "
              f"the reference holds {len(sd)}")
        ckpt = os.path.join(root, "converted", "model_00000.ckpt")
        conv_sd = load_checkpoint(ckpt)["state_dict"]
        check(all(torch.equal(conv_sd[k], v) for k, v in sd.items()),
              "the converted checkpoint differs from the reference's tensors")
        emit({"phase": "export-serve", "step": "convert", "replaced": replaced, "total": total,
              "reference_bytes": os.path.getsize(ref_pt), "seconds": convert_s})
        del sd

        # ---- (b) three artifacts at 8 x 352x1216, 20 steps, bf16, exported
        # with the seed-7241 weights
        variants = {"plain": (False, False), "tta": (False, True), "use_pallas": (True, False)}
        spec = em.serving_batch_spec(B, H_IMG, W_IMG)
        artifacts = {}
        for name, (pallas, tta) in variants.items():
            model = port.build_model(dataclasses.replace(cfg, seed=EXPORT_SEED, use_pallas=pallas),
                                     device=dev)
            t0 = time.perf_counter()
            ep = em.export_predict(model, spec, tta_flip=tta)
            export_s = time.perf_counter() - t0
            path = os.path.join(root, f"{name}.pt2")
            t0 = time.perf_counter()
            em.save_exported(ep, path)
            save_s = time.perf_counter() - t0
            calls = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
            ops = {k: calls.count(f"diffusiondepth.{k}.default") for k in OP_KERNELS}
            emit({"phase": "export-serve", "step": "export", "artifact": name,
                  "export_s": export_s, "save_s": save_s, "bytes": os.path.getsize(path),
                  "graph_nodes": len(calls), "operator_nodes": ops})
            artifacts[name] = path
            del model, ep
            sync()

        # ---- (c) serve the loaded artifacts the converted checkpoint: one
        # warm-up and 3 timed requests each, against the eager make_eval_step
        # on the same weights, batches and starting latents
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        def request():
            depth = torch.rand(B, H_IMG, W_IMG, 1, generator=gen, device=dev) * 79 + 1
            valid = torch.rand(B, H_IMG, W_IMG, 1, generator=gen, device=dev) < 0.3
            gt = depth * valid
            return {"rgb": torch.randn(B, H_IMG, W_IMG, 3, generator=gen, device=dev),
                    "dep": gt, "gt": gt, "depth_map": gt, "depth_mask": valid.float()}

        batches = [request() for _ in range(4)]
        per_request, keep = {}, {}
        for name, (pallas, tta) in variants.items():
            t0 = time.perf_counter()
            module = em.load_exported(artifacts[name]).module()
            module.load_state_dict(conv_sd)
            sync()
            load_s = time.perf_counter() - t0
            eager = port.build_model(dataclasses.replace(cfg, use_pallas=pallas), device=dev)
            eager.load_state_dict(conv_sd)
            step = port.make_eval_step(eager, tta_flip=tta)
            lat_shape = em.latent_shape(eager, B, H_IMG, W_IMG, tta)
            lats = [torch.randn(lat_shape, generator=gen, device=dev) for _ in batches]
            with torch.no_grad():
                module(batches[0], lats[0])
            step(batches[0], init_latent=lats[0])
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            port.reset_launch_counts()
            art_ms, preds = [], []
            with torch.no_grad():
                for b_, l_ in zip(batches[1:], lats[1:]):
                    t0 = time.perf_counter()
                    preds.append(module(b_, l_))
                    sync()
                    art_ms.append(1e3 * (time.perf_counter() - t0))
            launches = dict(port.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
            eager_ms, equal = [], []
            for b_, l_, p in zip(batches[1:], lats[1:], preds):
                t0 = time.perf_counter()
                e, _, _ = step(b_, init_latent=l_)
                sync()
                eager_ms.append(1e3 * (time.perf_counter() - t0))
                equal.append(torch.equal(p, e))
                check(tuple(p.shape) == (B, H_IMG, W_IMG, 1) and bool(torch.isfinite(p).all()),
                      f"export-serve {name}: pred {tuple(p.shape)} or not finite")
            if not all(equal):
                with torch.no_grad():
                    part = first_divergence(
                        torch, lambda: module(batches[1], lats[1]),
                        lambda: em.make_predict_fn(eager, tta)(batches[1], lats[1]))
                check(False, f"export-serve {name}: pred differs from eager ({equal}); "
                      f"first divergence (index, artifact, eager): {part}")
            expect = {k: 0 for k in port.LAUNCHES}
            if cuda:
                expect.update({"conv_link": 6 * steps, "ddim_step": steps,
                               ("window_attention_split" if pallas else "window_attention"): n_blk})
            per_request[name] = {k: v // 3 for k, v in launches.items()}
            check(launches == {k: 3 * v for k, v in expect.items()},
                  f"export-serve {name}: launches {launches} != 3 x {expect}")
            emit({"phase": "export-serve", "step": "serve", "artifact": name,
                  "batch": 2 * B if tta else B, "image": [H_IMG, W_IMG], "steps": steps,
                  "load_s": load_s, "latency_ms": art_ms,
                  "frames_per_s": B * 3 / (sum(art_ms) / 1e3), "eager_latency_ms": eager_ms,
                  "eager_frames_per_s": B * 3 / (sum(eager_ms) / 1e3),
                  "max_memory_allocated_gb": peak_gb, "bit_equal_to_eager": equal,
                  "launches_per_request": per_request[name], "expected_per_request": expect})
            if name == "plain":
                keep = {"module": module, "eager": eager}
            del module, eager, step, preds
            sync()

        # ---- (d) serve_dir over 11 PNGs: one batch of 8 and a ragged 3
        rng = np.random.RandomState(0)
        dirs = {k: os.path.join(root, k) for k in ("rgb", "dep", "out")}
        for d in dirs.values():
            os.makedirs(d)
        names = [f"{i:010d}.png" for i in range(frames)]
        for n in names:
            write_png(os.path.join(dirs["rgb"], n),
                      (rng.rand(H_IMG, W_IMG, 3) * 255).astype(np.uint8))
            dep = (rng.rand(H_IMG, W_IMG) * 80 * 256) * (rng.rand(H_IMG, W_IMG) < 0.05)
            write_png(os.path.join(dirs["dep"], n), dep.astype(np.uint16))
        t0 = time.perf_counter()
        written = serve_dir(artifacts["plain"], ckpt, dirs["rgb"], dirs["out"],
                            dep_dir=dirs["dep"], seed=0, device=dev)
        serve_dir_s = time.perf_counter() - t0
        check(sorted(os.path.basename(p) for p in written) == names,
              f"serve_dir wrote {len(written)} files")
        gen0 = torch.Generator(device=dev).manual_seed(0)
        predict = em.make_predict_fn(keep["eager"])
        lat_shape = em.latent_shape(keep["eager"], B, H_IMG, W_IMG)
        wrong = []
        for i0 in range(0, len(names), B):
            chunk = names[i0:i0 + B]
            padded = chunk + [chunk[-1]] * (B - len(chunk))
            rgb = np.stack([read_png(os.path.join(dirs["rgb"], n)) for n in padded])
            dep = np.stack([read_png(os.path.join(dirs["dep"], n)) for n in padded])
            dep_t = torch.from_numpy(dep.astype(np.float32)[..., None] / 256.0).to(dev)
            batch = {"rgb": torch.from_numpy(rgb.astype(np.float32) / 255.0).to(dev),
                     "dep": dep_t, "gt": dep_t, "depth_map": dep_t,
                     "depth_mask": (dep_t > 0).float()}
            with torch.no_grad():
                pred = predict(batch, torch.randn(lat_shape, generator=gen0, device=dev))
            pred = pred.float().cpu().numpy()
            for j, n in enumerate(chunk):
                if not np.array_equal(read_png(os.path.join(dirs["out"], n)),
                                      pred_to_png(pred[j])):
                    wrong.append(n)
        check(not wrong, f"serve_dir outputs differ from the eager predictions: {wrong}")
        emit({"phase": "export-serve", "step": "serve_dir", "frames": len(names), "batch": B,
              "seconds": serve_dir_s, "outputs_equal_eager": len(names) - len(wrong)})

        if cuda:  # the trace and the dispatch cost read the card's kernels
            _trace_and_dispatch(torch, keep["module"], batches[1], lat_shape, gen0, steps,
                                n_blk, root)
        del keep
        sync()
        _eval_parity_step(port, torch, dev, flags, ckpt, root, test_tree)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "export-serve", "seconds": time.perf_counter() - t_phase})
    return per_request["plain"]


# ---- phase 22: data parallelism (parallel/). Two gloo ranks share the one
# card (NCCL refuses two ranks on one device): they measure correctness and
# the ranks' own cost, not NVLink's all-reduce, which needs several cards
DDP_RANKS = 2
DDP_SEED = 5  # the generator of the model's draws, alike on every rank
# the flagship training recipe of phase 6 and the serve configuration of
# phase 5, weights from seed 7240
DDP_TRAIN = dict(model_name="Diffusion_DCbase_", backbone_module="swin",
                 backbone_name="swin_large_naive_l4w722422k",
                 head_specify="DDIMDepthEstimate_Swin_ADDHAHI", inference_steps=STEPS,
                 opt_level="O1", batch_size=B_T, accum_steps=ACCUM, patch_height=H_T,
                 patch_width=W_T, max_depth=88.0, seed=7240)
DDP_SERVE = dict(model_name="Diffusion_DCbase_", backbone_module="swin",
                 backbone_name="swin_large_naive_l4w722422k",
                 head_specify="DDIMDepthEstimate_Swin_ADDHAHI", inference_steps=STEPS,
                 opt_level="O1", seed=7240)
# phase 12's micro model, f32: resnet18, prop_time 3, radius 6, 4 x 32x48
DDP_MICRO = dict(model_name="NLSPN", network="resnet18", prop_time=3, prop_stencil_radius=6,
                 opt_level="O0", loss="1.0*L1+1.0*L2", max_depth=90.0, seed=11, batch_size=4)
# bf16 flagship step, two ranks of 2 rows per micro-batch against one process
# of 4: BatchNorm sums its moments in another order, and cuBLAS and cuDNN
# pick other algorithms at half the rows, each rounding to bf16 (2^-8) at
# other points; the differences pass through 20 sampler steps and their
# backward. The loss and its row are held to 1e-2 relative, the gradient's
# relative L2 distance to 5e-2, the running statistics to 1e-2 of each
# buffer's largest value
DDP_BF16_LOSS_TOL, DDP_BF16_GRAD_TOL, DDP_BF16_STATS_TOL = 1e-2, 5e-2, 1e-2
# f32 with TF32 and cuDNN off, two ranks against one process: the sums'
# order only. The CPU tests' tolerances (test_torch_parallel_train): loss
# and rows 1e-5, the metric row 1e-4, each gradient leaf 1e-3 of its
# largest value (the sampler carries a summation-order difference to
# 1.6e-4 of the denoiser's first layer on the CPU)
DDP_F32_TOL, DDP_F32_METRIC_TOL, DDP_F32_GRAD_TOL = 1e-5, 1e-4, 1e-3


def _ddp_flat_grads(torch, model):
    return torch.cat([p.grad.float().reshape(-1) for p in model.parameters()
                      if p.grad is not None])


def _ddp_max_rel(torch, a, b):
    """The largest |a - b| over the largest |b|, of two dicts of tensors."""
    return max(((a[k].double() - b[k].double()).abs().max()
                / b[k].double().abs().max().clamp_min(1e-30)).item() for k in b)


def ddp_rank() -> dict:
    """One rank of phase 22 (run by ``parallel.launch`` on every rank):
    (a) the flagship training step, (b) a served request, (c) the f32
    micro model, each against one process on rank 0. Returns rank 0's
    record with every rank's numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import diffusiondepth_tpu_torch as port
    from diffusiondepth_tpu_torch.metrics import evaluate_depth_metrics
    from diffusiondepth_tpu_torch.parallel import create_mesh, shard_batch
    from diffusiondepth_tpu_torch.parallel.mesh import broadcast_module
    from diffusiondepth_tpu_torch.training.optim import make_lr_schedule

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(f"data:{DDP_RANKS}")
    dev, rank = mesh.device, mesh.rank
    rec = {"rank": rank, "backend": mesh.backend, "device": str(dev)}

    def sync():
        torch.cuda.synchronize(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- (a) the flagship training step
    tcfg = port.Config(**DDP_TRAIN, mesh_shape=f"data:{DDP_RANKS}").finalize()
    one_cfg = dataclasses.replace(tcfg, mesh_shape=None)
    model = port.build_model(tcfg, device=dev)
    broadcast_module(model, mesh)
    lc = port.LossComputer(tcfg)
    dgen = gen(1)  # the data: the same host batches on every rank

    def train_batch():
        gt = (torch.rand(B_T, H_T, W_T, 1, generator=dgen, device=dev) * 80).clamp(0, 88)
        return {"rgb": torch.randn(B_T, H_T, W_T, 3, generator=dgen, device=dev), "gt": gt}

    batches = [train_batch() for _ in range(3)]
    running = {n for n, _ in model.named_buffers() if "running" in n}
    if rank == 0:  # one process on the whole host batch, the same weights and seed
        ref = port.build_model(one_cfg, device=dev)
        ref.load_state_dict(model.state_dict())
        ref_step = port.make_train_step(ref, lc, port.make_optimizer(one_cfg, 100, ref),
                                        accum_steps=ACCUM)
        r_loss, r_row, _ = ref_step(batches[0], gen(DDP_SEED))
        r_grad = _ddp_flat_grads(torch, ref)
        r_stats = {n: b.clone() for n, b in ref.named_buffers() if n in running}
        del ref, ref_step
        torch.cuda.empty_cache()
    dist.barrier()
    step = port.make_train_step(model, lc, port.make_optimizer(tcfg, 100, model),
                                accum_steps=ACCUM, mesh=mesh)
    tgen = gen(DDP_SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, comm, launches, rows = [], [], [], []
    for i, batch in enumerate(batches):
        mine = shard_batch(batch, mesh, ACCUM)
        sync()
        dist.barrier()
        port.reset_launch_counts()
        t0 = time.perf_counter()
        loss, row, met = step(mine, tgen)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(dict(port.LAUNCHES))
        comm.append(dict(step.comm))
        rows.append(row[0].tolist())
        if i == 0:  # the step from the reference's weights
            grad = _ddp_flat_grads(torch, model)
            stats = {n: b.clone() for n, b in model.named_buffers() if n in running}
            if rank == 0:
                rec["loss"] = [loss.item(), r_loss.item()]
                rec["loss_rel_err"] = abs(loss.item() - r_loss.item()) / abs(r_loss.item())
                rec["row_rel_err"] = ((row - r_row).abs().max() / r_row.abs().max()).item()
                rec["grad_rel_l2"] = ((grad - r_grad).norm() / r_grad.norm()).item()
                rec["grad_elems"] = grad.numel()
                rec["stats_rel_err"] = _ddp_max_rel(torch, stats, r_stats)
                del r_grad
            del grad, stats
    rec.update(step_ms=step_ms, comm=comm, train_launches=launches, loss_rows=rows,
               train_finite=bool(torch.isfinite(row).all() and torch.isfinite(met).all()),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    # the ranks' parameters and buffers after the 3 updates, bit for bit
    mismatched = 0
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            mine_t = t.detach().cpu()
            theirs = mine_t.clone()
            dist.broadcast(theirs, 0)
            mismatched += int(not torch.equal(mine_t, theirs))
    rec["tensors_unlike_rank0"] = mismatched
    del model, step, batches, mine, loss, row, met
    torch.cuda.empty_cache()

    # ---- (b) a served request, split over the ranks
    scfg = port.Config(**DDP_SERVE, mesh_shape=f"data:{DDP_RANKS}").finalize()
    smodel = port.build_model(scfg, device=dev)
    broadcast_module(smodel, mesh)
    rgen = gen(scfg.seed)
    rgb = torch.randn(B, H_IMG, W_IMG, 3, generator=rgen, device=dev)
    depth = torch.rand(B, H_IMG, W_IMG, 1, generator=rgen, device=dev) * 79 + 1
    req = {"rgb": rgb, "gt": depth * (torch.rand(B, H_IMG, W_IMG, 1, generator=rgen,
                                                  device=dev) < 0.3)}
    estep = port.make_eval_step(smodel, mesh=mesh, gather=True)
    estep(shard_batch(req, mesh), generator=gen(DDP_SEED))  # warm-up
    sync()
    dist.barrier()
    port.reset_launch_counts()
    t0 = time.perf_counter()
    pred, met, _ = estep(shard_batch(req, mesh), generator=gen(DDP_SEED))
    sync()
    rec["eval_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["eval_launches"] = dict(port.LAUNCHES)
    rec["eval_metric"] = met[0].tolist()
    rec["metric_vs_gathered"] = ((met - evaluate_depth_metrics(req, {"pred": pred})).abs().max()
                                 / met.abs().max()).item()
    one = port.make_eval_step(smodel)
    # the starting latent of the whole batch, as each rank draws it
    lat = torch.randn((B, H_IMG // 2, W_IMG // 2, 16), generator=gen(DDP_SEED), device=dev)
    per = B // DDP_RANKS
    rows_ = slice(rank * per, (rank + 1) * per)
    p4, _, _ = one({k: v[rows_] for k, v in req.items()}, init_latent=lat[rows_])
    rec["pred_rows_equal_one_process"] = bool(torch.equal(p4, pred[rows_]))
    if rank == 0:
        p8, m8, _ = one(req, generator=gen(DDP_SEED))
        rec["pred_rel_err_batch8"] = ((pred - p8).abs().max() / p8.abs().max()).item()
        rec["metric_rel_err_batch8"] = ((met - m8).abs().max() / m8.abs().max()).item()
        rec["pred_shape"] = list(pred.shape)
        rec["pred_finite"] = bool(torch.isfinite(pred).all())
    del smodel, estep, one, pred, req
    torch.cuda.empty_cache()

    # ---- (c) micro models in f32, TF32 and cuDNN off: two ranks against one
    # process (loss, rows, gradient, the parameters after Adam's first
    # update). cuDNN is off because it picks its algorithms by the batch's
    # rows (2 on a rank, 4 in one process), whose f32 roundings parted by 3%
    # of an NLSPN micro gradient leaf (NVIDIA H100 80GB HBM3, 700 W);
    # PyTorch's own convolutions leave the ranks' reductions as the
    # difference. The flagship head on swin_micro is held to the CPU tests'
    # tolerances; phase 12's NLSPN micro model is reported beside one
    # process's own repeat
    def micro_batch(with_dep):
        rng = np.random.RandomState(1)
        h, w = (32, 48) if with_dep else (64, 96)
        gt = (rng.rand(4, h, w, 1) * (80 if with_dep else 8) + 1).astype(np.float32)
        gt[:2, :h // 2] = 0.0  # rank 0's rows mostly invalid
        out = {"rgb": rng.randn(4, h, w, 3).astype(np.float32), "gt": gt}
        if with_dep:
            out["dep"] = gt * (rng.rand(4, h, w, 1) > 0.9)
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    def micro_step(cfg_, batch, step_mesh, nlspn):
        m = port.build_model(cfg_, device=dev)
        if nlspn:
            randomize_offset_conv(torch, m, 11, 2.0)
        broadcast_module(m, step_mesh)
        mstep = port.make_train_step(m, port.LossComputer(cfg_),
                                     port.make_optimizer(cfg_, 10, m),
                                     accum_steps=cfg_.accum_steps, mesh=step_mesh)
        before = {n: p.detach().clone() for n, p in m.named_parameters()}
        loss, row, met = mstep(batch, gen(DDP_SEED))
        return {"loss": loss, "row": row, "metric": met,
                "grads": {n: p.grad.clone() for n, p in m.named_parameters()
                          if p.grad is not None},
                "delta": {n: p.detach() - before[n] for n, p in m.named_parameters()}}

    def leaf_err(a, b):
        """The worst leaf's max |a - b| over its largest |b| (floored at
        1e-4 of the largest leaf, as the tests' close_leaves)."""
        gmax = max(g.abs().max().item() for g in b.values())
        errs = {n: ((a[n] - g).abs().max() / max(g.abs().max().item(), 1e-4 * gmax)).item()
                for n, g in b.items()}
        worst = max(errs, key=errs.get)
        return worst, errs[worst]

    rec["micro"] = {}
    for name, kw, nlspn in (
            ("swin_micro", dict(model_name="Diffusion_DCbase_", backbone_module="swin",
                                backbone_name="swin_micro",
                                head_specify="DDIMDepthEstimate_Swin_ADDHAHI",
                                head_in_channels="32,64,128,256", inference_steps=2,
                                batch_size=4, accum_steps=2, max_depth=88.0, seed=11), False),
            ("nlspn_micro", DDP_MICRO, True)):
        mcfg = port.Config(**kw, mesh_shape=f"data:{DDP_RANKS}").finalize()
        one_cfg = dataclasses.replace(mcfg, mesh_shape=None)
        mb = micro_batch(nlspn)
        with torch.backends.cudnn.flags(enabled=False):
            ranks = micro_step(mcfg, shard_batch(mb, mesh, mcfg.accum_steps), mesh, nlspn)
            if rank == 0:
                one = micro_step(one_cfg, mb, None, nlspn)
                again = micro_step(one_cfg, mb, None, nlspn) if nlspn else None
        if rank == 0:
            worst, err = leaf_err(ranks["grads"], one["grads"])
            lr0 = make_lr_schedule(one_cfg, 10)(0)
            r = {"loss": [ranks["loss"].item(), one["loss"].item()],
                 "loss_rel_err": abs(ranks["loss"].item() - one["loss"].item())
                 / abs(one["loss"].item()),
                 "row_rel_err": ((ranks["row"] - one["row"]).abs().max()
                                 / one["row"].abs().max()).item(),
                 "metric_rel_err": ((ranks["metric"] - one["metric"]).abs().max()
                                    / one["metric"].abs().max()).item(),
                 "worst_leaf": worst, "worst_grad_err": err,
                 "delta_over_lr": max((ranks["delta"][n] - d).abs().max().item()
                                      for n, d in one["delta"].items()) / lr0}
            if again is not None:  # one process against itself
                r["repeat_worst_leaf"], r["repeat_grad_err"] = leaf_err(again["grads"],
                                                                        one["grads"])
            rec["micro"][name] = r
        del ranks
        torch.cuda.empty_cache()
    gathered = [None] * DDP_RANKS
    dist.all_gather_object(gathered, rec)
    return {"ranks": gathered}


def ddp_phase(port, torch, dev, t_expect, s_expect) -> dict:
    """Phase 22: the ranks of ``ddp_rank`` through the port's launcher, two
    on the one card (gloo), held to their checks; then main's cli run at
    ``--mesh_shape data:1`` in a one-rank NCCL group against the run with
    no mesh, logs and checkpoint bit for bit. Returns rank 0's launch
    counts of one training step and one served request."""
    import tempfile

    from diffusiondepth_tpu_torch import main as pmain
    from diffusiondepth_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = launch(ddp_rank, [dev] * DDP_RANKS, 29511)
    r0 = out["ranks"][0]
    for r in out["ranks"]:
        for i, got in enumerate(r["train_launches"]):
            check(got == t_expect, f"ddp rank {r['rank']} step {i} launches {got} != {t_expect}")
        check(r["eval_launches"] == s_expect,
              f"ddp rank {r['rank']} request launches {r['eval_launches']} != {s_expect}")
        check(r["tensors_unlike_rank0"] == 0,
              f"ddp rank {r['rank']}: {r['tensors_unlike_rank0']} tensors differ from rank 0's")
        check(r["pred_rows_equal_one_process"],
              f"ddp rank {r['rank']}: its rows of pred differ from one process on them")
        check(r["metric_vs_gathered"] <= 1e-6, f"ddp metric row: {r['metric_vs_gathered']}")
        check(r["train_finite"], f"ddp rank {r['rank']}: non-finite loss or metric row")
        check(r["comm"][0]["bytes"] == 4 * r0["grad_elems"],
              f"ddp all-reduce bytes {r['comm'][0]['bytes']} != 4 x {r0['grad_elems']}")
    check(r0["loss_rel_err"] <= DDP_BF16_LOSS_TOL and r0["row_rel_err"] <= DDP_BF16_LOSS_TOL,
          f"ddp loss {r0['loss']} rel err {r0['loss_rel_err']}, row {r0['row_rel_err']}")
    check(r0["grad_rel_l2"] <= DDP_BF16_GRAD_TOL, f"ddp gradient rel L2 {r0['grad_rel_l2']}")
    check(r0["stats_rel_err"] <= DDP_BF16_STATS_TOL,
          f"ddp BatchNorm statistics rel err {r0['stats_rel_err']}")
    check(r0["pred_finite"] and r0["pred_shape"] == [B, H_IMG, W_IMG, 1],
          f"ddp pred {r0['pred_shape']}")
    mi = r0["micro"]["swin_micro"]
    check(mi["loss_rel_err"] <= DDP_F32_TOL and mi["row_rel_err"] <= DDP_F32_TOL
          and mi["metric_rel_err"] <= DDP_F32_METRIC_TOL
          and mi["worst_grad_err"] <= DDP_F32_GRAD_TOL and mi["delta_over_lr"] <= 2.0,
          f"ddp f32 micro model: {mi}")
    emit({"phase": "ddp", "what": f"{DDP_RANKS} gloo ranks on one card through parallel.launch",
          "train": {"config": "phase 6's recipe, global batch 8 = 2 x (2 ranks x 2 rows), "
                    "352x906, bf16, drop-path 0.1, seed 7240",
                    "loss": r0["loss"], "loss_rel_err": r0["loss_rel_err"],
                    "row_rel_err": r0["row_rel_err"], "grad_rel_l2": r0["grad_rel_l2"],
                    "stats_rel_err": r0["stats_rel_err"],
                    "tols": [DDP_BF16_LOSS_TOL, DDP_BF16_GRAD_TOL, DDP_BF16_STATS_TOL],
                    "step_ms_by_rank": [r["step_ms"] for r in out["ranks"]],
                    "allreduce_by_rank": [r["comm"] for r in out["ranks"]],
                    "grad_bytes": 4 * r0["grad_elems"],
                    "peak_gb_by_rank": [r["peak_gb"] for r in out["ranks"]],
                    "loss_rows": r0["loss_rows"], "launches_per_step": r0["train_launches"][-1]},
          "serve": {"batch": f"{B} = {DDP_RANKS} x {B // DDP_RANKS}",
                    "eval_ms_by_rank": [r["eval_ms"] for r in out["ranks"]],
                    "metric_row": r0["eval_metric"],
                    "metric_vs_gathered": [r["metric_vs_gathered"] for r in out["ranks"]],
                    "pred_rows_equal_one_process": True,
                    "pred_rel_err_batch8": r0["pred_rel_err_batch8"],
                    "metric_rel_err_batch8": r0["metric_rel_err_batch8"],
                    "launches_per_request": r0["eval_launches"]},
          "micro_f32": r0["micro"], "seconds": time.perf_counter() - t_phase})

    # ---- (c) main at --mesh_shape data:1: a one-rank NCCL group
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kitti_ddp_")
    try:
        write_kitti_tree(root, {"train": (8, 375, 1242), "val": (8, 375, 1242),
                                "test": (8, 352, 1216)})
        flags = ["--data_name", "KITTIDC", "--dir_data", root,
                 "--split_json", os.path.join(root, "split.json"), *CLI_FLAGS,
                 "--batch_size", "8", "--accum_steps", "2", "--test_batch_size", "8",
                 "--epochs", "1", "--save_full", "--port", "29512"]
        runs = {}
        for name, extra in (("none", []), ("data:1", ["--mesh_shape", "data:1"])):
            _, state, launches, secs = run_main(port, torch, dev, flags + extra,
                                                os.path.join(root, name.replace(":", "")),
                                                pmain.train)
            runs[name] = (state.model.state_dict(), launches, secs)
        files = ("loss_train.txt", "metric_train.txt", "metric_val.txt", "metric_test.txt",
                 "scalars_train.jsonl", "scalars_val.jsonl", "scalars_test.jsonl")
        same_logs = all(open(os.path.join(root, "none", f)).read()
                        == open(os.path.join(root, "data1", f)).read() for f in files)
        ck = [torch.load(os.path.join(root, d, "model_00001.ckpt"), weights_only=True)
              for d in ("none", "data1")]
        same_ckpt = (ck[0]["state_dict"].keys() == ck[1]["state_dict"].keys() and all(
            torch.equal(ck[0]["state_dict"][k], ck[1]["state_dict"][k])
            for k in ck[0]["state_dict"]))
        check(runs["none"][1] == runs["data:1"][1],
              f"ddp cli launches {runs['data:1'][1]} != {runs['none'][1]}")
        check(same_logs and same_ckpt,
              f"ddp cli data:1 against no mesh: logs equal {same_logs}, checkpoint {same_ckpt}")
        emit({"phase": "ddp", "run": "cli --mesh_shape data:1 (one-rank NCCL group)",
              "seconds": {k: v[2] for k, v in runs.items()}, "logs_bit_equal": same_logs,
              "checkpoint_bit_equal": same_ckpt, "launches": runs["data:1"][1]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "ddp", "seconds": time.perf_counter() - t_phase,
          "cli_seconds": time.perf_counter() - t0})
    return {k: r0["train_launches"][-1][k] + r0["eval_launches"][k] for k in t_expect}


# ---- phase 23: tensor parallelism (parallel/tensor.py). Gloo ranks share
# the one card as in phase 22: they show correctness and the ranks' own
# cost, not NVLink's collectives. JAX's rule at its default min_size
TP_MIN_SIZE = 2**16
# Adam's first step against one process's, relative L2 per leaf weighted by
# |gradient| (tp_step_err): an update left out reads 1, one of the wrong
# sign 2
TP_ADAM_STEP_TOL = 0.25
# a request's condition features and first DDIM step against one process,
# relative L2: bf16 products on other column counts round otherwise; a
# wrong gather or shard reads ~1.4
TP_SERVE_TOL = 5e-2
TP_PORTS = {"model:2": 29513, "data:2,model:2": 29514}


def tp_step_err(after, one_after, before, one_grad) -> dict:
    """name -> (relative L2 of a leaf's step against one process's,
    weighted by one process's |gradient|; the same unweighted) for every
    leaf but the 1-D ones whose gradient is float noise (a bias that
    BatchNorm follows: below 1e-4 of the largest). Adam's first step is
    about lr times the gradient's sign, so elements whose gradient is
    noise around zero take either sign; the weights keep them from
    deciding the check. A step left out reads 1, one of the wrong sign 2."""
    floor = 1e-4 * max(g.abs().max().item() for g in one_grad.values())
    out = {}
    for n, p in one_after.items():
        w = one_grad.get(n)
        w = None if w is None else w.abs()
        if p.ndim < 2 and w is not None and w.max().item() < floor:
            continue
        one = (p - before[n]).float()
        diff = (after[n] - before[n]).float() - one
        errs = []
        for wt in ((1.0 if w is None else w), 1.0):
            den = (one * wt).norm().item()
            num = (diff * wt).norm().item()
            errs.append(num / den if den else (0.0 if num == 0 else math.inf))
        out[n] = tuple(errs)
    return out


@contextlib.contextmanager
def tp_first_step(model):
    """Record a request's condition features (``fpn_condition``'s output)
    and its first DDIM step's change of the latent (``ddim_step``'s output
    less its input) in the dict it yields, in f32. The wrapped functions
    call the originals, whose launch counts stay as they were."""
    from diffusiondepth_tpu_torch.models.heads import ddim_head

    head, seen = model.depth_head, {}
    fpn_condition, ddim_step = head.fpn_condition, ddim_head.ddim_step

    def cond(fp):
        out = fpn_condition(fp)
        seen.setdefault("cond", out.detach().float().clone())
        return out

    def step(u6, a3, b3, x, sched):
        out = ddim_step(u6, a3, b3, x, sched)
        seen.setdefault("step1", (out - x).detach().float())
        return out

    head.fpn_condition, ddim_head.ddim_step = cond, step
    try:
        yield seen
    finally:
        del head.fpn_condition
        ddim_head.ddim_step = ddim_step


def tp_rank(spec: str, steps: int, serve: bool) -> dict:
    """One rank of phase 23 (run by ``parallel.launch`` on every rank of
    ``spec``): the flagship training recipe with the state cut by
    ``state_sharding`` (``steps`` steps, the first against one process on
    rank 0) and, with ``serve``, a served bs8 request against one process.
    Returns rank 0's record with every rank's numbers."""
    import torch
    import torch.distributed as dist

    import diffusiondepth_tpu_torch as port
    from diffusiondepth_tpu_torch.metrics import evaluate_depth_metrics
    from diffusiondepth_tpu_torch.parallel import (
        create_mesh, gather_state_dict, shard_batch, shard_state, state_sharding,
    )
    from diffusiondepth_tpu_torch.parallel import tensor as tp
    from diffusiondepth_tpu_torch.parallel.mesh import broadcast_module

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(spec)
    dev, rank = mesh.device, mesh.rank
    rec = {"rank": rank, "data_index": mesh.data_index, "model_index": mesh.model_index}

    def sync():
        torch.cuda.synchronize(dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def comm_now():
        return {k: list(v) for k, v in tp.COMM.items()}

    # ---- (a) the flagship training recipe
    tcfg = port.Config(**DDP_TRAIN, mesh_shape=spec).finalize()
    one_cfg = dataclasses.replace(tcfg, mesh_shape=None)
    model = port.build_model(tcfg, device=dev)
    broadcast_module(model, mesh)
    lc = port.LossComputer(tcfg)
    dgen = gen(1)  # the data: the same host batches on every rank

    def train_batch():
        gt = (torch.rand(B_T, H_T, W_T, 1, generator=dgen, device=dev) * 80).clamp(0, 88)
        return {"rgb": torch.randn(B_T, H_T, W_T, 3, generator=dgen, device=dev), "gt": gt}

    batches = [train_batch() for _ in range(steps)]
    running = {n for n, _ in model.named_buffers() if "running" in n}
    if rank == 0:  # one process on the whole host batch, the same weights and seed
        ref = port.build_model(one_cfg, device=dev)
        ref.load_state_dict(model.state_dict())
        r_before = {n: p.detach().clone() for n, p in ref.named_parameters()}
        ref_step = port.make_train_step(ref, lc, port.make_optimizer(one_cfg, 100, ref),
                                        accum_steps=ACCUM)
        r_loss, r_row, _ = ref_step(batches[0], gen(DDP_SEED))
        r_grad = _ddp_flat_grads(torch, ref)
        r_g = {n: p.grad.detach().float() for n, p in ref.named_parameters()
               if p.grad is not None}
        r_stats = {n: b.clone() for n, b in ref.named_buffers() if n in running}
        r_params = {n: p.detach().clone() for n, p in ref.named_parameters()}
        del ref, ref_step
        torch.cuda.empty_cache()
    dist.barrier()
    sharding = state_sharding(model, mesh, TP_MIN_SIZE)
    shard_state(model, sharding)
    torch.cuda.empty_cache()
    opt = port.make_optimizer(tcfg, 100, model)
    step = port.make_train_step(model, lc, opt, accum_steps=ACCUM, mesh=mesh,
                                state_shardings=sharding)
    tgen = gen(DDP_SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, comm, launches, rows, timed = [], [], [], [], []
    for i, batch in enumerate(batches):
        mine = shard_batch(batch, mesh, ACCUM)
        sync()
        dist.barrier()
        port.reset_launch_counts()
        tp.reset_comm()
        # the last step (not the compared first) synchronises each
        # collective to time it
        tp.TIMED = 0 < i == steps - 1
        t0 = time.perf_counter()
        loss, row, met = step(mine, tgen)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        timed.append(tp.TIMED)
        tp.TIMED = False
        launches.append(dict(port.LAUNCHES))
        comm.append(comm_now())
        rows.append(row[0].tolist())
        if i == 0:  # the step from the reference's weights, made whole
            wgrads = {n: tp.whole_like(p.grad, p).float() for n, p in model.named_parameters()
                      if p.grad is not None}
            grad = torch.cat([g.reshape(-1) for g in wgrads.values()])
            stats = {n: b.clone() for n, b in model.named_buffers() if n in running}
            whole = gather_state_dict(model)
            if rank == 0:
                rec["loss"] = [loss.item(), r_loss.item()]
                rec["loss_rel_err"] = abs(loss.item() - r_loss.item()) / abs(r_loss.item())
                rec["row_rel_err"] = ((row - r_row).abs().max() / r_row.abs().max()).item()
                rec["grad_rel_l2"] = ((grad - r_grad).norm() / r_grad.norm()).item()
                rec["stats_rel_err"] = _ddp_max_rel(torch, stats, r_stats)
                # each leaf's Adam step against one process's (tp_step_err)
                errs = tp_step_err(whole, r_params, r_before, r_g)
                held = {n for n, e in errs.items() if r_params[n].ndim >= 2}
                worst = max(held, key=lambda n: errs[n][0])
                rec["adam_step_rel_err"] = errs[worst][0]
                rec["adam_step_worst"] = worst
                # the worst leaves: (name, weighted, unweighted, the leaf's
                # largest |gradient| over the model's, its gradient's
                # relative L2 against one process's)
                top = max(g.abs().max().item() for g in r_g.values())
                rec["adam_step_top"] = [
                    (n, *errs[n], r_g[n].abs().max().item() / top,
                     ((wgrads[n] - r_g[n]).norm() / r_g[n].norm()).item())
                    for n in sorted(held & r_g.keys(), key=lambda n: -errs[n][0])[:3]]
                rec["adam_step_unweighted"] = max(errs[n][1] for n in held)
                rec["adam_step_rel_err_1d"] = max(
                    [e[0] for n, e in errs.items() if n not in held], default=0.0)
                rec["adam_step_all_cut_held"] = set(sharding.sharded) <= held
                rec["adam_step_cut_smallest_grad"] = min(
                    (r_g[n].abs().max().item() / top, n) for n in sharding.sharded if n in r_g)
                del r_grad, r_params, r_before, r_g
            del grad, wgrads, stats, whole
    rec.update(step_ms=step_ms, comm=comm, comm_timed=timed, train_launches=launches,
               loss_rows=rows, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               train_finite=bool(torch.isfinite(row).all() and torch.isfinite(met).all()))
    # what this rank holds, against the sharding's reckoning
    rec["local_params"] = sum(p.numel() for p in model.parameters())
    rec["local_moments"] = sum(v.numel() for st in opt.state.values() for v in st.values()
                               if torch.is_tensor(v))
    rec["reckoned_params"] = sharding.local_numel(model)
    rec["sharded_tensors"] = len(sharding.sharded)
    rec["whole_params"] = sum(int(math.prod(tp.shard_info(p).whole_shape))
                              if tp.shard_info(p) else p.numel() for p in model.parameters())
    rec["sharded_elems"] = sum(int(math.prod(tp.shard_info(p).whole_shape))
                               for p in model.parameters() if tp.shard_info(p))
    # every rank's whole tensors (gathered shards, replicated parameters,
    # buffers) after the updates, bit for bit against rank 0's
    mismatched = 0
    with torch.no_grad():
        for t in gather_state_dict(model).values():
            mine_t = t.detach().cpu()
            theirs = mine_t.clone()
            dist.broadcast(theirs, 0)
            mismatched += int(not torch.equal(mine_t, theirs))
    rec["tensors_unlike_rank0"] = mismatched
    del model, step, opt, batches, mine, loss, row, met
    torch.cuda.empty_cache()

    # ---- (b) a served request of 8 on the sharded serve model
    if serve:
        scfg = port.Config(**DDP_SERVE, mesh_shape=spec).finalize()
        smodel = port.build_model(scfg, device=dev)
        broadcast_module(smodel, mesh)
        rgen = gen(scfg.seed)
        rgb = torch.randn(B, H_IMG, W_IMG, 3, generator=rgen, device=dev)
        depth = torch.rand(B, H_IMG, W_IMG, 1, generator=rgen, device=dev) * 79 + 1
        req = {"rgb": rgb, "gt": depth * (torch.rand(B, H_IMG, W_IMG, 1, generator=rgen,
                                                      device=dev) < 0.3)}
        if rank == 0:
            one = port.make_eval_step(smodel)
            with tp_first_step(smodel) as one_seen:
                p8, m8, _ = one(req, generator=gen(DDP_SEED))
            del one
        shard_state(smodel, state_sharding(smodel, mesh, TP_MIN_SIZE))
        torch.cuda.empty_cache()
        # one request, no warm-up: its collectives (~95% of it) leave a first
        # call's own cost in the noise
        estep = port.make_eval_step(smodel, mesh=mesh, gather=True)
        sync()
        dist.barrier()
        port.reset_launch_counts()
        tp.reset_comm()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with tp_first_step(smodel) as seen:
            pred, met, _ = estep(shard_batch(req, mesh), generator=gen(DDP_SEED))
        sync()
        rec["eval_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["eval_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["eval_launches"] = dict(port.LAUNCHES)
        rec["eval_comm"] = comm_now()
        rec["eval_metric"] = met[0].tolist()
        rec["metric_vs_gathered"] = ((met - evaluate_depth_metrics(req, {"pred": pred})).abs()
                                     .max() / met.abs().max()).item()
        if rank == 0:
            for key in ("cond", "step1"):
                rec[f"{key}_rel_l2_one_process"] = ((seen[key] - one_seen[key]).norm()
                                                    / one_seen[key].norm()).item()
            del one_seen
            rec["pred_rel_err_one_process"] = ((pred - p8).abs().max() / p8.abs().max()).item()
            rec["metric_rel_err_one_process"] = ((met - m8).abs().max()
                                                 / m8.abs().max()).item()
            rec["pred_shape"] = list(pred.shape)
            rec["pred_finite"] = bool(torch.isfinite(pred).all())
        del smodel, estep, pred, req, seen
        torch.cuda.empty_cache()
    gathered = [None] * mesh.world_size
    dist.all_gather_object(gathered, rec)
    return {"ranks": gathered}


def tp_phase(port, torch, dev, t_expect, s_expect) -> dict:
    """Phase 23: ``tp_rank`` on two gloo ranks at model:2 (3 steps and a
    request) and on four at data:2,model:2 (2 steps), all on the one card,
    held to their checks. Returns rank 0's launch counts of one model:2
    training step and one request."""
    from diffusiondepth_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    out = {}
    for spec, n, steps, serve in (("model:2", 2, 3, True), ("data:2,model:2", 4, 2, False)):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res = launch(tp_rank, [dev] * n, TP_PORTS[spec], (spec, steps, serve))
        ranks = res["ranks"]
        r0 = ranks[0]
        rec = {"phase": "tp", "mesh": spec, "ranks": n,
               "what": f"{n} gloo ranks on one card through parallel.launch: correctness and "
                       "the ranks' own cost, not NVLink",
               "config": f"phase 6's recipe (global batch 8 = 2 x 4, 352x906, bf16, drop-path "
                         f"0.1, seed 7240), state_sharding min_size {TP_MIN_SIZE}",
               "loss": r0["loss"], "loss_rel_err": r0["loss_rel_err"],
               "row_rel_err": r0["row_rel_err"], "grad_rel_l2": r0["grad_rel_l2"],
               "stats_rel_err": r0["stats_rel_err"],
               "adam_step_rel_err": r0["adam_step_rel_err"],
               "adam_step_worst_leaf": r0["adam_step_worst"],
               "adam_step_unweighted": r0["adam_step_unweighted"],
               "adam_step_cut_smallest_grad": r0["adam_step_cut_smallest_grad"],
               "adam_step_top": r0["adam_step_top"],
               "adam_step_rel_err_1d_leaves": r0["adam_step_rel_err_1d"],
               "tols": [DDP_BF16_LOSS_TOL, DDP_BF16_GRAD_TOL, DDP_BF16_STATS_TOL,
                        TP_ADAM_STEP_TOL],
               "step_ms_by_rank": [r["step_ms"] for r in ranks],
               "comm_timed_steps": r0["comm_timed"],
               "comm_by_rank": [r["comm"] for r in ranks],
               "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
               "sharded_tensors": r0["sharded_tensors"], "whole_params": r0["whole_params"],
               "sharded_params": r0["sharded_elems"],
               "local_params_by_rank": [r["local_params"] for r in ranks],
               "local_moments_by_rank": [r["local_moments"] for r in ranks],
               "loss_rows": r0["loss_rows"], "launches_per_step": r0["train_launches"][-1],
               "seconds": time.perf_counter() - t0}
        if serve:
            rec["serve"] = {"batch": B, "eval_ms_by_rank": [r["eval_ms"] for r in ranks],
                            "peak_gb_by_rank": [r["eval_peak_gb"] for r in ranks],
                            "comm_by_rank": [r["eval_comm"] for r in ranks],
                            "metric_row": r0["eval_metric"],
                            "cond_rel_l2_one_process": r0["cond_rel_l2_one_process"],
                            "step1_rel_l2_one_process": r0["step1_rel_l2_one_process"],
                            "tol": TP_SERVE_TOL,
                            "pred_rel_err_one_process": r0["pred_rel_err_one_process"],
                            "metric_rel_err_one_process": r0["metric_rel_err_one_process"],
                            "launches_per_request": r0["eval_launches"]}
        emit(rec)  # before the checks: a failed check still shows the numbers
        for r in ranks:
            who = f"tp {spec} rank {r['rank']}"
            for i, got in enumerate(r["train_launches"]):
                check(got == t_expect, f"{who} step {i} launches {got} != {t_expect}")
            check(r["tensors_unlike_rank0"] == 0,
                  f"{who}: {r['tensors_unlike_rank0']} whole tensors differ from rank 0's")
            check(r["train_finite"], f"{who}: non-finite loss or metric row")
            check(r["local_params"] == r["reckoned_params"]
                  and r["local_moments"] == 2 * r["reckoned_params"],
                  f"{who}: holds {r['local_params']} parameter and {r['local_moments']} "
                  f"moment elements, reckoned {r['reckoned_params']}")
            check(r["local_params"] < r["whole_params"], f"{who}: nothing was cut")
            if serve:
                check(r["eval_launches"] == s_expect,
                      f"{who} request launches {r['eval_launches']} != {s_expect}")
                check(r["metric_vs_gathered"] <= 1e-6,
                      f"{who} metric row: {r['metric_vs_gathered']}")
        check(r0["loss_rel_err"] <= DDP_BF16_LOSS_TOL and r0["row_rel_err"] <= DDP_BF16_LOSS_TOL,
              f"tp {spec} loss {r0['loss']} rel err {r0['loss_rel_err']}, row "
              f"{r0['row_rel_err']}")
        check(r0["grad_rel_l2"] <= DDP_BF16_GRAD_TOL,
              f"tp {spec} gradient rel L2 {r0['grad_rel_l2']}")
        check(r0["stats_rel_err"] <= DDP_BF16_STATS_TOL,
              f"tp {spec} BatchNorm statistics rel err {r0['stats_rel_err']}")
        check(r0["adam_step_all_cut_held"] and r0["adam_step_rel_err"] <= TP_ADAM_STEP_TOL,
              f"tp {spec} Adam's first step against one process: {r0['adam_step_rel_err']} "
              f"({r0['adam_step_worst']}; every cut tensor held: "
              f"{r0['adam_step_all_cut_held']})")
        if serve:
            check(r0["pred_finite"] and r0["pred_shape"] == [B, H_IMG, W_IMG, 1],
                  f"tp {spec} pred {r0['pred_shape']}")
            for key in ("cond", "step1"):
                got = r0[f"{key}_rel_l2_one_process"]
                check(got <= TP_SERVE_TOL, f"tp {spec} request {key} against one process: {got}")
        out[spec] = r0
    emit({"phase": "tp", "seconds": time.perf_counter() - t_phase})
    r0 = out["model:2"]
    return {k: r0["train_launches"][-1][k] + r0["eval_launches"][k] for k in t_expect}


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
    from diffusiondepth_tpu_torch.losses import get_loss_names
    from diffusiondepth_tpu_torch.models.backbones.swin import shifted_window_mask
    from diffusiondepth_tpu_torch.models.common import LayerNorm
    from diffusiondepth_tpu_torch.models.necks.transformer import (
        PixelTransformerDecoder, PureMSDEnTransformer,
    )
    from diffusiondepth_tpu_torch.ops import native
    from diffusiondepth_tpu_torch.ops.msda import MultiScaleDeformableAttention, ms_deform_attn
    from diffusiondepth_tpu_torch.ops.layernorm import (
        layernorm_bwd, layernorm_bwd_plain, layernorm_bwd_plan, layernorm_fwd,
        layernorm_fwd_plain,
    )
    from diffusiondepth_tpu_torch.ops.fused_denoiser import (
        CONV_LINK_BLOCK_PIXELS, _conv_link_lib, _link_input_plain, conv_link, conv_link_bwd,
        conv_link_bwd_plain, conv_link_plain, ddim_step, ddim_step_plain, sched_bwd,
        sched_bwd_plain, sched_step, sched_step_plain,
    )
    from diffusiondepth_tpu_torch.ops.window_attention import (
        window_attention, window_attention_bwd, window_attention_bwd_plain,
        window_attention_plain, window_attention_split, window_attention_split_plain,
    )

    t_start = time.perf_counter()
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

    def graph_ms(fn, n=100, reps=3):
        """Time per call of fn replayed from a CUDA graph of n calls: the
        host's launch cost (Python, Triton's launcher) is left out."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        sync()
        del graph
        return start.elapsed_time(end) / (reps * n)

    def small_ms(fn, iters):
        """(ms, event-timed ms) of a call that may take under 0.1 ms: the
        CUDA-graph replay is its time; the event-timed loop of launches
        from Python may read the host's launch cost instead."""
        return graph_ms(fn), cuda_ms(fn, iters)

    def median_ms(fn, iters=15, warmup=5):
        """Median of event-timed single calls after warm-up: a library
        call whose first calls tune or allocate reads steady this way."""
        for _ in range(warmup):
            fn()
        sync()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    def pass_split(fn, names):
        """Device ms of one warmed call of fn by kernel, summed over the
        kernels whose name holds each of ``names`` (torch.profiler, CUDA
        activity)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        return {n: sum(e.self_device_time_total for e in prof.key_averages() if n in e.key) / 1e3
                for n in names}

    def top_kernels(fn, k=8):
        """The ``k`` CUDA kernels of one warmed call of fn that take the most
        device time (torch.profiler): [name, ms, calls], and the call's
        total device ms."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        ev.sort(key=lambda e: -e.self_device_time_total)
        return {"device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
                "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in ev[:k]]}

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
    # -Xptxas -v of the tensor-core attention kernels and of K10 by kernel,
    # and whether each library's SASS holds tensor-core (HMMA/HGMMA),
    # ldmatrix and cp.async (LDGSTS) instructions
    for src, log in logs.items():
        if not (src.startswith("window_attention") or src == "layernorm_bwd"):
            continue
        entry = None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif entry and ("registers" in ln or "spill" in ln):
                print(f"ptxas {src} {entry}: {ln.split(':', 1)[-1].strip()}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = {}
        for src in native.CUDA_SOURCES:
            text = subprocess.run([cuobjdump, "-sass", str(native._lib_path(src))],
                                  capture_output=True, text=True).stdout
            sass[src] = {op: text.count(op) for op in ("HMMA", "HGMMA", "LDSM", "LDGSTS")}
        emit({"phase": "sass", "counts": sass})
    sync()

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    bf = torch.bfloat16
    iters = 3 if args.quick else 10
    summary = {}

    # ---- 3a. K1 conv link, six configurations of the chain at the bs8 eval
    # latent, then at the (4, 176, 453) latent of a training micro-batch
    _conv_link_lib()  # checks the library's block against CONV_LINK_BLOCK_PIXELS
    k1_bm = CONV_LINK_BLOCK_PIXELS  # output pixels per block: one partial each

    def k1_chain(bsz, lh, lw, what):
        k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                  flops=0.0, bytes=0.0)
        for lname, cin, cout, gn, add, stats in LINKS:
            x = randn(bsz, lh, lw, cin, dtype=bf)
            w = randn(3, 3, cin, cout, dtype=bf, scale=(9 * cin) ** -0.5)
            bias = randn(cout, scale=0.1)
            kw = dict(stats=stats)
            if gn:
                kw.update(aeff=(1.0 + randn(bsz, cin, scale=0.1)).contiguous(),
                          beff=randn(bsz, cin, scale=0.1), relu=True)
            if add:
                kw.update(add=randn(bsz, lh, lw, cin, dtype=bf),
                          te=randn(bsz, cin, dtype=bf, scale=0.1))
            y_k, ps_k = conv_link(x, w, bias, **kw)
            y_2, ps_2 = conv_link(x, w, bias, **kw)
            y_p, ps_p = conv_link_plain(x, w, bias, **kw)
            sync()
            bitwise = torch.equal(y_k, y_2) and (not stats or torch.equal(ps_k, ps_2))
            check(bitwise, f"conv_link {lname} {what}: two launches differ")
            err = (y_k.float() - y_p.float()).abs().max().item()
            ref = y_p.float().abs().max().item()
            # bf16 y: f32 sums in another order may round to the neighbouring
            # bf16 value (2^-8 relative); 1e-2 of the map's largest value
            tol = 1e-2 * ref
            rec = {"phase": "kernel", "kernel": "conv_link", "shapes": what, "link": lname,
                   "cin": cin, "cout": cout, "shape": [bsz, lh, lw], "max_abs_err": err,
                   "tol": tol, "bitwise_repeatable": bitwise}
            check(math.isfinite(err) and err <= tol, f"conv_link {lname} {what}: {err} > {tol}")
            if stats:
                sk = ps_k.sum(1)
                sp = ps_p.sum(1)
                serr = ((sk - sp).abs().max() / sp.abs().max()).item()
                rec["stats_rel_err"] = serr
                # f32 sums of ~1e6 terms in another order
                check(serr <= 1e-4, f"conv_link {lname} {what} stats: {serr}")
            ms = cuda_ms(lambda: conv_link(x, w, bias, **kw), iters)
            plain_ms = cuda_ms(lambda: conv_link_plain(x, w, bias, **kw), max(1, iters // 3), 1)
            v = _link_input_plain(x, kw.get("aeff"), kw.get("beff"), gn, kw.get("add"),
                                  kw.get("te")).to(bf).permute(0, 3, 1, 2)
            w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            b_lib = bias.to(bf)
            lib_ms = cuda_ms(lambda: F.conv2d(v, w_lib, b_lib, padding=1), iters)
            n_pix = bsz * lh * lw
            nbytes = (n_pix * cin * 2 * (2 if add else 1) + 9 * cin * cout * 2 + cout * 4
                      + n_pix * cout * 2 + (2 * bsz * cin * 4 if gn else 0)
                      + (bsz * cin * 2 if add else 0)
                      + (bsz * lh * math.ceil(lw / k1_bm) * 2 * cout * 4 if stats else 0))
            flops = 2.0 * n_pix * 9 * cin * cout
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                       tflops=flops / ms / 1e9)
            emit(rec)
            for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                           ("library_ms", lib_ms), ("flops", flops), ("bytes", nbytes)):
                k1[k] += val
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            del x, w, y_k, y_2, y_p, v
        k1["bound_by"] = bound(k1["bytes"], k1["flops"], BF16_FLOPS)[1]
        emit({"phase": "kernel", "kernel": "conv_link", "shapes": what,
              "what": "one six-link chain", "shape": [bsz, lh, lw], "ms": k1["ms"],
              "library_ms": k1["library_ms"], "bound_ms": k1["bound_ms"],
              "tflops": k1["flops"] / k1["ms"] / 1e9})
        sync()
        return k1

    summary["conv_link"] = k1_chain(B, H_IMG // 2, W_IMG // 2, "serve")
    k1_train = k1_chain(B_T // ACCUM, H_T // 2, W_T // 2, "train")
    summary["conv_link"].update(train_ms=k1_train["ms"], train_bound_ms=k1_train["bound_ms"],
                                train_library_ms=k1_train["library_ms"])

    # ---- 3b. K3 DDIM step on the latent, scalars of a mid-trajectory step
    sched_rows = torch.from_numpy(DDIMSchedule().inference_tables(STEPS).sched()).to(dev)

    def k3_check(bsz, lh, lw, what):
        u6 = randn(bsz, lh, lw, 16, dtype=bf)
        xl = randn(bsz, lh, lw, 16)
        a3 = (1.0 + randn(bsz, 16, scale=0.1)).contiguous()
        b3 = randn(bsz, 16, scale=0.1)
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
            emit({"phase": "kernel", "kernel": "ddim_step", "shapes": what, "step": i,
                  "max_abs_err": err, "tol": tol})
            check(math.isfinite(err) and err <= tol, f"ddim_step {what} {i}: {err} > {tol}")
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
        s = sched_rows[STEPS // 2]
        k3["ms"], k3["event_ms"] = small_ms(lambda: ddim_step(u6, a3, b3, xl, s), iters * 5)
        k3["plain_ms"] = cuda_ms(lambda: ddim_step_plain(u6, a3, b3, xl, s), iters)
        n = u6.numel()
        k3_bytes = n * (2 + 4 + 4) + 2 * bsz * 16 * 4 + 16
        k3["bound_ms"], k3["bound_by"] = bound(k3_bytes, 12.0 * n, F32_FLOPS)
        k3["library_ms"] = None
        emit({"phase": "kernel", "kernel": "ddim_step", "shapes": what,
              "shape": [bsz, lh, lw, 16], **k3})
        del u6, xl
        sync()
        return k3

    summary["ddim_step"] = k3_check(B, H_IMG // 2, W_IMG // 2, "serve")

    # ---- 3c. K4 window attention at the four Swin-L stages, bs8 352x1216
    # (serve), then bs4 352x906 (one training micro-batch: 4 passes a step,
    # the forward and its recompute for each of 2 micro-batches)
    def k4_pass(bsz, h_img, w_img, what):
        k4 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
        for stage, (depth, heads, c) in enumerate(zip(SWIN_L["depths"], SWIN_L["heads"],
                                                      SWIN_L["dims"])):
            h_pad, w_pad, nw = swin_stage_windows(h_img, w_img, stage)
            qkv = randn(bsz, nw, 49, 3 * c, dtype=bf)
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
                q, k, v = (t.reshape(bsz * nw, heads, 49, c // heads) for t in
                           qkv.view(bsz, nw, 49, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5))
                if mask is None:
                    amask = bias[None].to(bf)
                else:
                    amask = (bias[None] + mask[:, None]).to(bf)
                    amask = amask.expand(bsz, nw, heads, 49, 49).reshape(bsz * nw, heads, 49, 49)
                # SDPA as the median of warmed single calls: an event-timed
                # loop read it unsteadily between runs
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=amask, scale=scale))
                nbytes = qkv.numel() * 2 + bsz * nw * 49 * c * 2 + bias.numel() * 4 + (
                    mask.numel() * 4 if shifted else 0)
                flops = 4.0 * bsz * nw * heads * 49 * 49 * (c // heads)
                bms, by = bound(nbytes, flops, BF16_FLOPS)
                emit({"phase": "kernel", "kernel": "window_attention", "shapes": what,
                      "stage": stage, "shifted": shifted, "shape": [bsz, nw, 49, 3 * c],
                      "heads": heads, "max_abs_err": err, "tol": tol, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                      "bound_by": by, "gbps": nbytes / ms / 1e6})
                reps = depth // 2  # half the blocks of a stage are shifted
                k4["ms"] += reps * ms
                k4["plain_ms"] += reps * plain_ms
                k4["library_ms"] += reps * lib_ms
                k4["bound_ms"] += reps * bms
                k4["max_abs_err"] = max(k4["max_abs_err"], err)
            del qkv, out_k, out_p
        k4["bound_by"] = "bytes"
        emit({"phase": "kernel", "kernel": "window_attention", "shapes": what,
              "what": "one Swin-L pass", **k4})
        return k4

    summary["window_attention"] = k4_pass(B, H_IMG, W_IMG, "serve")
    k4_train = k4_pass(B_T // ACCUM, H_T, W_T, "train")
    summary["window_attention"]["train_ms"] = k4_train["ms"]
    sync()

    # ---- 3d. K2 scheduler step and 3e. K6 its backward, on the training latent
    tb = B_T // ACCUM

    def k2_k6_check(tb, th_, tw_, what):
        u6 = randn(tb, th_, tw_, 16, dtype=bf)
        xl = randn(tb, th_, tw_, 16)
        a3 = (1.0 + randn(tb, 16, scale=0.1)).contiguous()
        b3 = randn(tb, 16, scale=0.1)
        k2 = dict(max_abs_err=0.0)
        k6 = dict(max_abs_err=0.0)
        coefs = torch.zeros(tb, 8, 16, device=dev)
        coefs[:, 0], coefs[:, 1] = a3, b3
        coefs[:, 2] = 1.0 + randn(tb, 16, scale=0.1)
        coefs[:, 3] = randn(tb, 16, scale=0.1)
        coefs[:, 4] = 1.0 + randn(tb, 16, scale=0.1)
        dxp = randn(tb, th_, tw_, 16, scale=0.01)
        dxpb = randn(tb, th_, tw_, 16, dtype=bf, scale=0.01)
        for i in (0, STEPS // 2, STEPS - 1):
            s = sched_rows[i]
            xp_k, xpb_k = sched_step(u6, a3, b3, xl, s)
            xp_p, xpb_p = sched_step_plain(u6, a3, b3, xl, s)
            dx_k, t6_k, ps_k = sched_bwd(dxp, dxpb, u6, coefs, s)
            dx_p, t6_p, ps_p = sched_bwd_plain(dxp, dxpb, u6, coefs, s)
            sync()
            ref = xp_p.abs().max().item()
            err = (xp_k - xp_p).abs().max().item()
            err_b = (xpb_k.float() - xpb_p.float()).abs().max().item()
            # x' in f32 as K3 (1e-5 of the largest value); its bf16 copy within
            # one bf16 step of that (2^-8 relative)
            check(err <= 1e-5 * ref and err_b <= 4e-3 * ref,
                  f"sched_step {what} {i}: {err} {err_b}")
            dx_err = (dx_k - dx_p).abs().max().item()
            t_ref = t6_p.float().abs().max().item()
            t_err = (t6_k.float() - t6_p.float()).abs().max().item()
            ps_err = ((ps_k.sum(1) - ps_p.sum(1)).abs().max() / ps_p.sum(1).abs().max()).item()
            # dx: f32 closed form (1e-5); t6: one bf16 step (1e-2 of the largest
            # value); partials: f32 sums of ~80k terms in another order (1e-4)
            check(dx_err <= 1e-5 * dx_p.abs().max().item() and t_err <= 1e-2 * t_ref
                  and ps_err <= 1e-4, f"sched_bwd {what} {i}: {dx_err} {t_err} {ps_err}")
            emit({"phase": "kernel", "kernel": "sched_step+sched_bwd", "shapes": what,
                  "step": i, "sched_step_err": err, "sched_step_bf16_err": err_b,
                  "sched_bwd_dx_err": dx_err, "sched_bwd_t6_err": t_err,
                  "sched_bwd_partials_rel_err": ps_err})
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            k6["max_abs_err"] = max(k6["max_abs_err"], t_err)
        s = sched_rows[STEPS // 2]
        n = u6.numel()
        k2["ms"], k2["event_ms"] = small_ms(lambda: sched_step(u6, a3, b3, xl, s), iters * 5)
        k2["plain_ms"] = cuda_ms(lambda: sched_step_plain(u6, a3, b3, xl, s), iters)
        k2["bound_ms"], k2["bound_by"] = bound(n * (2 + 4 + 4 + 2) + 2 * tb * 16 * 4 + 16,
                                               12.0 * n, F32_FLOPS)
        k2["library_ms"] = None
        k6["ms"], k6["event_ms"] = small_ms(lambda: sched_bwd(dxp, dxpb, u6, coefs, s),
                                            iters * 5)
        k6["plain_ms"] = cuda_ms(lambda: sched_bwd_plain(dxp, dxpb, u6, coefs, s), iters)
        n_ps = ps_k.numel()
        k6["bound_ms"], k6["bound_by"] = bound(n * (4 + 2 + 2 + 4 + 2) + coefs.numel() * 4 + 16
                                               + n_ps * 4, 25.0 * n, F32_FLOPS)
        k6["library_ms"] = None
        emit({"phase": "kernel", "kernel": "sched_step", "shapes": what,
              "shape": [tb, th_, tw_, 16], **k2})
        emit({"phase": "kernel", "kernel": "sched_bwd", "shapes": what,
              "shape": [tb, th_, tw_, 16], **k6})
        del u6, xl, dxp, dxpb
        sync()
        return k2, k6

    summary["sched_step"], summary["sched_bwd"] = k2_k6_check(tb, H_T // 2, W_T // 2, "train")

    # ---- 3f. K5 conv-link backward, six links on the training latent
    def coef8(bsz, c):
        out = torch.zeros(bsz, 8, c, device=dev)
        out[:, 0] = 1.0 + randn(bsz, c, scale=0.1)
        out[:, 1:4] = randn(bsz, 3, c, scale=0.1)
        out[:, 4] = 1.0 + randn(bsz, c, scale=0.1)
        return out

    def k5_chain(tb, th_, tw_, what):
        k5 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                  flops=0.0, bytes=0.0)
        k5_pass = {n: 0.0 for n in K5_PASSES}
        for lname, cin, cout, gn, add, stats in LINKS:
            # GroupNorm on the link's output (t-form r) wherever the forward
            # emits its statistics
            r = randn(tb, th_, tw_, cout, dtype=bf, scale=0.01)
            w = randn(3, 3, cin, cout, dtype=bf, scale=(9 * cin) ** -0.5)
            u_in = randn(tb, th_, tw_, cin, dtype=bf)
            kw = {}
            if stats:
                kw.update(u_next=randn(tb, th_, tw_, cout, dtype=bf), coef_next=coef8(tb, cout))
            if gn:
                kw["coef_in"] = coef8(tb, cin)
            if add:
                kw.update(add=randn(tb, th_, tw_, cin, dtype=bf),
                          te=randn(tb, cin, dtype=bf, scale=0.1))
            out_k = conv_link_bwd(r, w, u_in, **kw)
            again = conv_link_bwd(r, w, u_in, **kw)
            out_p = conv_link_bwd_plain(r, w, u_in, **kw)
            sync()
            bitwise = all((a is None and b_ is None) or torch.equal(a, b_)
                          for a, b_ in zip(out_k, again))
            check(bitwise, f"conv_link_bwd {lname} {what}: two launches differ")
            names = ("t", "dw", "db", "partials", "d_add")
            rec = {"phase": "kernel", "kernel": "conv_link_bwd", "shapes": what, "link": lname,
                   "cin": cin, "cout": cout, "shape": [tb, th_, tw_],
                   "bitwise_repeatable": bitwise}
            for nm, a, b_ in zip(names, out_k, out_p):
                if a is None:
                    continue
                if nm == "partials":
                    a, b_ = a.sum(1), b_.sum(1)
                ref = b_.float().abs().max().item()
                e = (a.float() - b_.float()).abs().max().item()
                # bf16 maps (t, d_add): one bf16 step, 1e-2 of the largest
                # value; f32 sums over 319k pixels in another order: 1e-3
                tol = (1e-2 if nm in ("t", "d_add") else 1e-3) * ref
                check(math.isfinite(e) and e <= tol,
                      f"conv_link_bwd {lname} {what} {nm}: {e} > {tol}")
                rec[nm + "_err"], rec[nm + "_tol"] = e, tol
            k5["max_abs_err"] = max(k5["max_abs_err"], rec["t_err"])
            ms = cuda_ms(lambda: conv_link_bwd(r, w, u_in, **kw), iters)
            # device time of one launch by pass: data gradient, weight
            # gradient, the fixed-order reduce
            split = pass_split(lambda: conv_link_bwd(r, w, u_in, **kw), K5_PASSES)
            rec["pass_ms"] = split
            for pn, pv in split.items():
                k5_pass[pn] += pv
            plain_ms = cuda_ms(lambda: conv_link_bwd_plain(r, w, u_in, **kw),
                               max(1, iters // 3), 1)
            # library: cuDNN's input and weight gradients of the same conv on the
            # pre-transformed input and the assembled du
            ci = kw.get("coef_in")
            v = _link_input_plain(u_in, ci[:, 0] if gn else None, ci[:, 1] if gn else None, gn,
                                  kw.get("add"), kw.get("te")).to(bf).permute(0, 3, 1, 2)
            du = r.permute(0, 3, 1, 2)
            w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib_ms = cuda_ms(lambda: (torch.nn.grad.conv2d_input(v.shape, w_lib, du, padding=1),
                                      torch.nn.grad.conv2d_weight(v, w_lib.shape, du,
                                                                  padding=1)),
                             iters)
            n_pix = tb * th_ * tw_
            nbytes = (n_pix * (cout * 2 * (2 if stats else 1) + cin * 2 * (2 if add else 1)
                               + cin * 2 * (2 if add else 1))
                      + 9 * cin * cout * (2 + 4) + cout * 4
                      + (8 * tb * (cout if stats else 0) + 8 * tb * (cin if gn else 0)) * 4
                      + (tb * cin * 2 if add else 0)
                      + (out_k[3].numel() * 4 if gn else 0))
            flops = 4.0 * n_pix * 9 * cin * cout
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                       tflops=flops / ms / 1e9)
            emit(rec)
            for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                           ("library_ms", lib_ms), ("flops", flops), ("bytes", nbytes)):
                k5[k] += val
            del r, u_in, out_k, again, out_p, v, du
        k5["bound_by"] = bound(k5["bytes"], k5["flops"], BF16_FLOPS)[1]
        emit({"phase": "kernel", "kernel": "conv_link_bwd", "shapes": what,
              "what": "one six-link chain", "shape": [tb, th_, tw_], "ms": k5["ms"],
              "library_ms": k5["library_ms"], "bound_ms": k5["bound_ms"],
              "tflops": k5["flops"] / k5["ms"] / 1e9, "pass_ms": k5_pass})
        sync()
        return k5

    summary["conv_link_bwd"] = k5_chain(tb, H_T // 2, W_T // 2, "train")

    # ---- 3x4. the kernels of the X4 model at its quarter-resolution
    # latents: K1 and K3 at serve (8, 88, 304); K1, K2, K6 and K5 (two
    # launches bit-equal) on a training micro-batch of 352x904 crops,
    # (4, 88, 226)
    x4 = {"conv_link": k1_chain(B, H_IMG // 4, W_IMG // 4, "serve-x4"),
          "ddim_step": k3_check(B, H_IMG // 4, W_IMG // 4, "serve-x4")}
    k1_x4t = k1_chain(tb, H_T // 4, W_X4T // 4, "train-x4")
    x4["sched_step"], x4["sched_bwd"] = k2_k6_check(tb, H_T // 4, W_X4T // 4, "train-x4")
    x4["conv_link_bwd"] = k5_chain(tb, H_T // 4, W_X4T // 4, "train-x4")
    x4_shapes = {"conv_link": [B, H_IMG // 4, W_IMG // 4], "ddim_step": [B, H_IMG // 4, W_IMG // 4],
                 "sched_step": [tb, H_T // 4, W_X4T // 4], "sched_bwd": [tb, H_T // 4, W_X4T // 4],
                 "conv_link_bwd": [tb, H_T // 4, W_X4T // 4]}
    for k, rec in x4.items():
        summary[k]["x4"] = {"shape": x4_shapes[k], **{
            f: rec[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "max_abs_err") if f in rec}}
    summary["conv_link"]["x4"].update(train_shape=[tb, H_T // 4, W_X4T // 4],
                                      train_ms=k1_x4t["ms"], train_bound_ms=k1_x4t["bound_ms"],
                                      train_library_ms=k1_x4t["library_ms"],
                                      train_max_abs_err=k1_x4t["max_abs_err"])

    # ---- 3g. K7 window-attention backward at the four Swin-L stages, bs4 352x906
    k7 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0)
    for stage, (depth, heads, c) in enumerate(zip(SWIN_L["depths"], SWIN_L["heads"],
                                                  SWIN_L["dims"])):
        h_pad, w_pad, nw = swin_stage_windows(H_T, W_T, stage)
        qkv = randn(tb, nw, 49, 3 * c, dtype=bf)
        dout = randn(tb, nw, 49, c, dtype=bf)
        bias = randn(heads, 49, 49, scale=0.1)
        scale = (c // heads) ** -0.5
        for shifted in (False, True):
            mask = (torch.from_numpy(shifted_window_mask(h_pad, w_pad, 7, 3)).to(dev)
                    if shifted else None)
            dq_k, db_k = window_attention_bwd(qkv, bias, mask, dout, scale, heads)
            dq_2, db_2 = window_attention_bwd(qkv, bias, mask, dout, scale, heads)
            dq_p, db_p = window_attention_bwd_plain(qkv, bias, mask, dout, scale, heads)
            sync()
            check(torch.equal(dq_k, dq_2) and torch.equal(db_k, db_2),
                  f"window_attention_bwd s{stage}: two launches differ")
            err = (dq_k.float() - dq_p.float()).abs().max().item()
            ref = dq_p.float().abs().max().item()
            db_err = (db_k - db_p).abs().max().item()
            db_ref = db_p.abs().max().item()
            # dqkv in bf16: one bf16 step of the largest value (2e-2, as P
            # and dS are rounded to bf16 too); dbias: f32 sums over batch
            # and windows in another order (1e-3)
            check(math.isfinite(err) and err <= 2e-2 * ref and db_err <= 1e-3 * db_ref,
                  f"window_attention_bwd s{stage}: {err} {db_err}")
            ms = cuda_ms(lambda: window_attention_bwd(qkv, bias, mask, dout, scale, heads),
                         iters)
            plain_ms = cuda_ms(lambda: window_attention_bwd_plain(qkv, bias, mask, dout, scale,
                                                                  heads),
                               max(1, iters // 3), 1)
            d = c // heads
            q, k, v = (t.reshape(tb * nw, heads, 49, d).detach().clone().requires_grad_()
                       for t in qkv.view(tb, nw, 49, 3, heads, d).permute(3, 0, 1, 4, 2, 5))
            am = bias[None] if mask is None else bias[None] + mask[:, None]
            am = am.to(bf).expand(tb, nw, heads, 49, 49).reshape(tb * nw, heads, 49, 49)
            am = am.contiguous().requires_grad_()
            lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
            g_out = dout.view(tb, nw, 49, heads, d).permute(0, 1, 3, 2, 4).reshape(
                tb * nw, heads, 49, d)
            lib_ms = median_ms(lambda: torch.autograd.grad(lib_out, (q, k, v, am), g_out,
                                                           retain_graph=True))
            nbytes = (qkv.numel() * 2 * 2 + dout.numel() * 2 + bias.numel() * 4 * 2
                      + (mask.numel() * 4 if shifted else 0))
            flops = 10.0 * tb * nw * heads * 49 * 49 * d
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            emit({"phase": "kernel", "kernel": "window_attention_bwd", "stage": stage,
                  "shifted": shifted, "shape": [tb, nw, 49, 3 * c], "heads": heads,
                  "max_abs_err": err, "tol": 2e-2 * ref, "dbias_err": db_err,
                  "dbias_tol": 1e-3 * db_ref, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                  "gbps": nbytes / ms / 1e6})
            reps = depth // 2
            for kk, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                            ("bound_ms", bms)):
                k7[kk] += reps * val
            k7["max_abs_err"] = max(k7["max_abs_err"], err)
            del q, k, v, am, lib_out
        del qkv, dout
    k7["bound_by"] = "bytes"
    emit({"phase": "kernel", "kernel": "window_attention_bwd", "what": "one Swin-L pass", **k7})
    summary["window_attention_bwd"] = k7
    sync()

    # ---- 3h. K8 split q/k/v window attention at the K4 shapes (bs8 352x1216)
    k8 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, k4_ms=0.0, max_abs_err=0.0)
    for stage, (depth, heads, c) in enumerate(zip(SWIN_L["depths"], SWIN_L["heads"],
                                                  SWIN_L["dims"])):
        h_pad, w_pad, nw = swin_stage_windows(H_IMG, W_IMG, stage)
        d = c // heads
        qkv = randn(B, nw, 49, 3 * c, dtype=bf)
        # the Swin block's permute to (B, nW, H, N, D), one tensor each
        q, k, v = (t.permute(0, 1, 3, 2, 4).contiguous()
                   for t in qkv.view(B, nw, 49, 3, heads, d).unbind(3))
        bias = randn(heads, 49, 49, scale=0.1)
        scale = d ** -0.5
        for shifted in (False, True):
            mask = (torch.from_numpy(shifted_window_mask(h_pad, w_pad, 7, 3)).to(dev)
                    if shifted else None)
            out_k = window_attention_split(q, k, v, bias, mask, scale)
            out_p = window_attention_split_plain(q, k, v, bias, mask, scale)
            out_4 = window_attention(qkv, bias, mask, scale, heads)
            sync()
            err = (out_k.float() - out_p.float()).abs().max().item()
            # as K4: a probability or the output may round to the
            # neighbouring bf16 value; and K8 sums in K4's order
            tol = 2e-2
            same_as_k4 = torch.equal(out_k.permute(0, 1, 3, 2, 4).reshape(out_4.shape), out_4)
            check(math.isfinite(err) and err <= tol and same_as_k4,
                  f"window_attention_split s{stage}: {err} same_as_k4={same_as_k4}")
            ms = cuda_ms(lambda: window_attention_split(q, k, v, bias, mask, scale), iters)
            k4_ms = cuda_ms(lambda: window_attention(qkv, bias, mask, scale, heads), iters)
            plain_ms = cuda_ms(lambda: window_attention_split_plain(q, k, v, bias, mask, scale),
                               max(1, iters // 3), 1)
            ql, kl, vl = (t.view(B * nw, heads, 49, d) for t in (q, k, v))
            if mask is None:
                amask = bias[None].to(bf)
            else:
                amask = (bias[None] + mask[:, None]).to(bf)
                amask = amask.expand(B, nw, heads, 49, 49).reshape(B * nw, heads, 49, 49)
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=amask, scale=scale))
            nbytes = 4 * q.numel() * 2 + bias.numel() * 4 + (mask.numel() * 4 if shifted else 0)
            flops = 4.0 * B * nw * heads * 49 * 49 * d
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            emit({"phase": "kernel", "kernel": "window_attention_split", "stage": stage,
                  "shifted": shifted, "shape": list(q.shape), "max_abs_err": err, "tol": tol,
                  "same_bits_as_k4": same_as_k4, "ms": ms, "k4_ms": k4_ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                  "gbps": nbytes / ms / 1e6})
            reps = depth // 2  # half the blocks of a stage are shifted
            for kk, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                            ("bound_ms", bms), ("k4_ms", k4_ms)):
                k8[kk] += reps * val
            k8["max_abs_err"] = max(k8["max_abs_err"], err)
            del out_k, out_p, out_4, amask
        del qkv, q, k, v, ql, kl, vl
    k8["bound_by"] = "bytes"
    emit({"phase": "kernel", "kernel": "window_attention_split", "what": "one Swin-L pass",
          **k8})
    summary["window_attention_split"] = k8
    sync()

    # ---- 3i. K9/K10 bf16 LayerNorm at the Swin-L norms of a 352x906 batch of 4
    norm_shapes = swin_norm_shapes(B_T // ACCUM, H_T, W_T)
    ln_shape = max(norm_shapes, key=lambda mc: mc[0] * mc[1])  # the layernorm path's
    ln_pass = {n: dict(ms=0.0, event_ms=0.0, plain_ms=0.0, library_ms=0.0,
                       library_event_ms=0.0, bound_ms=0.0)
               for n in ("layernorm_fwd", "layernorm_bwd")}
    for (m, c), count in sorted(norm_shapes.items()):
        x2 = (randn(m, c, scale=2.0) + 0.5).to(bf)
        dy2 = randn(m, c, dtype=bf)
        lw, lb = 1.0 + randn(c, scale=0.2), randn(c, scale=0.1)
        y_k, mean_k, inv_k = layernorm_fwd(x2, lw, lb, 1e-5)
        y_p, mean_p, inv_p = layernorm_fwd_plain(x2, lw, lb, 1e-5)
        dx_k, ds_k, db_k = layernorm_bwd(x2, dy2, mean_k, inv_k, lw)
        dx_2, ds_2, db_2 = layernorm_bwd(x2, dy2, mean_k, inv_k, lw)
        dx_p, ds_p, db_p = layernorm_bwd_plain(x2, dy2, mean_k, inv_k, lw)
        sync()
        bitwise = torch.equal(dx_k, dx_2) and torch.equal(ds_k, ds_2) and torch.equal(db_k, db_2)
        errs = {
            # bf16 y and dx: one bf16 step of the largest value
            "y": ((y_k.float() - y_p.float()).abs().max() / y_p.float().abs().max()).item(),
            "dx": ((dx_k.float() - dx_p.float()).abs().max() / dx_p.float().abs().max()).item(),
            # f32 statistics; inv through Triton's rsqrt (1e-4 relative)
            "mean": ((mean_k - mean_p).abs() / (1.0 + mean_p.abs())).max().item(),
            "inv": ((inv_k - inv_p).abs() / inv_p.abs()).max().item(),
            # f32 sums over all rows in another order
            "dscale": ((ds_k - ds_p).abs().max() / ds_p.abs().max()).item(),
            "dbias": ((db_k - db_p).abs().max() / db_p.abs().max()).item(),
        }
        tols = {"y": 1e-2, "dx": 1e-2, "mean": 1e-5, "inv": 1e-4, "dscale": 1e-3, "dbias": 1e-3}
        check(bitwise and all(math.isfinite(errs[e]) and errs[e] <= tols[e] for e in errs),
              f"layernorm ({m}, {c}): bitwise={bitwise} {errs}")
        # the library's LayerNorm on bf16 parameters (timed only)
        lwb, lbb = lw.to(bf), lb.to(bf)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x2, [c], lwb, lbb, 1e-5)
        n_el = m * c
        recs = {
            "layernorm_fwd": (lambda: layernorm_fwd(x2, lw, lb, 1e-5),
                              lambda: layernorm_fwd_plain(x2, lw, lb, 1e-5),
                              lambda: F.layer_norm(x2, (c,), lwb, lbb, 1e-5),
                              n_el * 4 + m * 8 + c * 8, 8.0 * n_el),
            "layernorm_bwd": (lambda: layernorm_bwd(x2, dy2, mean_k, inv_k, lw),
                              lambda: layernorm_bwd_plain(x2, dy2, mean_k, inv_k, lw),
                              lambda: torch.ops.aten.native_layer_norm_backward(
                                  dy2, x2, [c], lmean, lrstd, lwb, lbb, [True, True, True]),
                              n_el * 6 + m * 8 + c * 12, 12.0 * n_el),
        }
        for name_, (fn, plain_fn, lib_fn, nbytes, flops) in recs.items():
            ms, ev = small_ms(fn, iters * 2)
            plain_ms = cuda_ms(plain_fn, max(1, iters // 3), 1)
            lib_ms, lib_ev = small_ms(lib_fn, iters * 2)
            bms, by = bound(nbytes, flops, F32_FLOPS)
            rec = dict(ms=ms, event_ms=ev, plain_ms=plain_ms, library_ms=lib_ms,
                       library_event_ms=lib_ev, bound_ms=bms, bound_by=by)
            extra = {"share_of_bound": bms / ms}
            if name_ == "layernorm_bwd":
                plan = layernorm_bwd_plan(m, c, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
                extra["plan"] = {k: getattr(plan, k) for k in (
                    "ctas", "rows_per_stage", "stages", "threads_per_row",
                    "vectors_per_thread", "smem_bytes")}
            emit({"phase": "kernel", "kernel": name_, "shape": [m, c], "per_swin_l_pass": count,
                  "errors": errs, "tols": tols, "bitwise_repeatable": bitwise, **rec, **extra})
            for kk in ln_pass[name_]:
                ln_pass[name_][kk] += count * rec[kk]
            if (m, c) == ln_shape:
                got, ref = (y_k, y_p) if name_ == "layernorm_fwd" else (dx_k, dx_p)
                summary[name_] = dict(rec, max_abs_err=(got.float() - ref.float()).abs().max()
                                      .item())
        del x2, dy2, y_k, y_p, dx_k, dx_2, dx_p, lmean, lrstd
    for rec in ln_pass.values():
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    emit({"phase": "kernel", "kernel": "layernorm", "what": "sum over the 56 norms of one "
          "Swin-L forward (backward) at 352x906, batch 4", "shapes": {
              f"{m}x{c}": n for (m, c), n in sorted(norm_shapes.items())}, **ln_pass})
    sync()

    # ---- 3j. K9/K10 at every kind of width JAX's layernorm_bf16 takes
    # beyond Swin's: C = 1, C % 8 != 0 (K10 stages rows to ceil8(C)), C
    # above 3072 in K10's ring, above its ring (the wide variant) and above
    # K9's one-program row (its looped variant)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, c in LN_ANY_SHAPES:
        x2 = (randn(m, c, scale=2.0) + 0.5).to(bf)
        dy2 = randn(m, c, dtype=bf)
        lw, lb = 1.0 + randn(c, scale=0.2), randn(c, scale=0.1)
        n0 = dict(port.LAUNCHES)
        y_k, mean_k, inv_k = layernorm_fwd(x2, lw, lb, 1e-5)
        dx_k, ds_k, db_k = layernorm_bwd(x2, dy2, mean_k, inv_k, lw)
        dx_2, ds_2, db_2 = layernorm_bwd(x2, dy2, mean_k, inv_k, lw)
        sync()
        launched = {k: port.LAUNCHES[k] - n0[k] for k in ("layernorm_fwd", "layernorm_bwd")}
        y_p, mean_p, inv_p = layernorm_fwd_plain(x2, lw, lb, 1e-5)
        dx_p, ds_p, db_p = layernorm_bwd_plain(x2, dy2, mean_k, inv_k, lw)
        bitwise = torch.equal(dx_k, dx_2) and torch.equal(ds_k, ds_2) and torch.equal(db_k, db_2)

        def rel(a, b_):  # max |a - b| over the largest |b| (0 when both are 0)
            d = (a.float() - b_.float()).abs().max().item()
            return d / max(b_.float().abs().max().item(), 1e-30) if d else 0.0
        errs = {"y": rel(y_k, y_p), "dx": rel(dx_k, dx_p),
                "mean": ((mean_k - mean_p).abs() / (1.0 + mean_p.abs())).max().item(),
                "inv": ((inv_k - inv_p).abs() / inv_p.abs()).max().item(),
                "dscale": rel(ds_k, ds_p), "dbias": rel(db_k, db_p)}
        tols = {"y": 1e-2, "dx": 1e-2, "mean": 1e-5, "inv": 1e-4, "dscale": 1e-3, "dbias": 1e-3}
        check(launched == {"layernorm_fwd": 1, "layernorm_bwd": 2} and bitwise
              and all(math.isfinite(errs[e]) and errs[e] <= tols[e] for e in errs),
              f"layernorm ({m}, {c}): launches={launched} bitwise={bitwise} {errs}")
        lwb, lbb = lw.to(bf), lb.to(bf)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x2, [c], lwb, lbb, 1e-5)
        plan = layernorm_bwd_plan(m, c, sms)
        n_el, pitch = m * c, plan.pitch
        # K10's workspace: written and read once; staging when pitch != C:
        # x and dy read and written padded, the kernel's padded columns, dx
        # read padded and written cut back
        part_bytes = 2 * plan.ctas * 2 * pitch * 4
        stage_bytes = (4 * n_el + 4 * m * pitch + 6 * m * (pitch - c) + 2 * m * pitch
                       + 2 * n_el) if pitch != c else 0
        recs = {
            "layernorm_fwd": (lambda: layernorm_fwd(x2, lw, lb, 1e-5),
                              lambda: layernorm_fwd_plain(x2, lw, lb, 1e-5),
                              lambda: F.layer_norm(x2, (c,), lwb, lbb, 1e-5),
                              n_el * 4 + m * 8 + c * 8, 0, 8.0 * n_el),
            "layernorm_bwd": (lambda: layernorm_bwd(x2, dy2, mean_k, inv_k, lw),
                              lambda: layernorm_bwd_plain(x2, dy2, mean_k, inv_k, lw),
                              lambda: torch.ops.aten.native_layer_norm_backward(
                                  dy2, x2, [c], lmean, lrstd, lwb, lbb, [True, True, True]),
                              n_el * 6 + m * 8 + c * 12, part_bytes + stage_bytes,
                              12.0 * n_el),
        }
        for name_, (fn, plain_fn, lib_fn, nbytes, extra, flops) in recs.items():
            ms, ev = small_ms(fn, iters * 2)
            plain_ms = cuda_ms(plain_fn, max(1, iters // 3), 1)
            lib_ms, lib_ev = small_ms(lib_fn, iters * 2)
            bms, by = bound(nbytes, flops, F32_FLOPS)
            rec = dict(ms=ms, event_ms=ev, plain_ms=plain_ms, library_ms=lib_ms,
                       library_event_ms=lib_ev, bound_ms=bms, bound_by=by,
                       share_of_bound=bms / ms)
            if name_ == "layernorm_bwd":
                rec["bound_with_workspace_and_staging_ms"] = bound(nbytes + extra, flops,
                                                                   F32_FLOPS)[0]
                rec["plan"] = {k: getattr(plan, k) for k in (
                    "variant", "pitch", "ctas", "rows_per_stage", "stages", "threads_per_row",
                    "vectors_per_thread", "smem_bytes")}
            else:
                rec["variant"] = ("one-program" if c <= native.triton_module("layernorm")
                                  .ONE_PASS_MAX_C else "looped")
            emit({"phase": "kernel", "kernel": name_, "shape": [m, c], "any_width": True,
                  "errors": errs, "tols": tols, "bitwise_repeatable": bitwise, **rec})
        del x2, dy2, y_k, y_p, dx_k, dx_2, dx_p, lmean, lrstd
    sync()

    launches = {k: 0 for k in port.LAUNCHES}
    path_launches = {p: dict(launches) for p in ("serve", "serve-pallas", "train", "layernorm")}
    if not args.quick:
        # ---- 4. a small input against the CPU plain versions
        def micro_cfg(opt, model_name="Diffusion_DCbase_",
                      head="DDIMDepthEstimate_Swin_ADDHAHI"):
            return port.Config(model_name=model_name, backbone_module="swin",
                               backbone_name="swin_micro", head_specify=head,
                               inference_steps=2, opt_level=opt,
                               head_in_channels="32,64,128,256").finalize()

        cpu_gen = torch.Generator().manual_seed(1)
        rgb = torch.randn(2, 64, 96, 3, generator=cpu_gen)
        gt = torch.rand(2, 64, 96, 1, generator=cpu_gen) * 8 + 1

        def micro_reference(cfg_of):
            """The micro model ``cfg_of(opt)`` on the card against the same
            weights on the CPU, f32 (O0) and bf16 (O1): the pyramid, the
            condition map at latent resolution and one denoiser call; then
            one eval step on the card, finite and of the batch's shape."""
            ref = {}
            for opt, tol in (("O0", 1e-3), ("O1", 2e-2)):
                gpu_m = port.build_model(cfg_of(opt))
                cpu_m = port.build_model(cfg_of(opt), device="cpu")
                cpu_m.load_state_dict(gpu_m.state_dict())
                errs = {}
                with torch.no_grad():
                    outs = []
                    for m, d in ((gpu_m, dev), (cpu_m, torch.device("cpu"))):
                        fp = m.depth_backbone(rgb.to(d))
                        head = m.depth_head
                        gt_t = head.depth_transform.t(gt.to(d))
                        cond = head.model.upsample_condition(
                            head.fpn_condition(head.hahineck(fp) if head.use_hahi else fp),
                            gt_t.shape[1:3])
                        lat = torch.randn(tuple(gt_t.shape[:3]) + (16,),
                                          generator=torch.Generator().manual_seed(2))
                        eps = head.model(lat.to(d), 500, cond)
                        outs.append([t.float().cpu() for t in (*fp, cond, eps)])
                    for i, (a, b_) in enumerate(zip(*outs)):
                        errs[i] = ((a - b_).abs().max() / b_.abs().max()).item()
                # f32 (O0): another summation order; bf16 (O1): 8-bit rounding
                # at other points, renormalised by the GroupNorms
                ref[opt] = {"rel_err": list(errs.values()), "tol": tol,
                            "fused_chain": gpu_m.depth_head.model.fused_active(
                                lat.shape[1])}
                check(all(math.isfinite(e) and e <= tol for e in errs.values()),
                      f"reference {opt}: {errs}")
                pred, met, _ = port.make_eval_step(gpu_m)(
                    {"rgb": rgb.to(dev), "gt": gt.to(dev)},
                    generator=torch.Generator(device=dev).manual_seed(3))
                check(tuple(pred.shape) == (2, 64, 96, 1) and bool(torch.isfinite(pred).all())
                      and bool(torch.isfinite(met).all()), f"micro eval {opt} not finite")
                del gpu_m, cpu_m
            return ref

        emit({"phase": "reference", "what": "swin_micro + flagship head, card vs CPU plain; "
              "outputs: 4 pyramid levels, condition map, one denoiser call",
              **micro_reference(micro_cfg)})
        sync()

        # one training step of the same micro model, card vs CPU, with the
        # same starting latent and DDIM draws and drop-path off: the loss
        # and every parameter's gradient
        lat0 = torch.randn(2, 32, 48, 16, generator=cpu_gen)
        noise = torch.randn(2, 32, 48, 16, generator=cpu_gen)
        ts = torch.tensor([413, 77])
        # RMS distance of each leaf, relative to that leaf's RMS or, for a
        # gradient that vanishes analytically (a bias followed by
        # BatchNorm), to 1e-3 of the largest leaf RMS. f32 (O0): the card's
        # convolutions and reductions sum in other orders and the
        # differences grow through two sampler steps, the reciprocal decode
        # and the backward (2e-2). bf16 (O1): the kernels and the plain
        # versions round at the same points, but a sum in another order can
        # move a bf16 value by one step and flip a ReLU, amplified the same
        # way (0.25)
        train_tols = (("O0", 2e-2), ("O1", 0.25))

        def micro_train(cfg_of, opt, tol, calibrate=False, lat=lat0, nz=noise,
                        build=port.build_model):
            """One training step of the micro model ``build(cfg_of(opt))`` on
            the card and on the CPU from the same weights, starting latent
            ``lat`` and DDIM noise ``nz``, drop-path and the attentions'
            dropout off: loss and per-leaf gradient distances, checked
            against ``tol``. ``calibrate``: a
            leaf may also sit within twice the distance between the CPU's
            gradient and an f32 CPU step's from the same weights (how far
            the compute type alone moves that leaf)."""
            gpu_m = build(cfg_of(opt))
            runs = [(gpu_m, dev)]
            for o in (opt, "O0") if calibrate else (opt,):
                runs.append((build(cfg_of(o), device="cpu"), torch.device("cpu")))
                runs[-1][0].load_state_dict(gpu_m.state_dict())
            lc = port.LossComputer(cfg_of(opt))
            grads, losses = [], []
            for m, d in runs:
                m.train()
                for mod in m.modules():  # drop-path and dropout off
                    if hasattr(mod, "drop_path_rate"):
                        mod.drop_path_rate = 0.0
                    if isinstance(mod, MultiScaleDeformableAttention):
                        mod.dropout = 0.0
                head = m.depth_head
                head._ddim_loss = functools.partial(head._ddim_loss, noise=nz.to(d),
                                                    timesteps=ts.to(d))
                mb = {"rgb": rgb.to(d), "gt": gt.to(d)}
                loss = lc(mb, m(mb, init_latent=lat.to(d)))[0] / 2
                loss.backward()
                losses.append(loss.item())
                grads.append({n: p.grad.float().cpu() for n, p in m.named_parameters()
                              if p.grad is not None})
            g_card, g_cpu = grads[:2]
            check(g_card.keys() == g_cpu.keys(), "micro train: gradients on different leaves")
            rms = {n: g.square().mean().sqrt().item() for n, g in g_cpu.items()}
            floor = 1e-3 * max(rms.values())

            def dist(a, b_):
                return {n: (a[n] - b_[n]).square().mean().sqrt().item() / max(rms[n], floor)
                        for n in g_cpu}

            dists = dist(g_card, g_cpu)
            bounds = {n: tol for n in g_cpu}
            if calibrate:
                dtype_dist = dist(g_cpu, grads[2])
                bounds = {n: max(tol, 2 * dtype_dist[n]) for n in g_cpu}
            loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
            worst = max(dists, key=lambda n: dists[n] / bounds[n])
            rec = {"loss": losses[:2], "loss_rel_err": loss_err, "grad_leaves": len(dists),
                   "worst_leaf": worst, "worst_rms_dist": dists[worst],
                   "worst_bound": bounds[worst],
                   "median_rms_dist": sorted(dists.values())[len(dists) // 2], "tol": tol,
                   "over_tol": sum(dists[n] > tol for n in dists)}
            check(all(math.isfinite(v) for v in dists.values()), f"micro train {opt}: not finite")
            check(loss_err <= tol and dists[worst] <= bounds[worst], f"micro train {opt}: {rec}")
            return rec

        tref = {opt: micro_train(micro_cfg, opt, tol) for opt, tol in train_tols}
        emit({"phase": "reference", "what": "swin_micro + flagship head, one training step, "
              "card vs CPU plain: loss and per-leaf gradients (RMS distance)", **tref})
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

        def request(g=dgen):
            rgb = torch.randn(B, H_IMG, W_IMG, 3, generator=g, device=dev)
            depth = torch.rand(B, H_IMG, W_IMG, 1, generator=g, device=dev) * 79 + 1
            valid = torch.rand(B, H_IMG, W_IMG, 1, generator=g, device=dev) < 0.3
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
        expect = {k: 0 for k in port.LAUNCHES}
        expect.update({"conv_link": 6 * STEPS * n_req, "ddim_step": STEPS * n_req,
                       "window_attention": sum(SWIN_L["depths"]) * n_req})
        check(launches == expect, f"launch counts {launches} != {expect}")
        path_launches["serve"] = launches
        # where the time of one request goes: the program's spans
        # (diffusiondepth_tpu_torch/trace.py) over one request under
        # torch.profiler, device ms summed by span name (the sampler's steps
        # over all steps), the request's host ms and host-to-card copies
        def request_parts(step, batch, g):
            from torch.profiler import ProfilerActivity, profile

            from diffusiondepth_tpu_torch import trace

            with profile(activities=[ProfilerActivity.CUDA]):
                step(batch, generator=g)
                sync()
            parts = {}
            for s in trace.spans():
                parts[f"{s.name}_ms"] = parts.get(f"{s.name}_ms", 0.0) + s.device_ms
                if s.name == "request":
                    parts["request_host_ms"] = s.host_ms
                    parts["h2d_copies"] = s.counters["h2d_copies"]
            return parts

        emit({"phase": "breakdown", "request": "bs8 352x1216, 20 steps",
              **request_parts(step, batches[0], dgen)})

        emit({"phase": "serve", "config": "Diffusion_DCbase_ swin_large_naive_l4w722422k "
              "DDIMDepthEstimate_Swin_ADDHAHI O1", "batch": B, "image": [H_IMG, W_IMG],
              "steps": STEPS, "params": n_params, "build_s": build_s, "warmup_s": warm_s,
              "latency_ms": lat_ms, "frames_per_s": B * n_req / (sum(lat_ms) / 1e3),
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "metric_names": ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"],
              "metric_rows": rows, "launches": launches, "expected_launches": expect})
        sync()

        # ---- 5b. the same model and batches with use_pallas: K8 in every block
        state = model.state_dict()
        pcfg = dataclasses.replace(cfg, use_pallas=True)
        pmodel = port.build_model(pcfg)
        pmodel.load_state_dict(state)
        pstep = port.make_eval_step(pmodel)
        t0 = time.perf_counter()
        pstep(warm, generator=dgen)
        sync()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        port.reset_launch_counts()
        plat_ms = []
        for batch in batches:
            t0 = time.perf_counter()
            pred, met, _ = pstep(batch, generator=dgen)
            sync()
            plat_ms.append(1e3 * (time.perf_counter() - t0))
            check(tuple(pred.shape) == (B, H_IMG, W_IMG, 1) and bool(torch.isfinite(pred).all())
                  and bool(torch.isfinite(met).all()), "serve-pallas: pred or metrics not finite")
        p_launches = dict(port.LAUNCHES)
        p_expect = {k: 0 for k in port.LAUNCHES}
        p_expect.update({"conv_link": 6 * STEPS * n_req, "ddim_step": STEPS * n_req,
                         "window_attention_split": sum(SWIN_L["depths"]) * n_req})
        check(p_launches == p_expect, f"serve-pallas launch counts {p_launches} != {p_expect}")
        path_launches["serve-pallas"] = p_launches
        p_peak = torch.cuda.max_memory_allocated() / 1e9
        # the same math on both routes: each pyramid level of the default
        # model within 1e-2 of the level's largest value (pred is not
        # compared: random bf16 weights make it chaotic)
        with torch.no_grad():
            fp_d = model.depth_backbone(batches[0]["rgb"])
            fp_p = pmodel.depth_backbone(batches[0]["rgb"])
        pyr = [((a.float() - b_.float()).abs().max() / b_.float().abs().max()).item()
               for a, b_ in zip(fp_p, fp_d)]
        check(all(math.isfinite(e) and e <= 1e-2 for e in pyr), f"serve-pallas pyramid: {pyr}")
        emit({"phase": "serve-pallas", "config": "serve config with use_pallas",
              "warmup_s": warm_s, "latency_ms": plat_ms,
              "frames_per_s": B * n_req / (sum(plat_ms) / 1e3), "max_memory_allocated_gb": p_peak,
              "pyramid_rel_diff_vs_default": pyr, "launches": p_launches,
              "expected_launches": p_expect})
        del pmodel, pstep, fp_d, fp_p
        sync()

        # ---- 5c. the leaderboard protocol: 50 steps, flip-TTA, the same weights
        lb_steps = 50
        lcfg = dataclasses.replace(cfg, inference_steps=lb_steps, tta_flip=True)
        lmodel = port.build_model(lcfg)
        lmodel.load_state_dict(state)
        lstep = port.make_eval_step(lmodel, tta_flip=lcfg.tta_flip)
        t0 = time.perf_counter()
        lstep(warm, generator=dgen)
        sync()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        l_ms, l_rows = [], []
        l_expect = {k: 0 for k in port.LAUNCHES}
        l_expect.update({"conv_link": 6 * lb_steps, "ddim_step": lb_steps,
                         "window_attention": sum(SWIN_L["depths"])})
        for batch in batches[:2]:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            pred, met, _ = lstep(batch, generator=dgen)
            sync()
            l_ms.append(1e3 * (time.perf_counter() - t0))
            l_launches = dict(port.LAUNCHES)
            check(l_launches == l_expect, f"leaderboard launch counts {l_launches} != {l_expect}")
            check(tuple(pred.shape) == (B, H_IMG, W_IMG, 1) and bool(torch.isfinite(pred).all())
                  and bool(torch.isfinite(met).all()), "leaderboard: pred or metrics not finite")
            l_rows.append(met[0].tolist())
        emit({"phase": "leaderboard", "config": "serve config, 50 steps, flip-TTA",
              "batch": B, "batch_after_flip": 2 * B, "image": [H_IMG, W_IMG], "steps": lb_steps,
              "warmup_s": warm_s, "latency_ms": l_ms,
              "frames_per_s": B * len(l_ms) / (sum(l_ms) / 1e3),
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "metric_rows": l_rows, "launches_per_request": l_launches,
              "expected_launches": l_expect})
        del lmodel, lstep, state, model, step, batches, warm
        sync()

        # ---- 6. train the flagship configuration
        tcfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                           backbone_name="swin_large_naive_l4w722422k",
                           head_specify="DDIMDepthEstimate_Swin_ADDHAHI",
                           inference_steps=STEPS, opt_level="O1", batch_size=B_T,
                           accum_steps=ACCUM, patch_height=H_T, patch_width=W_T,
                           max_depth=88.0, seed=7240).finalize()
        t0 = time.perf_counter()
        model = port.build_model(tcfg)
        optimizer = port.make_optimizer(tcfg, 100, model)
        lc = port.LossComputer(tcfg)
        step = port.make_train_step(model, lc, optimizer, accum_steps=tcfg.accum_steps)
        sync()
        build_s = time.perf_counter() - t0
        tgen = torch.Generator(device=dev).manual_seed(tcfg.seed)

        def train_batch(g=tgen, w=W_T):
            gt = (torch.rand(B_T, H_T, w, 1, generator=g, device=dev) * 80).clamp(0, 88)
            return {"rgb": torch.randn(B_T, H_T, w, 3, generator=g, device=dev), "gt": gt}

        t0 = time.perf_counter()
        step(train_batch(), generator=tgen)
        sync()
        warm_s = time.perf_counter() - t0
        n_steps = 3
        batches = [train_batch() for _ in range(n_steps)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        # per step, 2 micro-batches of: the sampler's 20 steps (6 K1 + K2
        # forward; 6 K1 recomputed + K6 + 6 K5 backward), the ddim_loss
        # denoiser call (6 K1 forward; 6 K1 recomputed + 6 K5 backward), and
        # 24 Swin blocks (K4 forward and again in the rematerialised
        # backward, K7 backward)
        n_blk = sum(SWIN_L["depths"])
        t_expect = {"conv_link": ACCUM * 2 * 6 * (STEPS + 1), "ddim_step": 0,
                    "window_attention": ACCUM * 2 * n_blk, "sched_step": ACCUM * STEPS,
                    "conv_link_bwd": ACCUM * 6 * (STEPS + 1), "sched_bwd": ACCUM * STEPS,
                    "window_attention_bwd": ACCUM * n_blk}
        t_expect.update({k: 0 for k in port.LAUNCHES if k not in t_expect})
        step_ms, terms = [], []
        for batch in batches:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            loss, loss_val, met = step(batch, generator=tgen)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            t_launches = dict(port.LAUNCHES)
            check(t_launches == t_expect, f"train launch counts {t_launches} != {t_expect}")
            terms.append(loss_val[0].tolist())
            check(bool(torch.isfinite(loss_val).all()) and bool(torch.isfinite(met).all()),
                  f"train step not finite: {loss_val} {met}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        groups = {"denoiser": ("depth_head.model.noise_embedding", "depth_head.model.pred",
                               "depth_head.model.upsample_add"),
                  "timestep_embedding": ("depth_head.model.time_embedding",),
                  "neck": ("depth_head.hahineck.",),
                  "fpn": ("depth_head.conv_lateral.", "depth_head.conv_up."),
                  "depth_transform_decoder": ("depth_head.depth_transform.conv_inv_transform",),
                  "backbone": ("depth_backbone.",)}
        gsum = {g: 0.0 for g in groups}
        n_grads = 0
        for n_, p in model.named_parameters():
            if p.grad is None:
                continue
            n_grads += 1
            check(bool(torch.isfinite(p.grad).all()), f"non-finite gradient in {n_}")
            for g, prefixes in groups.items():
                if n_.startswith(prefixes):
                    gsum[g] += p.grad.abs().sum().item()
        check(all(v > 0 for v in gsum.values()), f"zero gradients in a part: {gsum}")
        emit({"phase": "train", "config": "Diffusion_DCbase_ swin_large_naive_l4w722422k "
              "DDIMDepthEstimate_Swin_ADDHAHI O1 1.0*L1+1.0*L2+1.0*DDIM ADAM",
              "global_batch": B_T, "accum_steps": ACCUM, "crop": [H_T, W_T], "steps": STEPS,
              "build_s": build_s, "warmup_s": warm_s, "step_ms": step_ms,
              "samples_per_s": B_T * n_steps / (sum(step_ms) / 1e3),
              "max_memory_allocated_gb": peak_gb, "loss_names": get_loss_names(tcfg),
              "loss_rows": terms, "params_with_grad": n_grads, "grad_abs_sum": gsum,
              "launches_per_step": t_launches, "expected_launches": t_expect})
        path_launches["train"] = t_launches

        # where the time of one training step goes, device time by part
        def train_parts(model, optimizer, lc, batch, g):
            tparts = {k: 0.0 for k in ("backbone_fwd_ms", "head_fwd_ms", "sampler_ms",
                                       "ddim_loss_and_decode_ms", "backward_ms",
                                       "optimizer_ms")}

            def tpart(name, fn):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                sync()
                tparts[name] += start.elapsed_time(end)
                return out

            head = model.depth_head
            model.train()
            optimizer.zero_grad(set_to_none=True)
            mbs = B_T // ACCUM
            for i in range(ACCUM):
                mb = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                fp = tpart("backbone_fwd_ms", lambda: model.depth_backbone(mb["rgb"], generator=g))

                def head_fwd():
                    gt_t = head.depth_transform.t(mb["gt"])
                    return gt_t, head.model.upsample_condition(
                        head.fpn_condition(head.hahineck(fp, generator=g) if head.use_hahi
                                           else fp), gt_t.shape[1:3])

                gt_t, cond = tpart("head_fwd_ms", head_fwd)
                lat = tpart("sampler_ms", lambda: head._sample(
                    cond, (mbs, gt_t.shape[1], gt_t.shape[2], 16), g)[0])
                loss = tpart("ddim_loss_and_decode_ms", lambda: lc(mb, {
                    "pred": head.depth_transform.inv_t(lat),
                    "ddim_loss": head._ddim_loss(lat, cond, g)})[0])
                tpart("backward_ms", loss.backward)
                del fp, gt_t, cond, lat, loss

            def opt_step():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(B_T)
                optimizer.step()

            tpart("optimizer_ms", opt_step)
            return {**tparts, "sum_ms": sum(tparts.values())}

        emit({"phase": "train_breakdown", "step": "global batch 8 = 2 x 4, 352x906, 20 steps",
              **train_parts(model, optimizer, lc, batches[0], tgen)})
        del model, optimizer, step, batches, batch
        sync()

        # ---- 6b. HAHI's deformable attentions on: swin_micro + the flagship
        # head rebuilt with both attentions (4 steps, f32, TF32 off), card
        # against CPU on pred and one training step; the encoder and the
        # pixel decoder at micro size
        t_phase = time.perf_counter()
        cpu = torch.device("cpu")

        def att_cfg(opt):
            return dataclasses.replace(micro_cfg(opt), inference_steps=4)

        def att_build(cfg_, device=None):
            m = attention_model(port, torch, cfg_, device)
            randomize_msda(torch, m, 11)
            return m

        gm = att_build(att_cfg("O0"))
        cm = att_build(att_cfg("O0"), "cpu")
        cm.load_state_dict(gm.state_dict())
        lat4 = torch.randn(2, 32, 48, 16, generator=torch.Generator().manual_seed(5))
        preds = []
        for m, d in ((gm, dev), (cm, cpu)):
            pred, met, _ = port.make_eval_step(m)({"rgb": rgb.to(d), "gt": gt.to(d)},
                                                  init_latent=lat4.to(d))
            check(bool(torch.isfinite(pred).all()) and bool(torch.isfinite(met).all()),
                  f"hahi-att micro eval not finite on {d}")
            preds.append(pred.float().cpu())
        # the CPU parity test's tolerance against JAX (f32, sums in another order)
        pred_ok = torch.allclose(preds[0], preds[1], rtol=1e-3, atol=1e-3)
        pred_err = ((preds[0] - preds[1]).abs().max() / preds[1].abs().max()).item()
        check(pred_ok, f"hahi-att micro pred: card vs CPU rel err {pred_err}")
        del gm, cm
        att_train = micro_train(att_cfg, "O0", train_tols[0][1], build=att_build)
        # the transformer modules: card against CPU, f32, eval
        tgen_c = torch.Generator().manual_seed(6)
        feats = [torch.randn(2, 8 >> i, 12 >> i, 64, generator=tgen_c) for i in range(3)]
        mems = [torch.randn(2, 4 >> i, 6 >> i, 32, generator=tgen_c) for i in range(2)]
        maskf = torch.randn(2, 16, 24, 32, generator=tgen_c)
        tr_err = {}
        for tname, make, inputs in (
                ("PureMSDEnTransformer", lambda: PureMSDEnTransformer(
                    2, 64, 4, pe_num_feats=32, num_levels=3), (feats,)),
                ("PixelTransformerDecoder classify", lambda: PixelTransformerDecoder(
                    32, 3, 2, 16, 4, True, 10, 16), (mems, maskf)),
                ("PixelTransformerDecoder", lambda: PixelTransformerDecoder(
                    32, 3, 2, 16, 4, False, 10, 16), (mems, maskf))):
            torch.manual_seed(7)
            c_mod = make()
            randomize_msda(torch, c_mod, 8)
            g_mod = make().to(dev)
            g_mod.load_state_dict(c_mod.state_dict())
            with torch.no_grad():
                outs = [c_mod.eval()(*inputs),
                        g_mod.eval()(*[[t.to(dev) for t in a] if isinstance(a, list)
                                       else a.to(dev) for a in inputs])]
            flat = [[t.float().cpu() for t in o if t is not None] for o in outs]
            tr_err[tname] = [((a - b_).abs().max() / b_.abs().max()).item()
                             for a, b_ in zip(flat[1], flat[0])]
            check(len(flat[0]) == len(flat[1]) and all(e <= 1e-4 for e in tr_err[tname]),
                  f"{tname}: card vs CPU {tr_err[tname]}")
        emit({"phase": "reference (hahi-att)", "what": "swin_micro + DDIMDepthEstimate_Swin_"
              "ADDHAHI with hahi_self_att and hahi_cross_att, 2 x 64x96, 4 steps, fixed latent, "
              "f32 (TF32 off), card vs CPU; one training step; the encoder and the pixel "
              "decoder (classify on and off)", "pred_rel_err": pred_err,
              "pred_tol": {"rtol": 1e-3, "atol": 1e-3}, "train": att_train,
              "transformer_rel_err": tr_err, "transformer_tol": 1e-4,
              "seconds": time.perf_counter() - t_phase})
        sync()

        @contextlib.contextmanager
        def attention_timers(neck):
            """CUDA events around each call of the neck's self- and
            cross-attention while the block runs; the yielded dict reads
            their device ms once the block has synchronised."""
            evs = {"self_attention_ms": [], "cross_attention_ms": []}

            def timed(key, fn):
                def run(*a, **k):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*a, **k)
                    end.record()
                    evs[key].append((start, end))
                    return out
                return run

            neck.self_attention = timed("self_attention_ms", neck.self_attention)
            neck.cross_attention = timed("cross_attention_ms", neck.cross_attention)
            times = {}
            try:
                yield times
            finally:
                del neck.self_attention, neck.cross_attention
                sync()
                times.update({k: sum(s_.elapsed_time(e_) for s_, e_ in v)
                              for k, v in evs.items()})

        # ---- 6c. serve the flagship with both attentions on: the serve
        # configuration and batches of phase 5
        t_phase = t0 = time.perf_counter()
        amodel = attention_model(port, torch, cfg)
        astep = port.make_eval_step(amodel)
        a_params = sum(p.numel() for p in amodel.parameters())
        sync()
        build_s = time.perf_counter() - t0
        agen = torch.Generator(device=dev).manual_seed(cfg.seed)
        awarm = request(agen)
        sync()
        t0 = time.perf_counter()
        astep(awarm, generator=agen)
        sync()
        warm_s = time.perf_counter() - t0
        n_att = 3
        abatches = [request(agen) for _ in range(n_att)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        a_expect = {k: 0 for k in port.LAUNCHES}
        a_expect.update({"conv_link": 6 * STEPS, "ddim_step": STEPS, "window_attention": n_blk})
        a_ms, a_rows = [], []
        for batch in abatches:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            pred, met, _ = astep(batch, generator=agen)
            sync()
            a_ms.append(1e3 * (time.perf_counter() - t0))
            a_launches = dict(port.LAUNCHES)
            check(a_launches == a_expect, f"serve-hahi-att launch counts {a_launches} != "
                  f"{a_expect}")
            check(tuple(pred.shape) == (B, H_IMG, W_IMG, 1) and bool(torch.isfinite(pred).all())
                  and bool(torch.isfinite(met).all()), "serve-hahi-att: pred or metrics not finite")
            a_rows.append(met[0].tolist())
        a_peak = torch.cuda.max_memory_allocated() / 1e9
        path_launches["serve-hahi-att"] = a_launches

        # one request's device time by part, the neck split into its conv
        # path, self-attention and cross-attention
        head, neck = amodel.depth_head, amodel.depth_head.hahineck
        aparts = {}

        def apart(key, fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            sync()
            aparts[key] = start.elapsed_time(end)
            return out

        with torch.no_grad(), attention_timers(neck) as att_ms:
            fp = apart("backbone_ms", lambda: amodel.depth_backbone(abatches[0]["rgb"]))
            gt_t = apart("depth_encode_ms", lambda: head.depth_transform.t(abatches[0]["gt"]))
            nout = apart("neck_ms", lambda: neck(fp, generator=agen))
            cond = apart("fpn_upsample_ms", lambda: head.model.upsample_condition(
                head.fpn_condition(nout), gt_t.shape[1:3]))
            lat = apart("sampler_ms", lambda: head._sample(
                cond, (B, gt_t.shape[1], gt_t.shape[2], 16), agen)[0])
            apart("depth_decode_ms", lambda: head.depth_transform.inv_t(lat))
        request_ms = sum(aparts.values())
        aparts.update(att_ms)
        aparts["neck_conv_path_ms"] = (aparts["neck_ms"] - att_ms["self_attention_ms"]
                                       - att_ms["cross_attention_ms"])
        aparts["sum_ms"] = request_ms
        att_share = (att_ms["self_attention_ms"] + att_ms["cross_attention_ms"]) / request_ms
        with torch.no_grad():
            sampler_kernels = top_kernels(lambda: head._sample(
                cond, (B, gt_t.shape[1], gt_t.shape[2], 16), agen))
        del fp, nout, cond, lat

        # the MSDA core alone at the serve shapes (bf16 on the card): the
        # cross-attention's 26752 level-0 queries per image and the
        # self-attention's 8778 fused tokens, over the three fused levels;
        # bound: each input read once and the output written once, or 9
        # f32-rate operations per sampled channel (4 corner products, 3
        # adds, the weight's product and the sum over points)
        lv = [swin_stage_grid(H_IMG, W_IMG, st) for st in (1, 2, 3)]
        nv = sum(h_ * w_ for h_, w_ in lv)
        cg = torch.Generator(device=dev).manual_seed(9)
        core = {}
        for cname, nq in (("cross", (H_IMG // 4) * (W_IMG // 4)), ("self", nv)):
            value = torch.randn(B, nv, 8, 64, generator=cg, device=dev).to(bf)
            loc = torch.rand(B, nq, 8, 3, 8, 2, generator=cg, device=dev).to(bf)
            wts = (torch.rand(B, nq, 8, 3, 8, generator=cg, device=dev) / 24).to(bf)

            def core_fn():
                return ms_deform_attn(value, lv, loc, wts)

            with torch.no_grad():
                out = core_fn()
                check(out.dtype == bf and tuple(out.shape) == (B, nq, 512)
                      and bool(torch.isfinite(out).all()), f"MSDA core {cname}: {out.dtype}")
                n_pts = B * nq * 8 * 3 * 8
                nbytes = 2 * (value.numel() + loc.numel() + wts.numel() + out.numel())
                bms, by = bound(nbytes, 9.0 * n_pts * 64, F32_FLOPS)
                core[cname] = {"queries": nq, "points": n_pts, "ms": median_ms(core_fn, 5, 2),
                               "bound_ms": bms, "bound_by": by,
                               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
                if cname == "cross":
                    core[cname]["top_kernels"] = top_kernels(core_fn)
            del value, loc, wts, out
        emit({"phase": "serve-hahi-att", "config": "Diffusion_DCbase_ swin_large_naive_l4w722422k "
              "DDIMDepthEstimate_Swin_ADDHAHI(hahi_self_att, hahi_cross_att) O1",
              "batch": B, "image": [H_IMG, W_IMG], "steps": STEPS, "embed": 512, "heads": 8,
              "points": 8, "pe_num_feats": 256, "fused_tokens": nv,
              "level0_queries": (H_IMG // 4) * (W_IMG // 4), "params": a_params,
              "build_s": build_s, "warmup_s": warm_s, "latency_ms": a_ms,
              "frames_per_s": B * n_att / (sum(a_ms) / 1e3), "max_memory_allocated_gb": a_peak,
              "serve_latency_ms_attention_off": lat_ms, "metric_rows": a_rows,
              "launches_per_request": a_launches, "expected_launches": a_expect,
              "breakdown": aparts, "attention_share": att_share,
              "sampler_kernels": sampler_kernels, "msda_core": core,
              "seconds": time.perf_counter() - t_phase})
        del amodel, astep, abatches, awarm, batch, pred, met
        sync()

        # ---- 6d. train the flagship with both attentions on: the training
        # recipe of phase 6
        t_phase = t0 = time.perf_counter()
        model = attention_model(port, torch, tcfg)
        optimizer = port.make_optimizer(tcfg, 100, model)
        lc = port.LossComputer(tcfg)
        step = port.make_train_step(model, lc, optimizer, accum_steps=tcfg.accum_steps)
        sync()
        build_s = time.perf_counter() - t0
        ag = torch.Generator(device=dev).manual_seed(tcfg.seed)
        t0 = time.perf_counter()
        step(train_batch(ag), generator=ag)
        sync()
        warm_s = time.perf_counter() - t0
        batches = [train_batch(ag) for _ in range(2)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        step_ms, terms = [], []
        for batch in batches:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            loss, loss_val, met = step(batch, generator=ag)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            ta_launches = dict(port.LAUNCHES)
            check(ta_launches == t_expect, f"train-hahi-att launch counts {ta_launches} != "
                  f"{t_expect}")
            terms.append(loss_val[0].tolist())
            check(bool(torch.isfinite(loss_val).all()) and bool(torch.isfinite(met).all()),
                  f"train-hahi-att step not finite: {loss_val} {met}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hn = "depth_head.hahineck."
        att_leaves = [hn + "level_embed", hn + "reference_points_fc.weight"] + [
            f"{hn}{a}.{proj}.weight" for a in ("self_attn", "multi_att")
            for proj in ("value_proj", "sampling_offsets", "attention_weights", "output_proj")]
        params_ = dict(model.named_parameters())
        att_grads = {}
        for n_ in att_leaves:
            g_ = params_[n_].grad
            check(g_ is not None and bool(torch.isfinite(g_).all()), f"no finite gradient in {n_}")
            att_grads[n_[len(hn):]] = g_.abs().sum().item()
        check(all(v > 0 for v in att_grads.values()), f"zero attention gradients: {att_grads}")
        for n_, p in params_.items():
            check(p.grad is None or bool(torch.isfinite(p.grad).all()),
                  f"non-finite gradient in {n_}")
        path_launches["train-hahi-att"] = ta_launches
        with attention_timers(model.depth_head.hahineck) as att_ms:
            tparts = train_parts(model, optimizer, lc, batches[0], ag)
        tparts.update({"forward_" + k: v for k, v in att_ms.items()})
        emit({"phase": "train-hahi-att", "config": "Diffusion_DCbase_ swin_large_naive_l4w722422k "
              "DDIMDepthEstimate_Swin_ADDHAHI(hahi_self_att, hahi_cross_att) O1 "
              "1.0*L1+1.0*L2+1.0*DDIM ADAM", "global_batch": B_T, "accum_steps": ACCUM,
              "crop": [H_T, W_T], "steps": STEPS, "build_s": build_s, "warmup_s": warm_s,
              "step_ms": step_ms, "samples_per_s": B_T * len(step_ms) / (sum(step_ms) / 1e3),
              "max_memory_allocated_gb": peak_gb, "loss_names": get_loss_names(tcfg),
              "loss_rows": terms, "attention_grad_abs_sum": att_grads,
              "launches_per_step": ta_launches, "expected_launches": t_expect,
              "breakdown": tparts, "seconds": time.perf_counter() - t_phase})
        del model, optimizer, step, batches, batch
        sync()

        # ---- 7. LayerNorm(dtype=bf16) through LayerNormBF16, card vs CPU:
        # the largest Swin-L norm, the same from a view one element into its
        # storage (LayerNormBF16 copies it to 16 bytes), and an odd C from
        # such a view (K10 stages its rows); exactly one K9 and one K10
        # launch each
        gen_cpu = torch.Generator().manual_seed(4)
        port.reset_launch_counts()
        ln_cases = []
        for m, c, offset in (ln_shape + (0,), ln_shape + (1,), (777, 7, 1)):
            mods = [LayerNorm(c, dtype=bf) for _ in range(2)]
            with torch.no_grad():
                mods[0].weight.copy_(1.0 + 0.2 * torch.randn(c, generator=gen_cpu))
                mods[0].bias.copy_(0.1 * torch.randn(c, generator=gen_cpu))
            mods[1].load_state_dict(mods[0].state_dict())
            mods[0].to(dev)
            x_cpu = (2.0 * torch.randn(m, c, generator=gen_cpu) + 0.5).to(bf)
            dy_cpu = torch.randn(m, c, generator=gen_cpu).to(bf)
            res = []
            for mod, d in zip(mods, (dev, torch.device("cpu"))):
                store = torch.zeros(m * c + offset, dtype=bf, device=d)
                store[offset:] = x_cpu.reshape(-1).to(d)
                store.requires_grad_()
                xg = store[offset:].view(m, c)
                if d.type == "cuda":
                    check((xg.data_ptr() % 16 != 0) == bool(offset), "layernorm view offset")
                    n0 = dict(port.LAUNCHES)
                y = mod(xg)
                y.backward(dy_cpu.to(d))
                if d.type == "cuda":
                    sync()
                    case_launches = {k: port.LAUNCHES[k] - n0[k] for k in port.LAUNCHES}
                res.append([t.float().cpu() for t in (y.detach(), store.grad[offset:].view(m, c),
                                                       mod.weight.grad, mod.bias.grad)])
            ln_expect = {k: 0 for k in port.LAUNCHES}
            ln_expect.update({"layernorm_fwd": 1, "layernorm_bwd": 1})
            check(case_launches == ln_expect,
                  f"layernorm ({m}, {c}) offset {offset}: launch counts {case_launches}")
            # y and dx in bf16: one bf16 step; dweight, dbias: f32 sums over
            # all rows in another order
            ln_tol = {"y": 1e-2, "dx": 1e-2, "dweight": 1e-3, "dbias": 1e-3}
            ln_err = {k: ((a - b_).abs().max() / b_.abs().max()).item()
                      for k, a, b_ in zip(ln_tol, *res)}
            check(all(math.isfinite(ln_err[k]) and ln_err[k] <= ln_tol[k] for k in ln_tol),
                  f"layernorm module ({m}, {c}) offset {offset}: {ln_err}")
            ln_cases.append({"shape": [m, c], "offset_elements": offset, "rel_err": ln_err,
                             "launches": {k: v for k, v in case_launches.items() if v}})
            del mods, res
        ln_launches = dict(port.LAUNCHES)
        path_launches["layernorm"] = ln_launches
        emit({"phase": "layernorm", "what": "LayerNorm(C, dtype=bf16) forward + backward, "
              "card vs CPU plain versions", "tol": ln_tol, "cases": ln_cases,
              "launches": ln_launches})
        sync()

        # ---- 8. the ResNet and MPViT families at the micro shapes: card
        # against the same weights on the CPU, module by module from the
        # CPU's inputs (the backbone's stages, then neck + FPN + upsample and
        # one denoiser call), and one training step
        fam_micro = {
            "mmbev_res18 + DDIMDepthEstimate_Res": dict(
                backbone_module="mmbev_resnet", backbone_name="mmbev_res18",
                head_specify="DDIMDepthEstimate_Res"),
            "mpvit_tiny + DDIMDepthEstimate_MPVIT_ADDHAHI": dict(
                backbone_module="mpvit", backbone_name="mpvit_tiny",
                head_specify="DDIMDepthEstimate_MPVIT_ADDHAHI",
                head_in_channels="96,176,216,216"),
        }

        def backbone_calls(bb):
            """The backbone as a chain of calls, each on the one before's
            output: ResNet's four layers, or MPViT's stem and four stages.
            The last four outputs are the pyramid."""
            if hasattr(bb, "layers"):
                return list(bb.layers)
            return [lambda x: bb.stem[1](bb.stem[0](x))] + [
                functools.partial(bb.stage, s_) for s_ in range(len(bb.mhca_stages))]

        def rel(a, b_):
            return ((a.float().cpu() - b_.float()).abs().max() / b_.float().abs().max()).item()

        t0 = time.perf_counter()
        for fname, fkw in fam_micro.items():
            def fam_cfg(opt, fkw=fkw):
                return port.Config(model_name="Diffusion_DCbase_", inference_steps=2,
                                   opt_level=opt, **fkw).finalize()

            fref = {}
            for opt, tol in (("O0", 1e-3), ("O1", 2e-2)):
                gpu_m = port.build_model(fam_cfg(opt))
                cpu_m = port.build_model(fam_cfg(opt), device="cpu")
                cpu_m.load_state_dict(gpu_m.state_dict())
                errs = {}
                with torch.no_grad():
                    x = rgb
                    chain = []
                    for i, (c_call, g_call) in enumerate(zip(
                            backbone_calls(cpu_m.depth_backbone),
                            backbone_calls(gpu_m.depth_backbone))):
                        y = c_call(x)
                        errs[f"backbone{i}"] = rel(g_call(x.to(dev)), y)
                        chain.append(y)
                        x = y
                    fp = chain[-4:]
                    conds = []
                    for m, d in ((gpu_m, dev), (cpu_m, torch.device("cpu"))):
                        head = m.depth_head
                        fp_d = [f.to(d) for f in fp]
                        gt_t = head.depth_transform.t(gt.to(d))
                        conds.append(head.model.upsample_condition(head.fpn_condition(
                            head.hahineck(fp_d) if head.use_hahi else fp_d), gt_t.shape[1:3]))
                    errs["condition"] = rel(*conds)
                    lat = torch.randn(2, 32, 48, 16, generator=torch.Generator().manual_seed(2))
                    eps = [m.depth_head.model(lat.to(d), 500, conds[1].to(d))
                           for m, d in ((gpu_m, dev), (cpu_m, torch.device("cpu")))]
                    errs["denoiser"] = rel(*eps)
                fref[opt] = {"rel_err": errs, "tol": tol,
                             "fused_chain": gpu_m.depth_head.model.fused_active(32)}
                check(all(math.isfinite(e) and e <= tol for e in errs.values()),
                      f"reference {fname} {opt}: {errs}")
                del gpu_m, cpu_m
            # bf16: these gradients are less well conditioned than the
            # flagship's (a leaf of res18 moved by 0.32 between card and CPU,
            # median 0.016), so a leaf may also sit within twice the CPU's
            # own bf16-to-f32 distance
            fref["train"] = {opt: micro_train(fam_cfg, opt, tol, calibrate=opt != "O0")
                             for opt, tol in train_tols}
            emit({"phase": "reference", "what": f"{fname}, card vs CPU plain: backbone "
                  "stages, condition map and one denoiser call from the CPU's inputs; one "
                  "training step (loss, per-leaf gradient RMS distance)", **fref})
        emit({"phase": "reference", "what": "families", "seconds": time.perf_counter() - t0})
        sync()

        # ---- 9. serve bench.py's res50 and mpvit_small cells: bs8 352x1216,
        # 20 steps, bf16, weights from the seed
        def serve_cell(phase, bb_module, bb_name, head_name, expect, breakdown,
                       model_name="Diffusion_DCbase_"):
            """Serve one bench.py cell; ``breakdown`` names the part ("backbone"
            or "sampler") whose kernels are listed by device time."""
            t_phase = t0 = time.perf_counter()
            scfg = port.Config(model_name=model_name, backbone_module=bb_module,
                               backbone_name=bb_name, head_specify=head_name,
                               inference_steps=STEPS, opt_level="O1", seed=7240).finalize()
            smodel = port.build_model(scfg)
            sstep = port.make_eval_step(smodel)
            n_p = sum(p.numel() for p in smodel.parameters())
            sync()
            build_s = time.perf_counter() - t0
            sgen = torch.Generator(device=dev).manual_seed(scfg.seed)
            warm = request(sgen)
            sync()
            t0 = time.perf_counter()
            sstep(warm, generator=sgen)
            sync()
            warm_s = time.perf_counter() - t0
            sbatches = [request(sgen) for _ in range(n_req)]
            sync()
            torch.cuda.reset_peak_memory_stats()
            s_ms, s_rows = [], []
            full = {k: 0 for k in port.LAUNCHES}
            full.update(expect)
            for batch in sbatches:
                port.reset_launch_counts()
                t0 = time.perf_counter()
                pred, met, _ = sstep(batch, generator=sgen)
                sync()
                s_ms.append(1e3 * (time.perf_counter() - t0))
                s_launches = dict(port.LAUNCHES)
                check(s_launches == full, f"{phase} launch counts {s_launches} != {full}")
                check(tuple(pred.shape) == (B, H_IMG, W_IMG, 1) and bool(torch.isfinite(pred).all())
                      and bool(torch.isfinite(met).all()), f"{phase}: pred or metrics not finite")
                s_rows.append(met[0].tolist())
            s_peak = torch.cuda.max_memory_allocated() / 1e9
            rec = {"phase": phase, "config": f"{model_name} {bb_name} {head_name} O1",
                   "batch": B, "image": [H_IMG, W_IMG], "steps": STEPS, "params": n_p,
                   "build_s": build_s, "warmup_s": warm_s, "latency_ms": s_ms,
                   "frames_per_s": B * n_req / (sum(s_ms) / 1e3),
                   "max_memory_allocated_gb": s_peak, "metric_rows": s_rows,
                   "launches_per_request": s_launches, "expected_launches": full}
            rec["breakdown"] = request_parts(sstep, sbatches[0], sgen)
            # what the card runs for the part named by ``breakdown``
            with torch.no_grad():
                if breakdown == "backbone":
                    rec["backbone_kernels"] = top_kernels(
                        lambda: smodel.depth_backbone(sbatches[0]["rgb"]))
                else:
                    h = smodel.depth_head
                    lh, lw = h.depth_transform.t(sbatches[0]["gt"]).shape[1:3]
                    cond = torch.randn(B, lh, lw, 256, generator=sgen, device=dev).to(bf)
                    rec["sampler_kernels"] = top_kernels(lambda: h._sample(
                        cond, (B, lh, lw, 16), sgen))
            rec["seconds"] = time.perf_counter() - t_phase
            emit(rec)
            del smodel, sstep, sbatches, warm
            sync()
            return s_launches

        path_launches["serve-res50"] = serve_cell(
            "serve-res50", "mmbev_resnet", "mmbev_res50", "DDIMDepthEstimate_Res", {}, "sampler")
        path_launches["serve-mpvit_small"] = serve_cell(
            "serve-mpvit_small", "mpvit", "mpvit_small", "DDIMDepthEstimate_MPVIT_ADDHAHI",
            {"conv_link": 6 * STEPS, "ddim_step": STEPS}, "backbone")

        # ---- 10. train mpvit_small with the flagship recipe
        mcfg = dataclasses.replace(tcfg, backbone_module="mpvit", backbone_name="mpvit_small",
                                   head_specify="DDIMDepthEstimate_MPVIT_ADDHAHI")
        t_phase = t0 = time.perf_counter()
        model = port.build_model(mcfg)
        optimizer = port.make_optimizer(mcfg, 100, model)
        lc = port.LossComputer(mcfg)
        step = port.make_train_step(model, lc, optimizer, accum_steps=mcfg.accum_steps)
        sync()
        build_s = time.perf_counter() - t0
        mgen = torch.Generator(device=dev).manual_seed(mcfg.seed)
        stats_before = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
        t0 = time.perf_counter()
        step(train_batch(mgen), generator=mgen)
        sync()
        warm_s = time.perf_counter() - t0
        batches = [train_batch(mgen) for _ in range(2)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        m_expect = dict(t_expect, window_attention=0, window_attention_bwd=0)
        step_ms, terms = [], []
        for batch in batches:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            loss, loss_val, met = step(batch, generator=mgen)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            m_launches = dict(port.LAUNCHES)
            check(m_launches == m_expect, f"train-mpvit_small launch counts {m_launches} != "
                  f"{m_expect}")
            terms.append(loss_val[0].tolist())
            check(bool(torch.isfinite(loss_val).all()) and bool(torch.isfinite(met).all()),
                  f"train-mpvit_small step not finite: {loss_val} {met}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        m_groups = {"denoiser": ("depth_head.model.noise_embedding", "depth_head.model.pred",
                                 "depth_head.model.upsample_add"),
                    "neck": ("depth_head.hahineck.",),
                    "fpn": ("depth_head.conv_lateral.", "depth_head.conv_up."),
                    "backbone": ("depth_backbone.",)}
        gsum = {g_: 0.0 for g_ in m_groups}
        for n_, p in model.named_parameters():
            if p.grad is None:
                continue
            check(bool(torch.isfinite(p.grad).all()), f"non-finite gradient in {n_}")
            for g_, prefixes in m_groups.items():
                if n_.startswith(prefixes):
                    gsum[g_] += p.grad.abs().sum().item()
        check(all(v > 0 for v in gsum.values()), f"zero gradients in a part: {gsum}")
        # norm_eval: every BatchNorm statistic of the backbone bit-unchanged
        # after 3 steps; the head's moved
        bb_same = all(torch.equal(b_, stats_before[n]) for n, b_ in model.named_buffers()
                      if n.startswith("depth_backbone.") and "running" in n)
        head_moved = sum(not torch.equal(b_, stats_before[n]) for n, b_ in model.named_buffers()
                         if n.startswith("depth_head.") and "running" in n)
        n_head = sum(1 for n in stats_before if n.startswith("depth_head."))
        check(bb_same and head_moved == n_head,
              f"BatchNorm statistics: backbone unchanged {bb_same}, head moved "
              f"{head_moved} of {n_head}")
        emit({"phase": "train-mpvit_small", "config": "Diffusion_DCbase_ mpvit_small "
              "DDIMDepthEstimate_MPVIT_ADDHAHI O1 1.0*L1+1.0*L2+1.0*DDIM ADAM",
              "global_batch": B_T, "accum_steps": ACCUM, "crop": [H_T, W_T], "steps": STEPS,
              "build_s": build_s, "warmup_s": warm_s, "step_ms": step_ms,
              "samples_per_s": B_T * len(step_ms) / (sum(step_ms) / 1e3),
              "max_memory_allocated_gb": peak_gb, "loss_rows": terms, "grad_abs_sum": gsum,
              "backbone_bn_unchanged": bb_same, "head_bn_moved": [head_moved, n_head],
              "launches_per_step": m_launches, "expected_launches": m_expect,
              "breakdown": train_parts(model, optimizer, lc, batches[0], mgen),
              "seconds": time.perf_counter() - t_phase})
        path_launches["train-mpvit_small"] = m_launches
        del model, optimizer, step, batches, batch
        sync()

        # ---- 11. the runtime: train, evaluate and resume the flagship
        # through main on a KITTI-DC tree written with the port's PNG writer
        # per eval batch at 20 steps: 6 K1 + K3 per step, one K4 per Swin block
        path_launches["cli"] = cli_phase(port, torch, dev, t_expect, {
            "conv_link": 6 * STEPS, "ddim_step": STEPS,
            "window_attention": sum(SWIN_L["depths"])})

        # ---- 12-15. NLSPN, the CLI's default model
        path_launches.update(nlspn_phases(port, torch, dev))

        # ---- 16. the CLI's default run: NLSPN on NYUv2
        path_launches["cli-nyu"] = cli_nyu_phase(port, torch, dev)
        check(path_launches["cli-nyu"] == {k: 0 for k in port.LAUNCHES},
              "cli-nyu launched a kernel")

        # ---- 17. the X4 model and the concat head at the micro shapes, card
        # against CPU: pyramid, condition map at the latent, one denoiser
        # call; one training step (the X4 latent is a quarter of the image:
        # the corner of the flagship's draws)
        t0 = time.perf_counter()
        for mname, hname, hw in (("Diffusion_DCx4base_", "DDIMDepthEstimate_Swin_ADDHAHI", 4),
                                 ("Diffusion_DCbase_", "DDIMDepthEstimate_Swin", 2)):
            cfg_of = functools.partial(micro_cfg, model_name=mname, head=hname)
            rec = micro_reference(cfg_of)
            # bf16: a leaf may also sit within twice the CPU's own
            # bf16-to-f32 distance, as the families' steps are held
            rec["train"] = {opt: micro_train(cfg_of, opt, tol, calibrate=opt != "O0",
                                             lat=lat0[:, :64 // hw, :96 // hw].contiguous(),
                                             nz=noise[:, :64 // hw, :96 // hw].contiguous())
                            for opt, tol in train_tols}
            emit({"phase": "reference (x4, bins)", "what": f"{mname} swin_micro + {hname}, "
                  "card vs CPU plain; outputs: 4 pyramid levels, condition map, one denoiser "
                  "call; one training step (loss, per-leaf gradient RMS distance)", **rec})
        emit({"phase": "reference (x4, bins)", "seconds": time.perf_counter() - t0})
        sync()

        # ---- 18. serve the X4 model (a quarter-resolution latent: K1 and K3
        # at (8, 88, 304)) and 19. the concat head (its denoiser on cuDNN)
        path_launches["serve-x4"] = serve_cell(
            "serve-x4", "swin", "swin_large_naive_l4w722422k", "DDIMDepthEstimate_Swin_ADDHAHI",
            {"conv_link": 6 * STEPS, "ddim_step": STEPS, "window_attention": n_blk}, "sampler",
            model_name="Diffusion_DCx4base_")
        path_launches["serve-bins"] = serve_cell(
            "serve-bins", "swin", "swin_large_naive_l4w722422k", "DDIMDepthEstimate_Swin",
            {"window_attention": n_blk}, "sampler")

        # ---- 20. train the X4 model with the flagship recipe on 352x904 crops
        xcfg = dataclasses.replace(tcfg, model_name="Diffusion_DCx4base_", patch_width=W_X4T)
        t_phase = t0 = time.perf_counter()
        model = port.build_model(xcfg)
        optimizer = port.make_optimizer(xcfg, 100, model)
        lc = port.LossComputer(xcfg)
        step = port.make_train_step(model, lc, optimizer, accum_steps=xcfg.accum_steps)
        sync()
        build_s = time.perf_counter() - t0
        xgen = torch.Generator(device=dev).manual_seed(xcfg.seed)
        t0 = time.perf_counter()
        step(train_batch(xgen, W_X4T), generator=xgen)
        sync()
        warm_s = time.perf_counter() - t0
        batches = [train_batch(xgen, W_X4T) for _ in range(2)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        step_ms, terms = [], []
        for batch in batches:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            loss, loss_val, met = step(batch, generator=xgen)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            x_launches = dict(port.LAUNCHES)
            check(x_launches == t_expect, f"train-x4 launch counts {x_launches} != {t_expect}")
            terms.append(loss_val[0].tolist())
            check(bool(torch.isfinite(loss_val).all()) and bool(torch.isfinite(met).all()),
                  f"train-x4 step not finite: {loss_val} {met}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dt = "depth_head.depth_transform.conv_inv_transform."
        x_groups = {"denoiser": ("depth_head.model.noise_embedding", "depth_head.model.pred",
                                 "depth_head.model.upsample_add"),
                    "neck": ("depth_head.hahineck.",),
                    "fpn": ("depth_head.conv_lateral.", "depth_head.conv_up."),
                    "backbone": ("depth_backbone.",),
                    "x4_deconv1": (dt + "0.",), "x4_deconv2": (dt + "1.", dt + "2."),
                    "x4_out_conv": (dt + "4.",)}
        gsum = {g_: 0.0 for g_ in x_groups}
        for n_, p in model.named_parameters():
            if p.grad is None:
                continue
            check(bool(torch.isfinite(p.grad).all()), f"non-finite gradient in {n_}")
            for g_, prefixes in x_groups.items():
                if n_.startswith(prefixes):
                    gsum[g_] += p.grad.abs().sum().item()
        check(all(v > 0 for v in gsum.values()), f"train-x4: zero gradients in a part: {gsum}")
        emit({"phase": "train-x4", "config": "Diffusion_DCx4base_ swin_large_naive_l4w722422k "
              "DDIMDepthEstimate_Swin_ADDHAHI O1 1.0*L1+1.0*L2+1.0*DDIM ADAM",
              "global_batch": B_T, "accum_steps": ACCUM, "crop": [H_T, W_X4T], "steps": STEPS,
              "build_s": build_s, "warmup_s": warm_s, "step_ms": step_ms,
              "samples_per_s": B_T * len(step_ms) / (sum(step_ms) / 1e3),
              "max_memory_allocated_gb": peak_gb, "loss_rows": terms, "grad_abs_sum": gsum,
              "launches_per_step": x_launches, "expected_launches": t_expect,
              "breakdown": train_parts(model, optimizer, lc, batches[0], xgen),
              "seconds": time.perf_counter() - t_phase})
        path_launches["train-x4"] = x_launches
        del model, optimizer, step, batches, batch
        sync()

        # ---- 21. the deployment path: reference checkpoint -> port
        # checkpoint -> exported artifacts -> batch serving
        path_launches["export-serve"] = export_serve_phase(port, torch, dev)

        # ---- 22. data parallelism: two ranks of the flagship's training step
        # and of a served request on the one card, and main at data:1
        path_launches["ddp"] = ddp_phase(port, torch, dev, t_expect, {
            "conv_link": 6 * STEPS, "ddim_step": STEPS, "window_attention": n_blk,
            **{k: 0 for k in port.LAUNCHES if k not in ("conv_link", "ddim_step",
                                                      "window_attention")}})

        # ---- 23. tensor parallelism: the flagship's training step and a
        # served request with the state cut over 'model', on the one card
        path_launches["tp"] = tp_phase(port, torch, dev, t_expect, {
            "conv_link": 6 * STEPS, "ddim_step": STEPS, "window_attention": n_blk,
            **{k: 0 for k in port.LAUNCHES if k not in ("conv_link", "ddim_step",
                                                      "window_attention")}})

    # (route, source, TPU kernel, the path whose run counts its launches:
    # the path at whose shapes the kernel phase timed it). K1 and K4 run on
    # several paths; the line holds their serve counts
    csrc = "diffusiondepth_tpu_torch/csrc/"
    fd_py = "diffusiondepth_tpu/ops/fused_denoiser.py"
    wa_py = "diffusiondepth_tpu/ops/window_attention.py"
    ln_py = "diffusiondepth_tpu/ops/layernorm.py"
    wa_sm90 = csrc + "window_attention_sm90.cuh"  # the bf16 tensor-core core of K4, K7, K8
    sources = {"conv_link": ("cuda", csrc + "conv_link.cu", fd_py + ":63", "serve"),
               "ddim_step": ("triton", csrc + "ddim_step.py", fd_py + ":1583", "serve"),
               "window_attention": ("cuda", csrc + "window_attention.cu, " + wa_sm90, wa_py + ":294",
                                    "serve"),
               "sched_step": ("triton", csrc + "ddim_step.py", fd_py + ":1271", "train"),
               "conv_link_bwd": ("cuda", csrc + "conv_link_bwd.cu", fd_py + ":732", "train"),
               "sched_bwd": ("triton", csrc + "sched_bwd.py", fd_py + ":1293", "train"),
               "window_attention_bwd": ("cuda", csrc + "window_attention_bwd.cu, " + wa_sm90,
                                        wa_py + ":497", "train"),
               "window_attention_split": ("cuda", csrc + "window_attention_split.cu, " + wa_sm90,
                                          wa_py + ":106", "serve-pallas"),
               "layernorm_fwd": ("triton", csrc + "layernorm.py", ln_py + ":52", "layernorm"),
               "layernorm_bwd": ("cuda", csrc + "layernorm_bwd.cu", ln_py + ":67", "layernorm")}
    emit({"kernels": [
        {"name": k, "route": src[0], "dispatch": "op" if k in OP_KERNELS else "direct",
         "source": src[1], "replaces": src[2], "path": src[3],
         "launches": path_launches[src[3]][k],
         "launches_by_path": {p: n[k] for p, n in path_launches.items()},
         "max_abs_err": summary[k]["max_abs_err"], "ms": summary[k]["ms"],
         "plain_ms": summary[k]["plain_ms"], "bound_ms": summary[k]["bound_ms"],
         "bound_by": summary[k]["bound_by"], "library_ms": summary[k]["library_ms"],
         **{x: summary[k][x] for x in ("event_ms", "train_ms", "train_bound_ms",
                                       "train_library_ms", "x4") if x in summary[k]}}
        for k, src in sources.items()]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
