"""Plain PyTorch reference of the DiffusionDepth eval path: a backbone
(``backbones/<name>.py``: Swin-L, the stemless mmbev ResNet), the HAHI conv
neck, the FPN condition, the DDIM denoiser ('add' or 'upsample_add'), the
DDIM schedule and the default depth transform, with the metric row.

It is written from the published architecture (the DiffusionDepth
reference repository's ``Diffusion_DCbase_`` model) and keeps its parameter
names, so one state dict serves this model and the program. It runs in
float32, NCHW, with ordinary ``torch.nn.functional`` calls and no kernel.
``PRODUCT_PRECISION`` rounds the inputs of every convolution and matrix
product (weights and activations) before an f32 product: ``None`` (f32,
the reference), ``"bf16"`` or ``"fp8"`` (e4m3, one scale per tensor, the
control one precision below the configuration's bf16).

The reference imports nothing but torch and numpy.
"""

from __future__ import annotations

import importlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

PRODUCT_PRECISION: Optional[str] = None
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a product in ``PRODUCT_PRECISION`` sees it, in f32."""
    if PRODUCT_PRECISION is None:
        return t
    if PRODUCT_PRECISION == "bf16":
        return t.to(torch.bfloat16).float()
    if PRODUCT_PRECISION == "fp8":
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(PRODUCT_PRECISION)


def conv(x, m: nn.Conv2d, stride=None, padding=None):
    return F.conv2d(rounded(x), rounded(m.weight), m.bias,
                    m.stride if stride is None else stride,
                    m.padding if padding is None else padding)


def deconv(x, m: nn.ConvTranspose2d, padding: int, output_padding: int = 0):
    return F.conv_transpose2d(rounded(x), rounded(m.weight), m.bias, 2, padding,
                              output_padding)


def linear(x, m: nn.Linear):
    return F.linear(rounded(x), rounded(m.weight), m.bias)


def matmul(a, b):
    return torch.matmul(rounded(a), rounded(b))


class BatchNorm(nn.Module):
    """BatchNorm with running statistics (eval), no ``num_batches_tracked``."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


# ---------------------------------------------------------------- head
class ConvBNAct(nn.Sequential):
    def __init__(self, cin, cout, k, stride, pad, act):
        super().__init__(nn.Conv2d(cin, cout, k, stride, pad, bias=False), BatchNorm(cout))
        self.act = act

    def forward(self, x):
        y = self[1](conv(x, self[0]))
        if self.act == "relu":
            return F.relu(y)
        if self.act == "leaky_relu":
            return F.leaky_relu(y, 0.2)
        return y


class DeconvBNReLU(nn.Sequential):
    """k2 stride-2 transposed conv (no bias) + BN + ReLU: an exact 2x upsampling."""

    def __init__(self, c):
        super().__init__(nn.ConvTranspose2d(c, c, 2, 2, bias=False), BatchNorm(c))

    def forward(self, x):
        return F.relu(self[1](deconv(x, self[0], 0)))


class ConvModule(nn.Module):
    """conv (bias) + BN + ReLU, mmcv names."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, 1, k // 2)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(conv(x, self.conv)))


class HAHINeck(nn.Module):
    """The HAHI neck with both deformable attentions off (the shipped heads)."""

    def __init__(self, ch: Sequence[int], e: int = 512):
        super().__init__()
        n = len(ch)
        self.lateral_convs = nn.ModuleList([ConvModule(c, c, 1) for c in ch])
        self.trans_proj = nn.ModuleList([ConvModule(ch[i + 1], e, 1) for i in range(n - 1)])
        self.trans_fusion = nn.ModuleList([ConvModule(ch[i + 1] + e, ch[i + 1], 3)
                                           for i in range(n - 1)])
        self.conv_proj = nn.Sequential(ConvModule(ch[0], e, 1))
        self.conv_fusion = nn.Sequential(ConvModule(ch[0] + e, ch[0], 3))

    def forward(self, fp):
        feats = [m(f) for m, f in zip(self.lateral_convs, fp)]
        outs = [self.conv_fusion[0](torch.cat([self.conv_proj[0](feats[0]), feats[0]], 1))]
        for proj, fuse, f in zip(self.trans_proj, self.trans_fusion, feats[1:]):
            outs.append(fuse(torch.cat([f, proj(f)], 1)))
        return outs


class _Conv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1)


def conv_gn_block(cin, mid, cout):
    return nn.Sequential(nn.Conv2d(cin, mid, 3, 1, 1), nn.GroupNorm(4, mid), nn.ReLU(),
                         nn.Conv2d(mid, cout, 3, 1, 1), nn.GroupNorm(4, cout), nn.ReLU())


class Denoiser(nn.Module):
    """ScheduledCNNRefine: noise embedding, timestep embedding, fusion, predictor."""

    def __init__(self, c=256, cn=16, fuse="upsample_add"):
        super().__init__()
        self.fuse = fuse
        self.noise_embedding = conv_gn_block(cn, 64, c)
        self.time_embedding = nn.Embedding(1280, c)
        if fuse == "upsample_add":
            self.upsample_add = nn.Module()
            self.upsample_add.convA = _Conv(c, c)
            self.upsample_add.convB = _Conv(c, c)
        self.pred = conv_gn_block(c, 64, cn)

    @staticmethod
    def block(seq, x):
        for i in (0, 3):
            x = F.relu(seq[i + 1](conv(x, seq[i])))
        return x

    def forward(self, x, t: int, cond):
        h = cond + self.time_embedding.weight[t][None, :, None, None]
        h = h + self.block(self.noise_embedding, x)
        if self.fuse == "upsample_add":
            h = conv(conv(h, self.upsample_add.convA.conv), self.upsample_add.convB.conv)
        return self.block(self.pred, h)


class DepthTransform(nn.Module):
    """DeepDepthTransformWithUpsampling: stride-2 conv encoder with tanh;
    deconv decoder with sigmoid, depth = 1 / clamp(sigmoid, eps) - 1."""

    def __init__(self, hidden=16, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.conv_transform = nn.Sequential(ConvBNAct(1, hidden, 3, 2, 1, "leaky_relu"),
                                            ConvBNAct(hidden, hidden, 3, 1, 1, None))
        self.conv_inv_transform = nn.Sequential(
            nn.ConvTranspose2d(hidden, hidden, 4, 2, 1), BatchNorm(hidden), nn.ReLU(),
            nn.Sequential(nn.Conv2d(hidden, 1, 3, 1, 1)))

    def t(self, depth):
        return torch.tanh(self.conv_transform(depth))

    def sigmoid_map(self, latent):
        """sigmoid(decoder(latent)): the decoded depth is 1 / clamp(this, eps) - 1."""
        up, bn, _, out = self.conv_inv_transform
        return torch.sigmoid(conv(F.relu(bn(deconv(latent, up, 1))), out[0]))

    def inv_t(self, latent):
        return depth_of_map(self.sigmoid_map(latent), self.eps)


def depth_of_map(s: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The depth a sigmoid map decodes to: 1 / clamp(s, eps) - 1."""
    return 1.0 / torch.clamp(s, min=eps) - 1.0


def ddim_tables(steps: int, train_steps: int = 1000):
    """(timesteps, alpha_prod_t, alpha_prod_prev): linear betas 1e-4..0.02,
    uniform descending timesteps, the last step going to alpha 1."""
    betas = np.linspace(0.0001, 0.02, train_steps, dtype=np.float32)
    acp = np.cumprod(1.0 - betas).astype(np.float32)
    ts = (np.arange(steps) * (train_steps // steps))[::-1].astype(np.int64)
    prev = np.append(ts[1:], -1)
    a_prev = np.where(prev >= 0, acp[np.clip(prev, 0, None)], 1.0).astype(np.float32)
    return ts, acp[ts], a_prev


class DDIMHead(nn.Module):
    """HAHI neck (optional), FPN condition, DDIM sampling of the 16-channel
    half-resolution latent, depth decode."""

    def __init__(self, in_channels, fuse, hahi, steps=20, fpn=256, latent_ch=16):
        super().__init__()
        self.steps, self.latent_ch = steps, latent_ch
        self.depth_transform = DepthTransform(latent_ch)
        self.model = Denoiser(fpn, latent_ch, fuse)
        if hahi:
            self.hahineck = HAHINeck(in_channels)
        self.conv_lateral = nn.ModuleList([ConvBNAct(c, fpn, 3, 1, 1, "relu")
                                           for c in in_channels])
        self.conv_up = nn.ModuleList([DeconvBNReLU(fpn) for _ in in_channels[1:]])

    def condition(self, fp: List[torch.Tensor], latent_hw) -> torch.Tensor:
        if hasattr(self, "hahineck"):
            fp = self.hahineck(fp)
        x = None
        for j in reversed(range(len(fp))):
            lat = self.conv_lateral[j](fp[j])
            if x is not None:
                lat = lat + F.adaptive_avg_pool2d(self.conv_up[j](x), lat.shape[2:])
            x = lat
        if self.model.fuse == "add" and tuple(x.shape[2:]) == tuple(latent_hw):
            return x
        return F.interpolate(x, size=tuple(latent_hw), mode="bilinear", align_corners=True)

    def sample(self, cond, x):
        ts, a_t, a_prev = ddim_tables(self.steps)
        for t, at, ap in zip(ts.tolist(), a_t.tolist(), a_prev.tolist()):
            eps = self.model(x, t, cond)
            x0 = (x - math.sqrt(1.0 - at) * eps) / math.sqrt(at)
            eps = (x - math.sqrt(at) * x0) / math.sqrt(1.0 - at)  # the clipped model output
            x = math.sqrt(ap) * x0 + math.sqrt(1.0 - ap) * eps
        return x


class DiffusionDepth(nn.Module):
    """``Diffusion_DCbase_``: backbone + DDIM head. Inputs and outputs NHWC,
    as the program takes and gives them."""

    def __init__(self, backbone: nn.Module, head: DDIMHead):
        super().__init__()
        self.depth_backbone = backbone
        self.depth_head = head

    def forward(self, rgb, gt, init_latent):
        """Returns the sigmoid map (B, H, W, 1) whose reciprocal is the depth."""
        head = self.depth_head
        fp = self.depth_backbone(rgb.permute(0, 3, 1, 2))
        gt_t = head.depth_transform.t(gt.permute(0, 3, 1, 2))
        cond = head.condition(fp, gt_t.shape[2:])
        lat = head.sample(cond, init_latent.permute(0, 3, 1, 2))
        return head.depth_transform.sigmoid_map(lat).permute(0, 2, 3, 1)


def build(spec: dict) -> DiffusionDepth:
    """The reference model of a configuration file's ``reference`` entry; its
    backbone is ``backbones/<spec["backbone"]>.py``."""
    backbone, chans = importlib.import_module(f"{__package__}.backbones.{spec['backbone']}") \
        .build(spec)
    head = DDIMHead(chans, spec["fuse"], spec["hahi"], spec["inference_steps"],
                    spec["fpn_dim"], spec["latent_channels"])
    return DiffusionDepth(backbone, head)


def metric_row(pred: torch.Tensor, gt: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """RMSE, MAE, iRMSE, iMAE, REL, D^1, D^2, D^3 over pixels with gt > 1e-4
    (the KITTI depth-completion metrics as the reference repository counts
    them), computed in ``dtype`` (float64; bfloat16 for the control), returned
    in float64."""
    pred, gt = pred.to(dtype), gt.to(dtype)
    m = gt > 1e-4
    p, g = pred[m], gt[m]
    p_inv = torch.where(p > 1e-4, 1.0 / (p + 1e-8), torch.zeros_like(p))
    g_inv = 1.0 / (g + 1e-8)
    d, di = p - g, p_inv - g_inv
    ratio = torch.maximum(g / (p + 1e-8), p / (g + 1e-8))
    return torch.stack([d.square().mean().sqrt(), d.abs().mean(), di.square().mean().sqrt(),
                        di.abs().mean(), (d.abs() / (g + 1e-8)).mean(),
                        (ratio < 1.25).to(dtype).mean(), (ratio < 1.25 ** 2).to(dtype).mean(),
                        (ratio < 1.25 ** 3).to(dtype).mean()]).double()
