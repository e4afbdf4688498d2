"""NLSPN depth completion, NHWC (port of ``diffusiondepth_tpu/models/nlspn.py``).

The reference NLSPN (Park et al., ECCV 2020): a resnet18/34 encoder-decoder
over (rgb, sparse depth) gives an initial depth, a guidance map and a
confidence map; ``prop_time`` steps of non-local spatial propagation then
refine the depth. Each step reads 9 taps per pixel at learned offsets,
weighted by learned affinities. ``--prop_stencil_radius`` R > 0 compiles
offsets and affinities once into a dense local stencil and runs each step
as a shift-and-multiply-accumulate (``ops/stencil_prop.py``, exact for
|offset| <= R); R = 0 runs the bilinear gather, ``modulated_deform_conv``
with a frozen all-ones 3x3 kernel, as the reference's DCNv2 call.

Affinities (reference ``_get_offset_affinity``): a zero-initialised
3x3 conv emits (o1, o2, aff); the centre tap gets a zero offset; TC scales
tanh(aff) by a constant, TGASS by a trainable ``aff_scale_const``
(starting at ``affinity_gamma`` * 8); with ``conf_prop`` the confidence,
read bilinearly at each tap's offset (no gradient through the offset),
scales the affinity; the abs-sum normalisation (clamped at 1 for ASS and
TGASS) and the centre affinity 1 - sum(others) follow.

Parameter names are the reference NLSPN's state-dict names, the ones
``convert_nlspn`` of the JAX package reads: ``conv1_rgb``, ``conv1_dep``,
``conv2..conv5.<j>.{conv,bn}{1,2}`` and ``downsample.{0,1}``, ``conv6``,
``dec5..dec2``, ``id_dec1/0``, ``gd_dec1/0``, ``cf_dec1/0``,
``prop_layer.conv_offset_aff`` and ``prop_layer.aff_scale_const`` (a
trainable parameter under TGASS, a fixed buffer under TC, absent under AS
and ASS).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import modulated_deform_conv
from ..ops.msda import bilinear_sample_nhwc
from ..ops.native import constant
from ..ops.stencil_prop import build_stencil, stencil_apply
from .common import BatchNorm2d, ConvBNAct, DeconvBNAct, conv2d_nhwc

AFFINITIES = ("AS", "ASS", "TC", "TGASS")
NETWORKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


class TorchBasicBlock(nn.Module):
    """torchvision's BasicBlock: 3x3 (stride) + BN + ReLU -> 3x3 + BN, plus
    the identity (1x1 conv + BN where the shape changes), ReLU."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False),
                                            BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight, None, self.stride, 1, dt), dt))
        out = self.bn2(conv2d_nhwc(out, self.conv2.weight, None, 1, 1, dt), dt)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv2d_nhwc(x, conv.weight, None, self.stride, 0, dt), dt)
        return F.relu(out + identity)


class ResNetStage(nn.Sequential):
    """A torchvision ResNet layer: ``blocks`` BasicBlocks, the first one
    strided."""

    def __init__(self, cin: int, planes: int, blocks: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(TorchBasicBlock(cin, planes, stride, dtype),
                         *(TorchBasicBlock(planes, planes, 1, dtype) for _ in range(blocks - 1)))


class NLSPNPropagation(nn.Module):
    """Non-local spatial propagation over a 1-channel map (``prop_layer``)."""

    def __init__(self, args, ch_g: int, k_g: int = 3, k_f: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if k_g % 2 != 1 or k_f % 2 != 1:
            raise ValueError("the guidance and propagation kernels must be odd")
        if args.affinity not in AFFINITIES:
            raise ValueError(f"affinity {args.affinity!r} not in {AFFINITIES}")
        self.args = args
        self.dtype = dtype
        self.k_f = k_f
        self.num = k_f * k_f - 1
        self.idx_ref = self.num // 2
        self.conv_offset_aff = nn.Conv2d(ch_g, 3 * self.num, k_g, 1, (k_g - 1) // 2)
        nn.init.zeros_(self.conv_offset_aff.weight)
        nn.init.zeros_(self.conv_offset_aff.bias)
        if args.affinity == "TGASS":
            self.aff_scale_const = nn.Parameter(
                torch.full((1,), args.affinity_gamma * self.num, dtype=torch.float32))
        elif args.affinity == "TC":
            self.register_buffer("aff_scale_const", torch.full((1,), float(self.num)))
        else:
            self.aff_scale_const = None

    def gamma(self, device: torch.device) -> torch.Tensor:
        """The affinity scale: the TC or TGASS constant, ones(1) otherwise."""
        if self.aff_scale_const is None:
            return torch.ones(1, device=device)
        return self.aff_scale_const

    def offset_affinity(self, guidance: torch.Tensor, confidence: Optional[torch.Tensor]):
        """-> offset (B, H, W, 2 (num + 1)), aff (B, H, W, num + 1)."""
        b, h, w, _ = guidance.shape
        num, ref = self.num, self.idx_ref
        affinity = self.args.affinity
        conv = self.conv_offset_aff
        oa = conv2d_nhwc(guidance, conv.weight, conv.bias, 1, conv.padding, self.dtype)
        o1, o2, aff = oa[..., :num], oa[..., num:2 * num], oa[..., 2 * num:]

        # cat(o1, o2) split into pairs: the reference's channel wiring
        offset = torch.cat([o1, o2], dim=-1).reshape(b, h, w, num, 2)
        zero_ref = offset.new_zeros(b, h, w, 1, 2)
        offset = torch.cat([offset[..., :ref, :], zero_ref, offset[..., ref:, :]], dim=3)

        if affinity == "TC":
            aff = torch.tanh(aff) / self.aff_scale_const
        elif affinity == "TGASS":
            aff = torch.tanh(aff) / (torch.abs(self.aff_scale_const) + 1e-8)

        if self.args.conf_prop and confidence is not None:
            # the confidence at each non-centre tap's offset, read with the
            # offset held fixed
            taps = [k for k in range(num + 1) if k != ref]
            off_sample = offset.detach()[:, :, :, taps, :]
            if self.args.legacy:
                # pre-ECCV20 checkpoints bake the tap displacement in
                half = (self.k_f - 1) / 2
                disp = constant(("nlspn_disp", self.k_f, tuple(taps)),
                                lambda: [[k // self.k_f - half, k % self.k_f - half]
                                         for k in taps], off_sample.device, off_sample.dtype)
                off_sample = off_sample + disp
            ys = (torch.arange(h, device=guidance.device)[None, :, None, None]
                  + off_sample[..., 0]).reshape(b, -1)
            xs = (torch.arange(w, device=guidance.device)[None, None, :, None]
                  + off_sample[..., 1]).reshape(b, -1)
            conf = bilinear_sample_nhwc(confidence, xs, ys)
            aff = aff * conf.reshape(b, h, w, num)

        aff_abs_sum = torch.sum(torch.abs(aff), dim=-1, keepdim=True) + 1e-4
        if affinity in ("ASS", "TGASS"):
            aff_abs_sum = torch.clamp_min(aff_abs_sum, 1.0)
        if affinity in ("AS", "ASS", "TGASS"):
            aff = aff / aff_abs_sum

        aff_ref = 1.0 - torch.sum(aff, dim=-1, keepdim=True)
        aff = torch.cat([aff[..., :ref], aff_ref, aff[..., ref:]], dim=-1)
        return offset.reshape(b, h, w, 2 * (num + 1)), aff

    @property
    def radius(self) -> int:
        return int(self.args.prop_stencil_radius or 0)

    def stencil(self, offset: torch.Tensor, aff: torch.Tensor,
                dtype: torch.dtype) -> Optional[torch.Tensor]:
        """The stencil M of the radius > 0 route (f32 at least), None for the
        gather route."""
        if self.radius == 0:
            return None
        return build_stencil(offset, aff, self.radius,
                             dtype=torch.promote_types(dtype, torch.float32))

    def propagate(self, feat_init: torch.Tensor, offset: torch.Tensor, aff: torch.Tensor,
                  stencil: Optional[torch.Tensor], feat_fix: Optional[torch.Tensor] = None):
        """``prop_time`` steps from ``feat_init`` -> (final map, the maps of
        every step stacked (T, B, H, W, 1)), in feat_init's dtype."""
        dt = feat_init.dtype
        preserve = self.args.preserve_input and feat_fix is not None
        if preserve:
            mask_fix = ((feat_fix > 0.0).to(dt).sum(-1, keepdim=True) > 0.0).to(dt)
            keep, fixed = (1.0 - mask_fix), (mask_fix * feat_fix).to(dt)
        if stencil is None:
            w_prop = torch.ones(self.k_f, self.k_f, 1, 1, dtype=dt, device=feat_init.device)

        feat, inter = feat_init, []
        for _ in range(self.args.prop_time):
            if preserve:
                feat = keep * feat + fixed
            if stencil is not None:
                feat = stencil_apply(stencil, feat, self.radius)
            else:
                feat = modulated_deform_conv(feat, offset, aff, w_prop, padding=(self.k_f - 1) // 2,
                                             groups=1, deformable_groups=1).to(dt)
            inter.append(feat)
        return feat, torch.stack(inter)

    def forward(self, feat_init: torch.Tensor, guidance: torch.Tensor,
                confidence: Optional[torch.Tensor] = None,
                feat_fix: Optional[torch.Tensor] = None):
        """-> (final map, the ``prop_time`` maps stacked (T, B, H, W, 1),
        offset, aff, gamma)."""
        offset, aff = self.offset_affinity(guidance, confidence)
        stencil = self.stencil(offset, aff, feat_init.dtype)
        feat, inter = self.propagate(feat_init, offset, aff, stencil, feat_fix)
        return feat, inter, offset, aff, self.gamma(feat_init.device)


class NLSPNModel(nn.Module):
    """U-Net over (rgb, sparse depth) with the initial-depth, guidance and
    confidence heads, then the propagation."""

    def __init__(self, args, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if args.network not in NETWORKS:
            raise ValueError(f"network {args.network!r} not in {sorted(NETWORKS)}")
        self.args = args
        blocks = NETWORKS[args.network]
        n_neigh = args.prop_kernel * args.prop_kernel - 1

        def c(cin, cout, stride=1, bn=True, act="leaky_relu"):
            return ConvBNAct(cin, cout, 3, stride, 1, act=act, dtype=dtype, use_bn=bn)

        def t(cin, cout):
            return DeconvBNAct(cin, cout, dtype, kernel=3, act="leaky_relu")

        self.conv1_rgb = c(3, 48, bn=False)
        self.conv1_dep = c(1, 16, bn=False)
        self.conv2 = ResNetStage(64, 64, blocks[0], 1, dtype)
        self.conv3 = ResNetStage(64, 128, blocks[1], 2, dtype)
        self.conv4 = ResNetStage(128, 256, blocks[2], 2, dtype)
        self.conv5 = ResNetStage(256, 512, blocks[3], 2, dtype)
        self.conv6 = c(512, 512, stride=2)
        self.dec5 = t(512, 256)
        self.dec4 = t(256 + 512, 128)
        self.dec3 = t(128 + 256, 64)
        self.dec2 = t(64 + 128, 64)
        self.id_dec1 = c(64 + 64, 64)
        # conv_bn_relu(relu=True) is LeakyReLU(0.2)
        self.id_dec0 = c(64 + 64, 1, bn=False)
        self.gd_dec1 = c(64 + 64, 64)
        self.gd_dec0 = c(64 + 64, n_neigh, bn=False, act=None)
        if args.conf_prop:
            self.cf_dec1 = c(64 + 64, 32)
            self.cf_dec0 = c(32 + 64, 1, bn=False, act="sigmoid")
        self.prop_layer = NLSPNPropagation(args, ch_g=n_neigh, k_g=3, k_f=args.prop_kernel,
                                           dtype=dtype)

    def heads(self, sample: Dict[str, torch.Tensor]):
        """The encoder-decoder: -> (pred_init, guidance, confidence or
        None)."""
        rgb, dep = sample["rgb"], sample["dep"]
        fe1 = torch.cat([self.conv1_rgb(rgb), self.conv1_dep(dep)], dim=-1)
        fe2 = self.conv2(fe1)
        fe3 = self.conv3(fe2)
        fe4 = self.conv4(fe3)
        fe5 = self.conv5(fe4)
        fe6 = self.conv6(fe5)

        def concat(fd, fe):
            # crop the decoder's overshoot, as the reference's _concat
            return torch.cat([fd[:, :fe.shape[1], :fe.shape[2]], fe], dim=-1)

        fd5 = self.dec5(fe6)
        fd4 = self.dec4(concat(fd5, fe5))
        fd3 = self.dec3(concat(fd4, fe4))
        fd2 = self.dec2(concat(fd3, fe3))

        pred_init = self.id_dec0(concat(self.id_dec1(concat(fd2, fe2)), fe1))
        guide = self.gd_dec0(concat(self.gd_dec1(concat(fd2, fe2)), fe1))
        confidence = None
        if self.args.conf_prop:
            confidence = self.cf_dec0(concat(self.cf_dec1(concat(fd2, fe2)), fe1))
        return pred_init, guide, confidence

    def forward(self, sample: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                init_latent: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """sample keys (NHWC): rgb (B, H, W, 3), dep (B, H, W, 1). NLSPN
        draws nothing: ``generator`` and ``init_latent`` are accepted so
        that the train and eval steps call it as the diffusion models; in
        training mode (``model.train()``) BatchNorm uses batch statistics."""
        pred_init, guide, confidence = self.heads(sample)
        y, y_inter, offset, aff, gamma = self.prop_layer(pred_init, guide, confidence,
                                                         sample["dep"])
        return {
            "pred": torch.clamp_min(y, 0.0),
            "pred_init": pred_init,
            "pred_inter": y_inter,
            "guidance": guide,
            "offset": offset,
            "aff": aff,
            "gamma": gamma,
            "confidence": confidence,
            "ddim_loss": None,
            "gt_map_t": None,
            "blur_depth_t": None,
            "pred_uncertainty": None,
            "weight_map": None,
        }
