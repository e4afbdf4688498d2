"""JAX parameter trees -> the port's state dict.

The inverse of ``diffusiondepth_tpu/utils/convert_torch_checkpoint.py``'s
``convert_reference_model`` for ``Diffusion_DCbase_``: a Swin, mmbev ResNet
(Basic, Bottleneck or CBAM blocks) or MPViT backbone under the DDIM head
(FPN, any of the six depth transforms, ``ScheduledCNNRefine`` with the
'upsample_add' convs, the 'upsample_concat' ones or neither, the HAHI conv
path and its deformable attentions); and of its ``convert_nlspn`` for
``NLSPN`` (its torchvision BasicBlock stages, the conv/deconv + BN heads,
the propagation layer). Each family's registered names share one tree
layout; only widths and depths differ. The tree of a standalone
``models/common.py::LayerNorm``, ``ops/msda.py::MultiScaleDeformableAttention``,
HAHI neck, ``PureMSDEnTransformer`` or ``PixelTransformerDecoder`` maps
onto that module's state dict. It takes the flax ``params`` and ``batch_stats``
trees as nested dicts of numpy arrays and returns tensors under the
reference torch names, the names the port's modules use (the CBAM block's
names are the port's own: no reference converter reads them). A tree with
a leaf it does not know raises. The layout rules are the converter's,
inverted:

* conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
* TorchConvTranspose kernel (kh, kw, I, O) -> ConvTranspose2d weight (I, O, kh, kw)
* Dense kernel (I, O) -> Linear weight (O, I)
* BatchNorm {scale, bias} + {mean, var} -> weight, bias, running_mean, running_var
* LayerNorm / GroupNorm {scale, bias} -> weight, bias
* attention kernel (C, H, D) / out kernel (H, D, C) -> Linear weight over H * D
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Dict[str, Any]


def conv_weight(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def conv_transpose_weight(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (2, 3, 0, 1))


def linear_weight(k) -> np.ndarray:
    return np.transpose(np.asarray(k))


def _norm(out, prefix, p):
    out[prefix + ".weight"] = p["scale"]
    out[prefix + ".bias"] = p["bias"]


def _bn_at(out, prefix, p, s):
    """The subtree of the JAX package's BatchNorm module (``{BatchNorm_0:
    {scale, bias}}``) and of its statistics."""
    _norm(out, prefix, p["BatchNorm_0"])
    if s:  # absent for a gradient tree
        out[prefix + ".running_mean"] = s["BatchNorm_0"]["mean"]
        out[prefix + ".running_var"] = s["BatchNorm_0"]["var"]


def _bn(out, prefix, p, s):
    _bn_at(out, prefix, p["BatchNorm_0"], s and s["BatchNorm_0"])


def _dense(out, prefix, p):
    out[prefix + ".weight"] = linear_weight(p["kernel"])
    if "bias" in p:
        out[prefix + ".bias"] = p["bias"]


def _conv(out, prefix, p, deconv=False):
    out[prefix + ".weight"] = (conv_transpose_weight if deconv else conv_weight)(p["kernel"])
    if "bias" in p:
        out[prefix + ".bias"] = p["bias"]


def _conv_bn(out, conv_prefix, bn_prefix, p, s, deconv=False):
    _conv(out, conv_prefix, p["deconv" if deconv else "Conv_0"], deconv)
    if bn_prefix is not None:
        _bn(out, bn_prefix, p, s)


def _swin(out, pre, p):
    pe = p["patch_embed"]
    _conv(out, pre + "patch_embed.projection", pe["projection"])
    _norm(out, pre + "patch_embed.norm", pe["norm"])
    for key, v in p.items():
        m = re.fullmatch(r"stage(\d+)_block(\d+)", key)
        if m:
            b = f"{pre}stages.{m.group(1)}.blocks.{m.group(2)}"
            _norm(out, b + ".norm1", v["norm1"])
            _norm(out, b + ".norm2", v["norm2"])
            for ours, theirs in (("qkv", "qkv"), ("proj", "proj")):
                out[f"{b}.attn.w_msa.{theirs}.weight"] = linear_weight(v["attn"][ours]["kernel"])
                out[f"{b}.attn.w_msa.{theirs}.bias"] = v["attn"][ours]["bias"]
            out[b + ".attn.w_msa.relative_position_bias_table"] = \
                v["attn"]["relative_position_bias_table"]
            for ours, theirs in (("ffn_fc1", "ffn.layers.0.0"), ("ffn_fc2", "ffn.layers.1")):
                out[f"{b}.{theirs}.weight"] = linear_weight(v[ours]["kernel"])
                out[f"{b}.{theirs}.bias"] = v[ours]["bias"]
        m = re.fullmatch(r"downsample(\d+)", key)
        if m:
            d = f"{pre}stages.{m.group(1)}.downsample"
            out[d + ".reduction.weight"] = linear_weight(v["reduction"]["kernel"])
            _norm(out, d + ".norm", v["norm"])
        if re.fullmatch(r"norm\d+", key):
            _norm(out, pre + key, v)


def _cbam(out, c, p, s):
    """``ops/cbam.py::CBAMWithPosEmbed``."""
    _conv(out, c + ".dim_reduce.0", p["Conv_0"])
    _bn_at(out, c + ".dim_reduce.1", p["BatchNorm_0"], s.get("BatchNorm_0"))
    for i in (0, 1):
        _dense(out, f"{c}.pos_embed.{i}", p[f"Dense_{i}"])
    _conv(out, c + ".ca.fc1", p["ChannelAttention_0"]["Conv_0"])
    _conv(out, c + ".ca.fc2", p["ChannelAttention_0"]["Conv_1"])
    _conv(out, c + ".dim_expand.0", p["Conv_1"])
    _bn_at(out, c + ".dim_expand.1", p["BatchNorm_1"], s.get("BatchNorm_1"))
    _conv(out, c + ".sa.conv1", p["SpatialAttention_0"]["Conv_0"])


def _resnet(out, pre, p, s):
    for key, v in p.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", key)
        if not m:
            raise ValueError(f"unknown ResNet subtree {key!r}")
        b = f"{pre}layers.{m.group(1)}.{m.group(2)}"
        vs = s.get(key, {})
        i = 0
        while f"Conv_{i}" in v:  # conv1/bn1, conv2/bn2 (conv3/bn3 in a bottleneck)
            _conv(out, f"{b}.conv{i + 1}", v[f"Conv_{i}"])
            _bn_at(out, f"{b}.bn{i + 1}", v[f"BatchNorm_{i}"], vs.get(f"BatchNorm_{i}"))
            i += 1
        if "downsample" in v:
            _conv(out, b + ".downsample", v["downsample"])
        if "CBAMWithPosEmbed_0" in v:
            _cbam(out, b + ".cbam", v["CBAMWithPosEmbed_0"], vs.get("CBAMWithPosEmbed_0", {}))


def _conv_bn_pair(out, prefix, p, s):
    """The MPViT ``ConvBN``: ``{conv, bn}``."""
    _conv(out, prefix + ".conv", p["conv"])
    _bn_at(out, prefix + ".bn", p["bn"], s and s.get("bn"))


def _mpvit(out, pre, p, s):
    for key, v in p.items():
        vs = s.get(key, {})
        m = re.fullmatch(r"stem(\d+)|stage(\d+)_(patch_embed|mhca)(\d+)|stage(\d+)_(invres|aggregate)",
                         key)
        if not m:
            raise ValueError(f"unknown MPViT subtree {key!r}")
        if m.group(1) is not None:
            _conv_bn_pair(out, f"{pre}stem.{m.group(1)}", v, vs)
        elif m.group(3) == "patch_embed":
            b = f"{pre}patch_embed_stages.{m.group(2)}.patch_embeds.{m.group(4)}.patch_conv"
            _conv(out, b + ".dwconv", v["dwconv"])
            _conv(out, b + ".pwconv", v["pwconv"])
            _bn_at(out, b + ".bn", v["bn"], vs.get("bn"))
        elif m.group(3) == "mhca":
            b = f"{pre}mhca_stages.{m.group(2)}.mhca_blks.{m.group(4)}"
            _conv(out, b + ".cpe.proj", v["cpe"]["proj"])
            for ck, cv in v["crpe"].items():
                _conv(out, f"{b}.crpe.conv_list.{ck.split('_')[1]}", cv)
            for bk, bv in v.items():
                bm = re.fullmatch(r"block(\d+)", bk)
                if not bm:
                    continue
                lb = f"{b}.MHCA_layers.{bm.group(1)}"
                _norm(out, lb + ".norm1", bv["norm1"])
                _norm(out, lb + ".norm2", bv["norm2"])
                _dense(out, lb + ".factoratt_crpe.qkv", bv["factoratt_crpe"]["qkv"])
                _dense(out, lb + ".factoratt_crpe.proj", bv["factoratt_crpe"]["proj"])
                _dense(out, lb + ".mlp.fc1", bv["mlp_fc1"])
                _dense(out, lb + ".mlp.fc2", bv["mlp_fc2"])
        elif m.group(6) == "invres":
            b = f"{pre}mhca_stages.{m.group(5)}.InvRes"
            _conv_bn_pair(out, b + ".conv1", v["conv1"], vs.get("conv1"))
            _conv_bn_pair(out, b + ".conv2", v["conv2"], vs.get("conv2"))
            _conv(out, b + ".dwconv", v["dwconv"])
            _bn_at(out, b + ".norm", v["norm"], vs.get("norm"))
        else:
            _conv_bn_pair(out, f"{pre}mhca_stages.{m.group(5)}.aggregate", v, vs)


def _conv_gn_block(out, prefix, p):
    _conv(out, prefix + ".0", p["Conv_0"])
    _norm(out, prefix + ".1", p["GroupNorm_0"]["GroupNorm_0"])
    _conv(out, prefix + ".3", p["Conv_1"])
    _norm(out, prefix + ".4", p["GroupNorm_1"]["GroupNorm_0"])


def _depth_transform(out, d, dt, dts):
    """The JAX transform's tree (encoder ``enc1..3``; decoder ``dec1/dec2``
    for ``DeepDepthTransform``, ``dec_up1/dec_up2`` for X4, else
    ``dec_up``; then ``dec_out``) under the names of
    ``models/depth_transform.py``."""
    for i, key in enumerate(k for k in ("enc1", "enc2", "enc3") if k in dt):
        if "kernel" in dt[key]:  # the 1x1 encoder's bare convs
            _conv(out, f"{d}conv_transform.{i}", dt[key])
        else:
            _conv_bn(out, f"{d}conv_transform.{i}.0", f"{d}conv_transform.{i}.1", dt[key],
                     dts.get(key))
    inv = d + "conv_inv_transform."
    if "dec1" in dt:
        for i, key in enumerate(("dec1", "dec2")):
            _conv_bn(out, f"{inv}{i}.0", f"{inv}{i}.1", dt[key], dts.get(key))
        return
    if "dec_up1" in dt:
        _conv(out, inv + "0", dt["dec_up1"]["deconv"], deconv=True)
        _conv_bn(out, inv + "1", inv + "2", dt["dec_up2"], dts.get("dec_up2"), deconv=True)
        _conv(out, inv + "4.0", dt["dec_out"]["Conv_0"])
        return
    _conv_bn(out, inv + "0", inv + "1", dt["dec_up"], dts.get("dec_up"), deconv=True)
    _conv(out, inv + "3.0", dt["dec_out"]["Conv_0"])


def _head(out, pre, p, s):
    for key in p:
        m = re.fullmatch(r"conv_lateral_(\d+)", key)
        if m:
            i = m.group(1)
            _conv_bn(out, f"{pre}conv_lateral.{i}.0", f"{pre}conv_lateral.{i}.1", p[key],
                     s.get(key))
        m = re.fullmatch(r"conv_up_(\d+)", key)
        if m:
            i = m.group(1)
            _conv_bn(out, f"{pre}conv_up.{i}.0", f"{pre}conv_up.{i}.1", p[key], s.get(key),
                     deconv=True)

    if "depth_transform" in p:  # the reciprocal transforms have no parameters
        _depth_transform(out, pre + "depth_transform.", p["depth_transform"],
                         s.get("depth_transform", {}))

    mp = p["model"]
    m = pre + "model."
    out[m + "time_embedding.weight"] = mp["time_embedding"]["embedding"]
    _conv_gn_block(out, m + "noise_embedding", mp["noise_embedding"])
    _conv_gn_block(out, m + "pred", mp["pred"])
    if "fuse_conv_a" in mp:
        # the concat convs take twice the channels in
        a = mp["fuse_conv_a"]["kernel"]
        fusion = "upsample_fuse" if a.shape[2] == 2 * a.shape[3] else "upsample_add"
        _conv(out, m + fusion + ".convA.conv", mp["fuse_conv_a"])
        _conv(out, m + fusion + ".convB.conv", mp["fuse_conv_b"])

    if "hahineck" in p:
        _hahi(out, pre + "hahineck.", p["hahineck"], s.get("hahineck", {}))


def _msda(out, prefix, p):
    """``ops/msda.py::MultiScaleDeformableAttention``: mmcv's names."""
    for key in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
        _dense(out, prefix + key, p[key])


def _hahi(out, h, hp, hs):
    """``models/necks/hahi.py::HAHIHeteroNeck``, its attentions too."""
    for key in hp:
        m2 = re.fullmatch(r"(lateral|trans_proj|trans_fusion)_(\d+)", key)
        if m2:
            name = "lateral_convs" if m2.group(1) == "lateral" else m2.group(1)
            base = f"{h}{name}.{m2.group(2)}"
            _conv_bn(out, base + ".conv", base + ".bn", hp[key], hs.get(key))
    for key in ("conv_proj", "conv_fusion"):
        _conv_bn(out, f"{h}{key}.0.conv", f"{h}{key}.0.bn", hp[key], hs.get(key))
    if "level_embed" in hp:
        out[h + "level_embed"] = hp["level_embed"]
    for key in ("self_attn", "multi_att"):
        if key in hp:
            _msda(out, f"{h}{key}.", hp[key])
    if "reference_points_fc" in hp:
        _dense(out, h + "reference_points_fc", hp["reference_points_fc"])


def _mha(out, prefix, p):
    """flax ``MultiHeadDotProductAttention``: the (C, H, D) ``query``,
    ``key``, ``value`` kernels and the (H, D, C) ``out`` kernel as Linear
    weights over the H * D features."""
    for key in ("query", "key", "value"):
        k = np.asarray(p[key]["kernel"])
        out[f"{prefix}{key}.weight"] = linear_weight(k.reshape(k.shape[0], -1))
        out[f"{prefix}{key}.bias"] = np.asarray(p[key]["bias"]).reshape(-1)
    k = np.asarray(p["out"]["kernel"])
    out[prefix + "out.weight"] = linear_weight(k.reshape(-1, k.shape[-1]))
    out[prefix + "out.bias"] = p["out"]["bias"]


def _ffn(out, prefix, p):
    _dense(out, prefix + "fc1", p["Dense_0"])
    _dense(out, prefix + "fc2", p["Dense_1"])


def _mlp(out, prefix, p):
    for key, v in p.items():
        j = re.fullmatch(r"Dense_(\d+)", key).group(1)
        _dense(out, f"{prefix}layers.{j}", v)


def _msde_transformer(out, p):
    """``models/necks/transformer.py::PureMSDEnTransformer``."""
    out["level_embeds"] = p["level_embeds"]
    for key, v in p["encoder"].items():
        i = re.fullmatch(r"layer(\d+)", key).group(1)
        lay = f"encoder.layers.{i}."
        _msda(out, lay + "self_attn.", v["self_attn"])
        _norm(out, lay + "norm1", v["norm1"])
        _ffn(out, lay + "ffn.", v["ffn"])
        _norm(out, lay + "norm2", v["norm2"])


def _pixel_decoder(out, p):
    """``models/necks/transformer.py::PixelTransformerDecoder``."""
    for key, v in p.items():
        m = re.fullmatch(r"layer(\d+)", key)
        if m:
            lay = f"layers.{m.group(1)}."
            for att in ("cross_attn", "self_attn"):
                _mha(out, f"{lay}{att}.", v[att])
            for norm in ("norm1", "norm2", "norm3"):
                _norm(out, lay + norm, v[norm])
            _ffn(out, lay + "ffn.", v["ffn"])
        elif key in ("query_embed", "query_pos"):
            out[key] = v
        elif key == "decoder_norm":
            _norm(out, key, v)
        elif key in ("class_embed", "mask_embed"):
            _mlp(out, key + ".", v)
        elif key == "bins_embed":
            _dense(out, key, v)
        else:
            raise ValueError(f"unknown PixelTransformerDecoder subtree {key!r}")


# NLSPN's ConvBNAct (conv [+ BN]) and DeconvBNAct (deconv + BN) modules
_NLSPN_CONV = ("conv1_rgb", "conv1_dep", "conv6", "id_dec1", "id_dec0", "gd_dec1", "gd_dec0",
               "cf_dec1", "cf_dec0")
_NLSPN_DECONV = ("dec5", "dec4", "dec3", "dec2")


def _nlspn(out, p, s):
    """``models/nlspn.py::NLSPNModel``: the reference NLSPN's names."""
    for key, v in p.items():
        vs = s.get(key, {})
        if key in _NLSPN_CONV:
            _conv_bn(out, key + ".0", key + ".1" if "BatchNorm_0" in v else None, v, vs)
        elif key in _NLSPN_DECONV:
            _conv_bn(out, key + ".0", key + ".1", v, vs, deconv=True)
        elif re.fullmatch(r"conv[2-5]", key):
            for bk, bv in v.items():
                j = re.fullmatch(r"block(\d+)", bk).group(1)
                b, bs = f"{key}.{j}", vs.get(bk, {})
                for i in (0, 1):
                    _conv(out, f"{b}.conv{i + 1}", bv[f"Conv_{i}"])
                    _bn_at(out, f"{b}.bn{i + 1}", bv[f"BatchNorm_{i}"], bs.get(f"BatchNorm_{i}"))
                if "downsample_conv" in bv:
                    _conv(out, b + ".downsample.0", bv["downsample_conv"])
                    _bn_at(out, b + ".downsample.1", bv["downsample_bn"], bs.get("downsample_bn"))
        elif key == "prop_layer":
            _conv(out, "prop_layer.conv_offset_aff", v["conv_offset_aff"])
            if "aff_scale_const" in v:
                out["prop_layer.aff_scale_const"] = v["aff_scale_const"]
        else:
            raise ValueError(f"unknown NLSPN subtree {key!r}")


def _backbone(out, pre, p, s):
    if "patch_embed" in p:
        _swin(out, pre, p)
    elif "stem0" in p:
        _mpvit(out, pre, p, s)
    elif any(re.fullmatch(r"layer\d+_block\d+", k) for k in p):
        _resnet(out, pre, p, s)
    else:
        raise ValueError(f"unknown backbone tree with keys {sorted(p)[:4]}")


def _n_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def jax_to_state_dict(params: Tree, batch_stats: Optional[Tree] = None) -> Dict[str, torch.Tensor]:
    """Flax ``params`` / ``batch_stats`` of ``Diffusion_DCbase_Model`` (a
    Swin, ResNet or MPViT backbone + DDIM head), of ``NLSPNModel`` (a
    tree with ``prop_layer``) or of one of the standalone modules above ->
    the port's ``state_dict`` (f32 tensors).
    NLSPN under TC keeps its constant scale outside the JAX tree; the
    port's ``prop_layer.aff_scale_const`` buffer is then left out. Without ``batch_stats`` the running
    statistics are left out, so a gradient tree (the ``params`` layout)
    maps leaf by leaf onto the port's parameter names; ``batch_stats``
    after a training step maps onto the running statistics. Raises on a
    leaf it does not map."""
    batch_stats = batch_stats or {}
    out: Dict[str, Any] = {}
    known = {"depth_backbone", "depth_head"}
    if set(params) == {"scale", "bias"}:  # a standalone LayerNorm
        out = {"weight": params["scale"], "bias": params["bias"]}
    elif "prop_layer" in params:
        _nlspn(out, params, batch_stats)
    elif "sampling_offsets" in params:
        _msda(out, "", params)
    elif "level_embeds" in params:
        _msde_transformer(out, params)
    elif "query_embed" in params:
        _pixel_decoder(out, params)
    elif "conv_proj" in params:
        _hahi(out, "", params, batch_stats)
    elif not set(params) <= known or not set(batch_stats) <= known:
        raise ValueError(f"unknown parameter tree with keys {sorted(set(params) | set(batch_stats))}")
    if "depth_backbone" in params:
        _backbone(out, "depth_backbone.", params["depth_backbone"],
                  batch_stats.get("depth_backbone", {}))
    if "depth_head" in params:
        _head(out, "depth_head.", params["depth_head"], batch_stats.get("depth_head", {}))
    n_in = _n_leaves(params) + _n_leaves(batch_stats)
    if len(out) != n_in:
        raise ValueError(f"the trees hold {n_in} leaves; {len(out)} were mapped")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
