"""JAX parameter trees -> the port's state dict.

The inverse of ``diffusiondepth_tpu/utils/convert_torch_checkpoint.py``'s
``convert_reference_model`` for the flagship composition (Swin backbone,
DDIM head with FPN, ``DeepDepthTransformWithUpsampling``,
``ScheduledCNNRefine`` and the HAHI conv path). Every registered Swin
(the three Swin-L names, ``swin_tiny``, ``swin_micro``) has the same tree
layout; only the widths and depths differ. The tree of a standalone
``models/common.py::LayerNorm`` maps onto that module's state dict. It takes the flax
``params`` and ``batch_stats`` trees as nested dicts of numpy arrays and
returns tensors under the reference torch names, the names the port's
modules use. The layout rules are the converter's, inverted:

* conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
* TorchConvTranspose kernel (kh, kw, I, O) -> ConvTranspose2d weight (I, O, kh, kw)
* Dense kernel (I, O) -> Linear weight (O, I)
* BatchNorm {scale, bias} + {mean, var} -> weight, bias, running_mean, running_var
* LayerNorm / GroupNorm {scale, bias} -> weight, bias
"""

from __future__ import annotations

import re
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


def _bn(out, prefix, p, s):
    _norm(out, prefix, p["BatchNorm_0"]["BatchNorm_0"])
    if s:  # absent for a gradient tree
        st = s["BatchNorm_0"]["BatchNorm_0"]
        out[prefix + ".running_mean"] = st["mean"]
        out[prefix + ".running_var"] = st["var"]


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


def _conv_gn_block(out, prefix, p):
    _conv(out, prefix + ".0", p["Conv_0"])
    _norm(out, prefix + ".1", p["GroupNorm_0"]["GroupNorm_0"])
    _conv(out, prefix + ".3", p["Conv_1"])
    _norm(out, prefix + ".4", p["GroupNorm_1"]["GroupNorm_0"])


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

    dt, dts = p["depth_transform"], s.get("depth_transform", {})
    d = pre + "depth_transform."
    _conv_bn(out, d + "conv_transform.0.0", d + "conv_transform.0.1", dt["enc1"],
             dts.get("enc1"))
    _conv_bn(out, d + "conv_transform.1.0", d + "conv_transform.1.1", dt["enc2"],
             dts.get("enc2"))
    _conv_bn(out, d + "conv_inv_transform.0", d + "conv_inv_transform.1",
             dt["dec_up"], dts.get("dec_up"), deconv=True)
    _conv(out, d + "conv_inv_transform.3.0", dt["dec_out"]["Conv_0"])

    mp = p["model"]
    m = pre + "model."
    out[m + "time_embedding.weight"] = mp["time_embedding"]["embedding"]
    _conv_gn_block(out, m + "noise_embedding", mp["noise_embedding"])
    _conv_gn_block(out, m + "pred", mp["pred"])
    if "fuse_conv_a" in mp:
        _conv(out, m + "upsample_add.convA.conv", mp["fuse_conv_a"])
        _conv(out, m + "upsample_add.convB.conv", mp["fuse_conv_b"])

    if "hahineck" in p:
        hp, hs = p["hahineck"], s.get("hahineck", {})
        h = pre + "hahineck."
        for key in hp:
            m2 = re.fullmatch(r"(lateral|trans_proj|trans_fusion)_(\d+)", key)
            if m2:
                name = "lateral_convs" if m2.group(1) == "lateral" else m2.group(1)
                base = f"{h}{name}.{m2.group(2)}"
                _conv_bn(out, base + ".conv", base + ".bn", hp[key], hs.get(key))
        for key in ("conv_proj", "conv_fusion"):
            _conv_bn(out, f"{h}{key}.0.conv", f"{h}{key}.0.bn", hp[key], hs.get(key))


def jax_to_state_dict(params: Tree, batch_stats: Optional[Tree] = None) -> Dict[str, torch.Tensor]:
    """Flax ``params`` / ``batch_stats`` of ``Diffusion_DCbase_Model`` (Swin +
    DDIM head) -> the port's ``state_dict`` (f32 tensors). Without
    ``batch_stats`` the running statistics are left out, so a gradient
    tree (the ``params`` layout) maps leaf by leaf onto the port's
    parameter names; ``batch_stats`` after a training step maps onto the
    running statistics."""
    batch_stats = batch_stats or {}
    out: Dict[str, Any] = {}
    if set(params) == {"scale", "bias"}:  # a standalone LayerNorm
        out = {"weight": params["scale"], "bias": params["bias"]}
    if "depth_backbone" in params:
        if "patch_embed" not in params["depth_backbone"]:
            raise NotImplementedError("only the Swin backbone is ported yet")
        _swin(out, "depth_backbone.", params["depth_backbone"])
    if "depth_head" in params:
        _head(out, "depth_head.", params["depth_head"], batch_stats.get("depth_head", {}))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
