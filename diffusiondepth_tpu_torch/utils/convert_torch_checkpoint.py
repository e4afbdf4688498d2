"""Reference PyTorch checkpoints -> the port's state dict (the port's own
copy of the layout rules of ``diffusiondepth_tpu/utils/convert_torch_checkpoint.py``).

The port's modules carry the reference's torch names (ROADMAP rule 1), so
a reference ``model_EEEEE.pt`` mostly loads by name. What is left are the
reference's own loader rules:

* the wrappers: ``state_dict``, ``model`` or ``net`` around the weights
  (reference swin.py:703-709, main.py:418) and the ``module.`` prefix of
  DistributedDataParallel;
* official (Microsoft) Swin classification weights, which the reference
  remaps to mmcv names (convert_ckpt.py:4-57): ``layers.i`` ->
  ``stages.i``, ``attn.qkv`` -> ``attn.w_msa.qkv``, ``mlp.fc1/fc2`` ->
  ``ffn.layers.0.0/1``, ``patch_embed.proj`` -> ``patch_embed.projection``,
  and the patch-merging weights reordered from the concat order
  [x0; x1; x2; x3] to the unfold order; the classification head and the
  final norm are dropped;
* a relative-position bias table of another window size, resized bicubic
  to the model's window (reference swin.py:728-748) as the JAX converter
  resizes it (``jax.image.resize``, Keys cubic with a = -0.5);
* bare backbone weights (official Swin, timm-format MPViT, mmbev ResNet)
  go under ``depth_backbone.``; NLSPN checkpoints (``conv1_rgb.*``) have no
  backbone/head split and load as they are;
* weights the port has no module for are skipped: the reference's dormant
  HAHI attention (self/cross attention off in every shipped config), its
  positional-encoding buffers, Swin's index and mask buffers.

Merging follows the reference's ``load_state_dict(..., strict=False)``
(src/main.py:423): each tensor of the model whose name the checkpoint
holds is replaced, shapes must agree, the rest keep their values.
"""

from __future__ import annotations

import argparse
import pickle
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]

_WRAPPERS = ("state_dict", "model", "net")
_SWIN_TABLE = "relative_position_bias_table"
# backbone families whose bare checkpoints go under depth_backbone.
_BACKBONE_ROOTS = ("patch_embed.", "stages.", "layers.", "stem.", "patch_embed_stages.",
                   "mhca_stages.", "norm0.", "norm1.", "norm2.", "norm3.")


def load_torch_file(path: str, trust_pickle: bool = False) -> Tensors:
    """The tensors of a ``.pt``/``.pth`` file, unwrapped from ``state_dict``,
    ``model`` or ``net``, with any ``module.`` prefix cut.

    The file is read with ``weights_only=True``, allowing
    ``argparse.Namespace`` (the reference saves its args beside the
    weights). A file that needs any other class raises
    ``pickle.UnpicklingError``; with ``trust_pickle`` it is unpickled in
    full, which runs whatever code the file names: only for a file from
    a trusted source."""
    if trust_pickle:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    else:
        with torch.serialization.safe_globals([argparse.Namespace]):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, Mapping):
        raise pickle.UnpicklingError(f"{path} holds a {type(ckpt).__name__}, not a state dict")
    for key in _WRAPPERS:
        if key in ckpt and isinstance(ckpt[key], Mapping):
            ckpt = ckpt[key]
            break
    return {(k[7:] if k.startswith("module.") else k): v.detach()
            for k, v in ckpt.items() if torch.is_tensor(v)}


def correct_unfold_reduction_order(x: torch.Tensor) -> torch.Tensor:
    """Official PatchMerging concat order [x0; x1; x2; x3] -> unfold
    (c, i, j) order (reference convert_ckpt.py:7-12)."""
    out_channel, in_channel = x.shape
    x = x.reshape(out_channel, 4, in_channel // 4)
    return x[:, [0, 2, 1, 3], :].transpose(1, 2).reshape(out_channel, in_channel)


def correct_unfold_norm_order(x: torch.Tensor) -> torch.Tensor:
    """(reference convert_ckpt.py:14-18)."""
    in_channel = x.shape[0]
    x = x.reshape(4, in_channel // 4)
    return x[[0, 2, 1, 3], :].transpose(0, 1).reshape(in_channel)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s bicubic along one
    axis: Keys cubic, half-pixel centres, the kernel widened when shrinking
    (antialias), weights normalised per output sample, in f32."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kscale
    w = _keys_cubic(x).astype(np.float32)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_rel_pos_table(table: torch.Tensor, target_len: int) -> torch.Tensor:
    """Bicubic resize of a ((2w-1)^2, heads) table to another window size
    (reference swin.py:728-748), as ``jax.image.resize`` computes it."""
    l1, heads = table.shape
    if l1 == target_len:
        return table
    s1, s2 = int(round(l1 ** 0.5)), int(round(target_len ** 0.5))
    img = table.float().numpy().T.reshape(heads, s1, s1)
    w = _resize_weights(s1, s2)
    out = np.einsum("hij,ik,jl->hkl", img, w, w)
    return torch.from_numpy(np.ascontiguousarray(out.reshape(heads, target_len).T, np.float32))


_OFFICIAL_BLOCK = [(r"attn\.qkv\.", "attn.w_msa.qkv."), (r"attn\.proj\.", "attn.w_msa.proj."),
                   (r"attn\.relative_position_bias_table$",
                    "attn.w_msa.relative_position_bias_table"),
                   (r"mlp\.fc1\.", "ffn.layers.0.0."), (r"mlp\.fc2\.", "ffn.layers.1."),
                   (r"norm1\.", "norm1."), (r"norm2\.", "norm2.")]


def convert_swin_official(sd: Mapping[str, torch.Tensor]) -> Tensors:
    """Official Swin classification weights -> mmcv names (bare, without
    ``depth_backbone.``), the patch-merging weights in unfold order. The
    head, the final norm and the index and mask buffers are dropped."""
    out: Tensors = {}
    for k, v in sd.items():
        if k.startswith("patch_embed.proj."):
            out["patch_embed.projection." + k[len("patch_embed.proj."):]] = v
        elif k.startswith("patch_embed.norm."):
            out[k] = v
        elif m := re.fullmatch(r"layers\.(\d+)\.blocks\.(\d+)\.(.+)", k):
            for pat, rep in _OFFICIAL_BLOCK:
                if re.match(pat, m.group(3)):
                    out[f"stages.{m.group(1)}.blocks.{m.group(2)}."
                        + re.sub(pat, rep, m.group(3), count=1)] = v
                    break
        elif m := re.fullmatch(r"layers\.(\d+)\.downsample\.(reduction|norm)\.(weight|bias)", k):
            fix = correct_unfold_reduction_order if m.group(2) == "reduction" \
                else correct_unfold_norm_order
            out[f"stages.{m.group(1)}.downsample.{m.group(2)}.{m.group(3)}"] = fix(v)
    return out


def _is_official_swin(sd) -> bool:
    return any(re.match(r"(depth_backbone\.)?layers\.\d+\.blocks\.\d+\.attn\.qkv\.", k)
               for k in sd)


def convert_reference_state_dict(sd: Mapping[str, torch.Tensor]) -> Tensors:
    """A reference state dict (unwrapped, as ``load_torch_file`` gives it)
    -> tensors under the port's full-model names: official Swin names
    remapped, bare backbone weights under ``depth_backbone.``. Names the
    port has no module for pass through; merging skips them."""
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    if any(k.startswith("conv1_rgb.") for k in sd):  # NLSPN: no backbone/head split
        return dict(sd)
    if _is_official_swin(sd):
        pre = "depth_backbone."
        bare = {(k[len(pre):] if k.startswith(pre) else k): v for k, v in sd.items()}
        return {pre + k: v for k, v in convert_swin_official(bare).items()}
    if not any(k.startswith(("depth_backbone.", "depth_head.")) for k in sd) \
            and any(k.startswith(_BACKBONE_ROOTS) for k in sd):
        return {"depth_backbone." + k: v for k, v in sd.items()}
    return dict(sd)


def merge_state_dict(target: Mapping[str, torch.Tensor], converted: Mapping[str, torch.Tensor]
                     ) -> Tuple[Tensors, int]:
    """(the target state dict with every tensor that ``converted`` names
    replaced, the number replaced): ``strict=False`` semantics. A Swin
    relative-position table of another window size is resized; any other
    shape mismatch raises. Values take the target's type."""
    out = dict(target)
    replaced = 0
    for k, v in converted.items():
        if k not in out:
            continue
        want = out[k]
        if k.endswith(_SWIN_TABLE) and v.shape != want.shape and v.shape[1:] == want.shape[1:]:
            v = resize_rel_pos_table(v, want.shape[0])
        if tuple(v.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)}, "
                             f"model {tuple(want.shape)}")
        out[k] = v.to(want.dtype)
        replaced += 1
    return out, replaced


def load_reference_checkpoint(path: str, target: Mapping[str, torch.Tensor],
                              trust_pickle: bool = False) -> Tuple[Tensors, int]:
    """A reference ``.pt`` read, converted and merged over ``target`` (a
    model's ``state_dict()``): (the new state dict, tensors replaced)."""
    converted = convert_reference_state_dict(load_torch_file(path, trust_pickle))
    return merge_state_dict(target, converted)
