"""Deformable convolution (DCN v1/v2) and deformable PS-RoI pooling, NHWC
(port of ``diffusiondepth_tpu/ops/deform_conv.py``).

Plain PyTorch: per-tap bilinear reads (``msda.bilinear_sample_nhwc``)
build the deformable im2col columns and one einsum does the product, so
autograd gives the gradients of the input, the offsets, the mask and the
weight. The JAX package computes this outside any Pallas kernel; the
reference ran its DCNv2 CUDA extension.

Channel conventions are DCNv2's: per deformable group and tap k,
``offset[..., 2k]`` is dy and ``offset[..., 2k + 1]`` is dx. Weights are
HWIO, (kh, kw, Cin // groups, Cout), as in the JAX functions; the
``nn.Module`` wrappers (``deform_conv_modules.py``) keep the reference's
(Cout, Cin // groups, kh, kw) and convert at this boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .msda import bilinear_sample_nhwc


def _out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def deform_im2col(x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
                  kernel: Tuple[int, int], stride: int = 1, padding: int = 0,
                  dilation: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """Deformable im2col: returns columns (B, Ho, Wo, K, C).

    x: (B, H, W, C); offset: (B, Ho, Wo, dg * K * 2), (dy, dx) pairs per tap
    and deformable group; mask: (B, Ho, Wo, dg * K) modulation, or None
    (DCN v1)."""
    b, h, w, c = x.shape
    kh, kw = kernel
    K = kh * kw
    dg = deformable_groups
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    if tuple(offset.shape) != (b, ho, wo, dg * K * 2):
        raise ValueError(f"offset {tuple(offset.shape)} != {(b, ho, wo, dg * K * 2)}")
    if c % dg:
        raise ValueError(f"{c} channels in {dg} deformable groups")

    dev = x.device
    oy = torch.arange(ho, device=dev) * stride - padding
    ox = torch.arange(wo, device=dev) * stride - padding
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(ho, wo, kh, kw)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(ho, wo, kh, kw)
    base_y = base_y.reshape(ho, wo, K)
    base_x = base_x.reshape(ho, wo, K)

    off = offset.reshape(b, ho, wo, dg, K, 2).float()
    ys = base_y[None, :, :, None, :] + off[..., 0]  # (B, Ho, Wo, dg, K)
    xs = base_x[None, :, :, None, :] + off[..., 1]

    cols = []
    cpg = c // dg
    for g in range(dg):
        img = x[..., g * cpg:(g + 1) * cpg]
        q_y = ys[:, :, :, g].reshape(b, ho * wo * K)
        q_x = xs[:, :, :, g].reshape(b, ho * wo * K)
        sampled = bilinear_sample_nhwc(img, q_x, q_y)  # (B, Ho*Wo*K, cpg)
        cols.append(sampled.reshape(b, ho, wo, K, cpg))
    col = torch.cat(cols, dim=-1) if dg > 1 else cols[0]

    if mask is not None:
        # the modulation scales its deformable group's channel slice
        m = mask.reshape(b, ho, wo, dg, K).permute(0, 1, 2, 4, 3)  # (..., K, dg)
        col = col.reshape(b, ho, wo, K, dg, cpg) * m[..., None]
        col = col.reshape(b, ho, wo, K, dg * cpg)
    return col


def _columns_times_weight(col: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, Ho, Wo, K, Cin) columns times an HWIO weight -> (B, Ho, Wo, Cout)."""
    kh, kw, cin_g, cout = weight.shape
    b, ho, wo, K, cin = col.shape
    if cin != cin_g * groups:
        raise ValueError(f"{cin} input channels, weight takes {cin_g} x {groups} groups")
    w = weight.reshape(kh * kw, cin_g, cout)
    dt = torch.promote_types(col.dtype, w.dtype)
    col, w = col.to(dt), w.to(dt)
    if groups == 1:
        return torch.einsum("bhwkc,kcf->bhwf", col, w)
    col_g = col.reshape(b, ho, wo, K, groups, cin_g)
    w_g = w.reshape(K, cin_g, groups, cout // groups)
    return torch.einsum("bhwkgc,kcgf->bhwgf", col_g, w_g).reshape(b, ho, wo, cout)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 0, dilation: int = 1,
                          groups: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """DCNv2 forward: weight (kh, kw, Cin // groups, Cout). Returns
    (B, Ho, Wo, Cout)."""
    kh, kw = weight.shape[:2]
    col = deform_im2col(x, offset, mask, (kh, kw), stride, padding, dilation,
                        deformable_groups)
    out = _columns_times_weight(col, weight, groups)
    return out if bias is None else out + bias


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 0,
                dilation: int = 1, groups: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """DCN v1 (no modulation)."""
    kh, kw = weight.shape[:2]
    col = deform_im2col(x, offset, None, (kh, kw), stride, padding, dilation,
                        deformable_groups)
    out = _columns_times_weight(col, weight, groups)
    return out if bias is None else out + bias


def deform_psroi_pooling(x: torch.Tensor, rois: torch.Tensor, offset: Optional[torch.Tensor],
                         out_size: int, spatial_scale: float = 1.0, sampling_ratio: int = 2,
                         gamma: float = 0.1) -> torch.Tensor:
    """Deformable position-sensitive RoI pooling.

    x: (B, H, W, C) with C = out_size^2 * c_out position-sensitive maps;
    rois: (R, 5) rows [batch_idx, x1, y1, x2, y2]; offset: (R, out_size,
    out_size, 2) normalised part offsets, or None. Returns (R, out_size,
    out_size, c_out)."""
    b, h, w, c = x.shape
    p = out_size
    c_out = c // (p * p)
    r = rois.shape[0]
    dev = x.device

    batch_idx = rois[:, 0].long()
    x1 = rois[:, 1] * spatial_scale - 0.5
    y1 = rois[:, 2] * spatial_scale - 0.5
    x2 = rois[:, 3] * spatial_scale - 0.5
    y2 = rois[:, 4] * spatial_scale - 0.5
    roi_w = torch.clamp_min(x2 - x1, 0.1)
    roi_h = torch.clamp_min(y2 - y1, 0.1)
    bin_w = roi_w / p  # (R,)
    bin_h = roi_h / p
    s = sampling_ratio

    # the sample grid inside each bin: (p, p, s, s)
    ar_p = torch.arange(p, device=dev, dtype=torch.float32)
    ar_s = torch.arange(s, device=dev, dtype=torch.float32)
    iy = (ar_p[:, None, None, None] + (ar_s[None, None, :, None] + 0.5) / s).expand(p, p, s, s)
    ix = (ar_p[None, :, None, None] + (ar_s[None, None, None, :] + 0.5) / s).expand(p, p, s, s)

    def per_roi(v):
        return v[:, None, None, None, None]

    ys = per_roi(y1) + iy[None] * per_roi(bin_h)
    xs = per_roi(x1) + ix[None] * per_roi(bin_w)
    if offset is not None:
        ys = ys + gamma * per_roi(roi_h) * offset[..., 1][..., None, None]
        xs = xs + gamma * per_roi(roi_w) * offset[..., 0][..., None, None]

    # read each RoI's own image; position-sensitive channel selection
    x_ps = x.reshape(b, h, w, p * p, c_out)
    out = []
    for pi in range(p):
        for pj in range(p):
            img_r = x_ps[:, :, :, pi * p + pj][batch_idx]  # (R, H, W, c_out)
            q_y = ys[:, pi, pj].reshape(r, s * s)
            q_x = xs[:, pi, pj].reshape(r, s * s)
            sampled = bilinear_sample_nhwc(img_r, q_x, q_y)  # (R, s*s, c_out)
            out.append(sampled.mean(dim=1))
    return torch.stack(out, dim=1).reshape(r, p, p, c_out)
