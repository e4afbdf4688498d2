"""Camera and lidar geometry (port of ``diffusiondepth_tpu/ops/geometry.py``):
the pixel frustum and its unprojection to the ego frame, consumed by the
shape-regularisation loss; lidar projection into the image planes with
validity masks; and the pad helpers. Static shapes: out-of-frame lidar
points are zeroed and masked, not dropped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pad(arr: torch.Tensor, value, axis: int, n: int) -> torch.Tensor:
    shape = list(arr.shape)
    shape[axis] = n
    return torch.cat([arr, torch.full(shape, value, dtype=arr.dtype, device=arr.device)],
                     dim=axis)


def pad_ones(arr: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return _pad(arr, 1, axis, 1)


def pad_zeros(arr: torch.Tensor, axis: int = 0, n: int = 1) -> torch.Tensor:
    return _pad(arr, 0, axis, n)


def pad_constants(arr: torch.Tensor, value, axis: int = 0, n: int = 1) -> torch.Tensor:
    return _pad(arr, value, axis, n)


def create_frustum(depth_map: torch.Tensor, input_size: Tuple[int, int],
                   downsample: int) -> torch.Tensor:
    """(B, N_cam, D, fH, fW) depths -> (B, N_cam, D, fH, fW, 3) triplets
    (x_px, y_px, depth) on the full-resolution pixel grid."""
    b, n_cam, d, fh, fw = depth_map.shape
    ogf_h, ogf_w = input_size
    assert fh == ogf_h // downsample and fw == ogf_w // downsample
    ds = torch.clamp(depth_map, min=0.0)
    kw = dict(dtype=ds.dtype, device=ds.device)
    xs = torch.linspace(0.0, ogf_w - 1, fw, **kw).reshape(1, 1, 1, 1, fw).expand(ds.shape)
    ys = torch.linspace(0.0, ogf_h - 1, fh, **kw).reshape(1, 1, 1, fh, 1).expand(ds.shape)
    return torch.stack([xs, ys, ds], dim=-1)


def get_geometry(frustum: torch.Tensor, rots: torch.Tensor, trans: torch.Tensor,
                 intrins: torch.Tensor, post_rots: torch.Tensor, post_trans: torch.Tensor,
                 offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frustum pixels -> ego-frame xyz. rots/trans (B, N, 3, 3)/(B, N, 3)
    cam -> ego; intrins (B, N, 3, 3), or (B, N, 3, 4) with KITTI's
    translation column; post_rots/post_trans undo the image augmentation."""
    b, n = trans.shape[:2]
    pts = frustum - post_trans.reshape(b, n, 1, 1, 1, 3)
    if offset is not None:
        _, d, h, w = offset.shape
        pts = torch.cat([pts[..., :2], pts[..., 2:] + offset.reshape(b, n, d, h, w, 1)], -1)
    inv_post = torch.linalg.inv(post_rots).reshape(b, n, 1, 1, 1, 3, 3)
    pts = inv_post @ pts[..., None]
    pts = torch.cat([pts[..., :2, :] * pts[..., 2:3, :], pts[..., 2:3, :]], dim=-2)
    if intrins.shape[-1] == 4:
        pts = pts - intrins[..., :3, 3].reshape(b, n, 1, 1, 1, 3, 1)
        intrins = intrins[..., :3, :3]
    combine = rots @ torch.linalg.inv(intrins)
    pts = (combine.reshape(b, n, 1, 1, 1, 3, 3) @ pts)[..., 0]
    return pts + trans.reshape(b, n, 1, 1, 1, 3)


def convert_depth_map_to_points(depth: torch.Tensor, input_size: Tuple[int, int],
                                downsample: int, rots: torch.Tensor, trans: torch.Tensor,
                                intrins: torch.Tensor, post_rots: torch.Tensor,
                                post_trans: torch.Tensor,
                                decoration_img: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N_cam, D, H, W) depth -> (B, N*D*H*W, 3[+3]) ego-frame points
    (the batch index is the leading axis)."""
    geom = get_geometry(create_frustum(depth, input_size, downsample), rots, trans,
                        intrins, post_rots, post_trans)
    if decoration_img is not None:
        b, n_cam, d, h, w, _ = geom.shape
        deco = decoration_img.reshape(b, n_cam, 1, h, w, 3).expand(b, n_cam, d, h, w, 3)
        geom = torch.cat([geom, deco], dim=-1)
    return geom.reshape(geom.shape[0], -1, geom.shape[-1])


def project_lidar_to_cam(pts: torch.Tensor, rots: torch.Tensor, trans: torch.Tensor,
                         intrins: torch.Tensor, post_rots: torch.Tensor,
                         post_trans: torch.Tensor, height: int, width: int,
                         max_depth: float = 1e9
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ego-frame lidar points (P, 3+) into each camera, rots/trans
    (N_cam, 3, 3)/(N_cam, 3) cam -> ego. Returns uv (N_cam, P, 2), depth
    (N_cam, P) and valid (N_cam, P); invalid uv are zeroed."""
    inv_rots = torch.linalg.inv(rots)
    cam_pts = (torch.einsum("nij,pj->npi", inv_rots, pts[:, :3])
               - torch.einsum("nij,nj->ni", inv_rots, trans)[:, None, :])
    depth = cam_pts[..., 2]
    uvw = torch.einsum("nij,npj->npi", intrins[..., :3, :3], cam_pts)
    z = uvw[..., 2:]
    uv = uvw[..., :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    uv = torch.einsum("ij,npj->npi", post_rots[:2, :2], uv) + post_trans[:2]
    valid = ((depth > 0) & (depth <= max_depth)
             & (uv[..., 0] >= 0) & (uv[..., 0] < width)
             & (uv[..., 1] >= 0) & (uv[..., 1] < height)
             & torch.isfinite(uv).all(-1))
    uv = torch.where(valid[..., None], uv, torch.zeros_like(uv))
    return uv, depth, valid
