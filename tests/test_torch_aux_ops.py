"""The port's auxiliary helpers against the JAX package's, on inputs drawn
with numpy: the resize helpers (nearest, adaptive max pooling, 2x
bilinear), the padding helpers (``adaptive_pad``, ``PatchEmbed``), the
seven geometry functions, the bins chamfer loss, the refine losses with
their dispatch, and the loss framework's BIN term."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu import losses as jlosses  # noqa: E402
from diffusiondepth_tpu.ops import geometry as jgeo  # noqa: E402
from diffusiondepth_tpu.ops import padding as jpad  # noqa: E402
from diffusiondepth_tpu.ops import resize as jresize  # noqa: E402
from diffusiondepth_tpu_torch import Config  # noqa: E402
from diffusiondepth_tpu_torch import losses as plosses  # noqa: E402
from diffusiondepth_tpu_torch.ops import geometry as pgeo  # noqa: E402
from diffusiondepth_tpu_torch.ops import padding as ppad  # noqa: E402
from diffusiondepth_tpu_torch.ops import resize as presize  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import conv_weight  # noqa: E402

from test_torch_support import module_variables  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("in_hw,out_hw", [((10, 14), (23, 9)), ((7, 5), (7, 11)),
                                          ((16, 24), (4, 6)), ((3, 3), (3, 3))])
def test_resize_helpers_match_jax(in_hw, out_hw):
    """resize_nearest and adaptive_max_pool2d exactly; upsample2x_bilinear
    (both corner modes) within 1e-6 (the same f32 matrices, products in
    another order)."""
    x = _np(0, 2, *in_hw, 3)
    np.testing.assert_array_equal(presize.resize_nearest(_t(x), out_hw).numpy(),
                                  np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw)))
    np.testing.assert_array_equal(
        presize.adaptive_max_pool2d(_t(x), out_hw).numpy(),
        np.asarray(jresize.adaptive_max_pool2d(jnp.asarray(x), out_hw)))
    for ac in (False, True):
        got = presize.upsample2x_bilinear(_t(x), ac)
        assert tuple(got.shape) == (2, 2 * in_hw[0], 2 * in_hw[1], 3)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jresize.upsample2x_bilinear(jnp.asarray(x), ac)),
            rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- padding
@pytest.mark.parametrize("mode", ["corner", "same"])
@pytest.mark.parametrize("hw,k,s,d", [((13, 17), 4, 4, 1), ((9, 9), 3, 2, 2),
                                      ((8, 12), 4, 4, 1), ((5, 11), (3, 5), (1, 2), 1)])
def test_adaptive_pad_matches_jax(hw, k, s, d, mode):
    x = _np(1, 1, *hw, 2)
    got = ppad.adaptive_pad(_t(x), k, s, d, mode)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpad.adaptive_pad(jnp.asarray(x), k, s, d, mode)))


def test_adaptive_pad_unknown_mode_raises():
    with pytest.raises(ValueError):
        ppad.adaptive_pad(torch.zeros(1, 5, 5, 1), 4, 4, mode="reflect")


@pytest.mark.parametrize("pad_mode,use_norm,k,s", [("corner", True, 4, None),
                                                   ("same", True, 3, 2), ("corner", False, 2, 2)])
def test_patch_embed_matches_jax(pad_mode, use_norm, k, s):
    """PatchEmbed (projection conv after adaptive_pad, LayerNorm) with JAX's
    weights (projection kernel -> conv weight, norm scale -> weight):
    within 1e-5."""
    x = _np(2, 2, 13, 17, 3)
    jm = jpad.PatchEmbed(embed_dims=8, kernel_size=k, stride=s, pad_mode=pad_mode,
                         use_norm=use_norm)
    v = module_variables(jm, x, seed=3)
    pm = ppad.PatchEmbed(3, 8, k, s, pad_mode=pad_mode, use_norm=use_norm)
    sd = {"projection.weight": _t(conv_weight(v["params"]["projection"]["kernel"])),
          "projection.bias": _t(v["params"]["projection"]["bias"])}
    if use_norm:
        sd.update({"norm.weight": _t(v["params"]["norm"]["scale"]),
                   "norm.bias": _t(v["params"]["norm"]["bias"])})
    pm.load_state_dict(sd, strict=True)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(_t(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------- geometry
def _rotation(rng, n):
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    return (q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]).astype(np.float32)


def _cams(seed, b=2, n=2, kitti=False):
    """Random rigs: rotations, translations, KITTI-like intrinsics (with a
    translation column when ``kitti``), near-identity augmentation."""
    rng = np.random.RandomState(seed)
    rots = _rotation(rng, b * n).reshape(b, n, 3, 3)
    trans = rng.randn(b, n, 3).astype(np.float32)
    k = np.array([[700.0, 0, 40.0], [0, 700.0, 12.0], [0, 0, 1.0]], np.float32)
    intrins = np.broadcast_to(k, (b, n, 3, 3)).copy()
    if kitti:
        intrins = np.concatenate([intrins, 0.1 * rng.randn(b, n, 3, 1).astype(np.float32)], -1)
    post_rots = (np.eye(3) + 0.05 * rng.randn(b, n, 3, 3)).astype(np.float32)
    post_trans = rng.randn(b, n, 3).astype(np.float32)
    return rots, trans, intrins, post_rots, post_trans


def test_pad_helpers_match_jax():
    a = _np(4, 2, 3)
    for axis in (0, 1):
        np.testing.assert_array_equal(pgeo.pad_ones(_t(a), axis).numpy(),
                                      np.asarray(jgeo.pad_ones(jnp.asarray(a), axis)))
        np.testing.assert_array_equal(pgeo.pad_zeros(_t(a), axis, 2).numpy(),
                                      np.asarray(jgeo.pad_zeros(jnp.asarray(a), axis, 2)))
        np.testing.assert_array_equal(pgeo.pad_constants(_t(a), 7.5, axis, 3).numpy(),
                                      np.asarray(jgeo.pad_constants(jnp.asarray(a), 7.5, axis, 3)))


@pytest.mark.parametrize("kitti,offset,deco", [(False, False, False), (True, True, True)])
def test_frustum_and_unprojection_match_jax(kitti, offset, deco):
    """create_frustum, get_geometry (3x3 and 3x4 intrinsics, with a depth
    offset) and convert_depth_map_to_points (with image decoration):
    within 1e-5 of the largest value (f32 inverses and products)."""
    b, n, d, h, w, ds = 2, 2, 3, 8, 12, 2
    depth = _np(5, b, n, d, h, w, scale=10.0, shift=20.0)
    cams = _cams(6, b, n, kitti)
    jcams = [jnp.asarray(c) for c in cams]
    fr = pgeo.create_frustum(_t(depth), (h * ds, w * ds), ds)
    jfr = jgeo.create_frustum(jnp.asarray(depth), (h * ds, w * ds), ds)
    np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), **TOL)
    off = _np(7, b * n, d, h, w) if offset else None
    geo = pgeo.get_geometry(fr, *[_t(c) for c in cams], offset=None if off is None else _t(off))
    jgeo_ = jgeo.get_geometry(jfr, *jcams, offset=None if off is None else jnp.asarray(off))
    scale = np.abs(np.asarray(jgeo_)).max()
    np.testing.assert_allclose(geo.numpy(), np.asarray(jgeo_), rtol=0, atol=1e-5 * scale)
    img = _np(8, b, n, h, w, 3) if deco else None
    pts = pgeo.convert_depth_map_to_points(_t(depth), (h * ds, w * ds), ds,
                                           *[_t(c) for c in cams],
                                           decoration_img=None if img is None else _t(img))
    jpts = jgeo.convert_depth_map_to_points(jnp.asarray(depth), (h * ds, w * ds), ds, *jcams,
                                            decoration_img=None if img is None
                                            else jnp.asarray(img))
    assert tuple(pts.shape) == jpts.shape == (b, n * d * h * w, 6 if deco else 3)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-5 * scale)


def test_project_lidar_to_cam_matches_jax():
    """uv, depth and the validity mask of random lidar points (some behind
    the camera, some out of frame) equal JAX's: the mask exactly, uv and
    depth within 1e-5 of their largest values."""
    rng = np.random.RandomState(9)
    pts = np.concatenate([rng.randn(200, 2) * 5, rng.rand(200, 1) * 40 - 5,
                          rng.rand(200, 1)], 1).astype(np.float32)
    rots, trans, intrins, post_rots, post_trans = _cams(10, 1, 3)
    args = (rots[0], trans[0], intrins[0], post_rots[0, 0], post_trans[0, 0])
    uv, d, valid = pgeo.project_lidar_to_cam(_t(pts), *[_t(a) for a in args], 24, 80)
    juv, jd, jvalid = jgeo.project_lidar_to_cam(jnp.asarray(pts), *map(jnp.asarray, args), 24, 80)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.float().mean() < 1
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(juv)).max())
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jd)).max())


# ------------------------------------------------------------------ losses
def test_bins_chamfer_loss_matches_jax():
    """Random bin edges against depth maps with invalid pixels, one sample
    all invalid: within 1e-5, weighted."""
    bins = np.sort(np.random.RandomState(11).rand(3, 9).astype(np.float32) * 10, axis=1)
    depth = _np(12, 3, 6, 8, 1, scale=3.0, shift=5.0)
    depth[depth < 4.0] = 0.0
    depth[2] = 0.0
    for weight in (1.0, 0.1):
        np.testing.assert_allclose(
            plosses.bins_chamfer_loss(_t(bins), _t(depth), weight).numpy(),
            np.asarray(jlosses.bins_chamfer_loss(jnp.asarray(bins), jnp.asarray(depth),
                                                 weight)), **TOL)


def _refine_inputs(seed, b=2, h=8, w=12):
    pred = _np(seed, b, h, w, 1, scale=2.0, shift=6.0)
    gt = _np(seed + 1, b, h, w, 1, scale=2.0, shift=6.0)
    gt[gt < 5.0] = 0.0
    return pred, gt


def test_refine_losses_match_jax():
    """l1_depth_loss (with a weight map), depth_smooth_loss (with instance
    masks, and its gradient, stopped across instance edges) and
    shape_reg_loss (some boxes padded away): values within 1e-5, the
    smoothness gradient within 1e-5 of its largest value."""
    pred, gt = _refine_inputs(13)
    wmap = np.abs(_np(15, *pred.shape))
    np.testing.assert_allclose(
        plosses.l1_depth_loss(_t(pred), _t(gt), 0.5, _t(wmap)).numpy(),
        np.asarray(jlosses.l1_depth_loss(jnp.asarray(pred), jnp.asarray(gt), 0.5,
                                         jnp.asarray(wmap))), **TOL)

    img = _np(16, 2, 16, 24, 3)
    masks = np.random.RandomState(17).randint(0, 3, (2, 16, 24, 1)).astype(np.float32)
    jfn = jax.jit(jax.value_and_grad(lambda p: jlosses.depth_smooth_loss(
        p, jnp.asarray(img), jnp.asarray(masks), 2.0)))
    jval, jgrad = jfn(jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    val = plosses.depth_smooth_loss(p, _t(img), _t(masks), 2.0)
    val.backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())
    assert (p.grad == 0).any()  # the stopped edges

    b, h, w = pred.shape[:3]
    cams = _cams(18, b, 1)
    rng = np.random.RandomState(19)
    boxes = np.concatenate([rng.randn(b, 3, 3) * 2, rng.rand(b, 3, 3) * 3 + 0.5,
                            rng.randn(b, 3, 1)], -1).astype(np.float32)
    box_valid = np.array([[True, True, False], [True, False, False]])
    fg = (rng.rand(b, 2 * h, 2 * w, 1) > 0.4).astype(np.float32)
    args = (boxes, box_valid) + cams
    got = plosses.shape_reg_loss(_t(pred), _t(fg), *[_t(a) for a in args], (h, w), 1, 0.7)
    want = jlosses.shape_reg_loss(jnp.asarray(pred), jnp.asarray(fg),
                                  *map(jnp.asarray, args), (h, w), 1, 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_compute_refine_losses_dispatch_matches_jax():
    """The cfg-driven dispatch: each named loss with its cfg weight, extra
    keyword arguments passed only to the functions that take them, an
    unknown loss_func skipped; the same names as JAX's within 1e-5."""
    pred, gt = _refine_inputs(20)
    img = _np(21, 2, 8, 12, 3)
    cfgs = [{"loss_func": "l1_depth_loss", "name": "l1", "weight": 2.0},
            {"loss_func": "depth_smooth_loss", "name": "smooth", "weight": 0.3},
            {"loss_func": "not_a_loss", "name": "skipped"}]
    got = plosses.compute_refine_losses(cfgs, _t(pred), _t(gt), image=_t(img))
    want = jlosses.compute_refine_losses(cfgs, jnp.asarray(pred), jnp.asarray(gt),
                                         image=jnp.asarray(img))
    assert sorted(got) == sorted(want) == ["l1", "smooth"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    assert sorted(plosses.depth_loss_dict) == sorted(jlosses.depth_loss_dict)
    assert sorted(plosses.__all__) == sorted(jlosses.__all__)


def test_bin_term_matches_jax():
    """'1.0*L1+0.5*BIN': the BIN term is the sum of output['bin_losses'];
    the loss row equals JAX's within 1e-5."""
    pred, gt = _refine_inputs(22)
    bins = {"chamfer": np.float32(0.7), "aux": np.float32(0.25)}
    kw = dict(loss="1.0*L1+0.5*BIN")
    jsum, jrow = jlosses.LossComputer(dataclasses.replace(jconfig.Config(), **kw))(
        {"gt": jnp.asarray(gt)}, {"pred": jnp.asarray(pred),
                                  "bin_losses": {k: jnp.asarray(v) for k, v in bins.items()}})
    psum, prow = plosses.LossComputer(Config(**kw).finalize())(
        {"gt": _t(gt)}, {"pred": _t(pred), "bin_losses": {k: _t(v) for k, v in bins.items()}})
    np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), **TOL)
    np.testing.assert_allclose(psum.numpy(), np.asarray(jsum), **TOL)
    assert abs(float(prow[0, 1]) - 0.5 * 0.95) < 1e-6
