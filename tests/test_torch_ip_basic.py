"""The port's depth-completion helpers (``data/depth_completion.py``) and
ip_basic (``data/ip_basic.py``) against the JAX package's, which run
OpenCV where it is installed (it is here), on random sparse maps at NYU's
228x304 crop and KITTI's 352x1216.

Tolerances: the kernels, dilation, closing, the median and the noise
filters, the numpy and C++ scanline completions: exact. The bilateral
filter: within 1e-5 of each pixel's value (OpenCV's SIMD loop sums in
another order and with fused multiply-adds; measured ~1e-6). The
Gaussian blur: 1e-5 of the value range (the separable sums run in
another order). ``densify_depth_map`` and the two fill functions: 5e-4 m
with the same set of filled pixels (the bilateral filter's differences,
~5e-5 m measured).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffusiondepth_tpu.data import depth_completion as JDC  # noqa: E402
from diffusiondepth_tpu.data import ip_basic as JIP  # noqa: E402
from diffusiondepth_tpu_torch.data import depth_completion as DC  # noqa: E402
from diffusiondepth_tpu_torch.data import ip_basic as IP  # noqa: E402

SHAPES = {"nyu": (228, 304), "kitti": (352, 1216)}
assert JIP._HAS_CV2  # the JAX route under test is OpenCV's


def _sparse(shape, density, seed, hi=80.0):
    r = np.random.RandomState(seed)
    d = np.zeros(shape, np.float32)
    m = r.rand(*shape) < density
    d[m] = r.uniform(0.5, hi, m.sum()).astype(np.float32)
    return d


def _dense(shape, seed):
    """A depth image after the first dilations: mostly filled, with holes."""
    d = _sparse(shape, 0.5, seed)
    return np.where(d > 0, 100.0 - d, 0.0).astype(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_morphology_and_median_bit_equal(shape):
    x = _dense(SHAPES[shape], 0)
    kernels = [IP._kernel_full(5), IP._kernel_full(7), IP._kernel_full(9), IP._kernel_full(31),
               IP._kernel_cross(3), IP._kernel_cross(5), IP._kernel_cross(7),
               IP._kernel_diamond(5)]
    for ours, ref in zip((IP._kernel_full(5), IP._kernel_cross(7), IP._kernel_diamond(5)),
                         (JIP._kernel_full(5), JIP._kernel_cross(7), JIP._kernel_diamond(5))):
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    for k in kernels:
        assert np.array_equal(IP._dilate(x, k), cv2.dilate(x, k))
        assert np.array_equal(IP._close(x, k), cv2.morphologyEx(x, cv2.MORPH_CLOSE, k))
    assert np.array_equal(IP._median5(x), cv2.medianBlur(x, 5))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("args", [(5, 0.5, 2.0), (5, 1.5, 2.0), (7, 3.0, 1.0), (0, 2.0, 3.0)])
def test_bilateral_matches_opencv(shape, args):
    x = _dense(SHAPES[shape], 1)
    ours, ref = IP._bilateral(x, *args), cv2.bilateralFilter(x, *args)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert (np.abs(ours - ref) <= 1e-5 * np.maximum(np.abs(ref), 1.0)).all()
    flat = np.full((8, 9), 3.0, np.float32)  # max - min below FLT_EPSILON: the source
    assert np.array_equal(IP._bilateral(flat, *args), flat)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_gaussian_matches_opencv(k):
    x = _dense(SHAPES["nyu"], 2)
    ours, ref = IP._gaussian(x, k), cv2.GaussianBlur(x, (k, k), 0)
    assert np.abs(ours - ref).max() <= 1e-5 * float(x.max())
    with pytest.raises(NotImplementedError, match="GaussianBlur of size 9"):
        IP._gaussian(x, 9)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_densify_depth_map_matches_jax(shape):
    """The datasets' --ip_basic hook, (H, W) and (H, W, 1), against the JAX
    package's on the OpenCV route."""
    for seed, density in ((0, 0.05), (1, 0.01)):
        d = _sparse(SHAPES[shape], density, seed)
        mask = (d > 0).astype(np.float32)
        ours, ref = IP.densify_depth_map(d, mask), JIP.densify_depth_map(d, mask)
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
        assert np.array_equal(ours > 0, ref > 0) and np.array_equal(ours > 0.1, ref > 0.1)
        assert np.abs(ours - ref).max() <= 5e-4
        ours3 = IP.densify_depth_map(d[..., None], mask[..., None])
        assert ours3.shape == d.shape + (1,) and np.array_equal(ours3[..., 0], ours)


@pytest.mark.parametrize("kw", [dict(), dict(extrapolate=True), dict(blur_type="gaussian"),
                                dict(blur_type="none", max_depth=90.0)])
def test_fill_functions_match_jax(kw):
    d = _sparse(SHAPES["nyu"], 0.04, 3)
    ours, ref = IP.fill_in_fast(d, **kw), JIP.fill_in_fast(d, **kw)
    assert np.array_equal(ours > 0.1, ref > 0.1) and np.abs(ours - ref).max() <= 5e-4
    ours, ref = IP.fill_in_multiscale(d, **kw)[0], JIP.fill_in_multiscale(d, **kw)[0]
    assert np.array_equal(ours > 0.1, ref > 0.1) and np.abs(ours - ref).max() <= 5e-4
    assert np.array_equal(IP._top_mask(d), JIP._top_mask(d))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scanline_completion_and_noise_filters_match_jax(shape):
    """The C++ completion, its numpy twin and the four noise filters,
    exactly."""
    d = _sparse(SHAPES[shape], 0.05, 4)
    ours, dist = DC.simple_depth_completion(d)
    ref, ref_dist = JDC.simple_depth_completion_numpy(d)
    assert np.array_equal(ours, ref) and np.array_equal(dist, ref_dist)
    ours, dist = DC.simple_depth_completion_numpy(d)
    assert np.array_equal(ours, ref) and np.array_equal(dist, ref_dist)
    for name, kw in (("simple_noise_filter", {}), ("simple_noise_filter", dict(lambda_=1.2)),
                     ("simple_noise_filter_0", {}), ("simple_noise_filter_2", {}),
                     ("simple_noise_filter_3", {}), ("simple_noise_filter_3", dict(size=5))):
        ours, ref = getattr(DC, name)(d, **kw), getattr(JDC, name)(d, **kw)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name
    img = _dense((40, 30), 5)
    assert np.array_equal(DC._erode_vertical(img, 3, -1.0), JDC._erode_vertical(img, 3, -1.0))


def test_completion_without_compiler_raises(monkeypatch):
    """No C++ compiler: the completion raises instead of taking numpy."""
    from diffusiondepth_tpu_torch.native import depthops

    monkeypatch.setattr(depthops, "_lib", None)
    monkeypatch.setattr(depthops, "lib_path", lambda: depthops.BUILD_DIR / "missing.so")
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(depthops.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        DC.simple_depth_completion(np.zeros((4, 4), np.float32))
