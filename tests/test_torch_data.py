"""The port's data layer against the JAX package's, on a small KITTI-DC
tree written with Pillow: the PNG reader and writer against Pillow, each
transform against ``diffusiondepth_tpu.data.transforms`` (which is
Pillow), KITTIDC samples in every mode, the loader and Synthetic.

Tolerances: depth maps, K, masks, loader order and seeds, Synthetic and
decoded PNGs exact; RGB within one uint8 level per pixel (measured on
these inputs: no pixel differs, the port reproduces Pillow's arithmetic).
"""

import io
import json
import os
import random
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from diffusiondepth_tpu.config import Config as JConfig
from diffusiondepth_tpu.data import DataLoader as JDataLoader, get as jget
from diffusiondepth_tpu.data import transforms as JT
from diffusiondepth_tpu.data.depth_completion import simple_depth_completion_numpy
from diffusiondepth_tpu.data.kittidc import read_calib_file as j_read_calib
from diffusiondepth_tpu.data.kittidc import read_depth as j_read_depth
from diffusiondepth_tpu_torch.config import Config
from diffusiondepth_tpu_torch.data import DataLoader, get
from diffusiondepth_tpu_torch.data import transforms as T
from diffusiondepth_tpu_torch.data.kittidc import read_calib_file, read_depth
from diffusiondepth_tpu_torch.data.loader import sample_seed
from diffusiondepth_tpu_torch.native import depthops
from diffusiondepth_tpu_torch.native.png import decode_png, encode_png

H, W = 60, 200  # raw frames; crops of 48 x 160
RGB_TOL = 1.0 / 255.0 / 0.224 + 1e-6  # one uint8 level after normalisation


def _smooth_rgb(rng, h, w):
    base = rng.rand(h // 8 + 2, w // 8 + 2, 3)
    x = np.kron(base, np.ones((8, 8, 1)))[:h, :w] * 255 + rng.randn(h, w, 3) * 20
    return np.clip(x, 0, 255).astype(np.uint8)


def _sparse_depth16(rng, h, w, n):
    d = np.zeros((h, w), np.uint16)
    d[rng.randint(0, h, n), rng.randint(0, w, n)] = rng.randint(256, 20000, n)
    return d


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """A small KITTI-DC tree written with Pillow: 4 drives (image_02 and
    image_03), calib files, single-line test intrinsics, a split JSON."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.RandomState(0)
    entries = []
    for i in range(4):
        cam = "image_02" if i % 2 == 0 else "image_03"
        d = root / f"train/drive_{i:04d}"
        os.makedirs(d / cam, exist_ok=True)
        Image.fromarray(_smooth_rgb(rng, H, W)).save(d / cam / "0000000000.png")
        for sub in ("velodyne_raw", "groundtruth"):
            os.makedirs(d / sub, exist_ok=True)
            Image.fromarray(_sparse_depth16(rng, H, W, 600)).save(d / sub / "0000000000.png")
        p = ("7.2154e+02 0.0 6.0956e+02 4.4857e+01 0.0 7.2154e+02 1.7285e+02 2.1638e-01 "
             "0.0 0.0 1.0 2.7459e-03")
        q = p.replace("6.0956e+02", "6.1012e+02")
        (d / "calib_cam_to_cam.txt").write_text(
            f"calib_time: 09-Jan-2012 13:57:47\nP_rect_02: {p}\nP_rect_03: {q}\n")
        entries.append({"rgb": f"train/drive_{i:04d}/{cam}/0000000000.png",
                        "depth": f"train/drive_{i:04d}/velodyne_raw/0000000000.png",
                        "gt": f"train/drive_{i:04d}/groundtruth/0000000000.png",
                        "K": f"train/drive_{i:04d}/calib_cam_to_cam.txt"})
    (root / "intrinsics.txt").write_text("721.54 0.0 609.56 0.0 721.54 172.85 0.0 0.0 1.0\n")
    split = {"train": entries, "val": entries[:2],
             "test": [dict(e, K="intrinsics.txt") for e in entries[:3]]}
    (root / "split.json").write_text(json.dumps(split))
    return root


# ----------------------------------------------------------------- PNG
def _filtered_png(arr, ftype, depth, ctype):
    """A PNG of ``arr`` with every row under filter ``ftype`` (0-4),
    encoded here so that each filter is exercised."""
    h, w = arr.shape[:2]
    raw = (arr.astype(">u2").view(np.uint8) if depth == 16 else arr).reshape(h, -1)
    raw = raw.astype(np.int64)
    bpp = raw.shape[1] // w
    rows = []
    prev = np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            out = cur
        elif ftype == 1:
            out = cur - left
        elif ftype == 2:
            out = cur - prev
        elif ftype == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            out = cur - pred
        rows.append(bytes([ftype]) + (out % 256).astype(np.uint8).tobytes())
        prev = cur
    return _png(w, h, depth, ctype, zlib.compress(b"".join(rows)))


def _png(w, h, depth, ctype, idat, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat)
            + chunk(b"IEND", b""))


KINDS = {  # name -> (array maker, bit depth, colour type)
    "rgb8": (lambda r: (r.rand(13, 17, 3) * 256).astype(np.uint8), 8, 2),
    "rgba8": (lambda r: (r.rand(13, 17, 4) * 256).astype(np.uint8), 8, 6),
    "gray8": (lambda r: (r.rand(13, 17) * 256).astype(np.uint8), 8, 0),
    "gray16": (lambda r: (r.rand(13, 17) * 65536).astype(np.uint16), 16, 0),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("ftype", range(5))
def test_png_decode_each_filter_matches_pillow(kind, ftype):
    make, depth, ctype = KINDS[kind]
    arr = make(np.random.RandomState(ftype))
    data = _filtered_png(arr, ftype, depth, ctype)
    ref = np.array(Image.open(io.BytesIO(data)))
    got = decode_png(data)
    assert got.dtype == ref.dtype and np.array_equal(got, ref) and np.array_equal(got, arr)


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_png_writer_and_pillow_files(kind):
    """The port's writer read back by Pillow, and Pillow's files (its own
    filter choice) read by the port, both exact."""
    arr = KINDS[kind][0](np.random.RandomState(7))
    assert np.array_equal(np.array(Image.open(io.BytesIO(encode_png(arr)))), arr)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    assert np.array_equal(decode_png(buf.getvalue()), arr)


def _pillow_png(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["palette", "gray_alpha", "one_bit", "rgb16",
                                  "interlaced", "bad_crc", "not_png"])
def test_png_unsupported_kinds_raise(kind):
    """Every kind the reader does not take raises; nothing falls back."""
    r = np.random.RandomState(1)
    data = {
        "palette": lambda: _pillow_png(Image.fromarray(KINDS["rgb8"][0](r)).convert("P")),
        "gray_alpha": lambda: _pillow_png(Image.fromarray(KINDS["rgb8"][0](r)).convert("LA")),
        "one_bit": lambda: _pillow_png(Image.fromarray(KINDS["gray8"][0](r)).convert("1")),
        "rgb16": lambda: _png(4, 4, 16, 2, zlib.compress(bytes(4 * 25))),
        "interlaced": lambda: _png(4, 4, 8, 0, zlib.compress(bytes(4 * 5)), interlace=1),
        "bad_crc": lambda: encode_png(KINDS["gray8"][0](r))[:-1] + b"\0",
        "not_png": lambda: b"GIF89a" + bytes(40),
    }[kind]()
    with pytest.raises(ValueError):
        decode_png(data)


def test_png_writer_refuses_other_arrays():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.uint16))


def test_read_depth_and_calib_match_jax(kitti_root):
    d = kitti_root / "train/drive_0001"
    for sub in ("velodyne_raw", "groundtruth"):
        p = str(d / sub / "0000000000.png")
        a, b = read_depth(p), j_read_depth(p)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = read_calib_file(str(d / "calib_cam_to_cam.txt")), j_read_calib(
        str(d / "calib_cam_to_cam.txt"))
    assert a.keys() == b.keys() == {"P_rect_02", "P_rect_03"}
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_scanline_completion_matches_jax():
    """The C++ copy of the NYU scanline completion against the JAX
    package's numpy version, exactly."""
    rng = np.random.RandomState(0)
    depth = np.zeros((20, 30), np.float32)
    depth[rng.randint(0, 20, 40), rng.randint(0, 30, 40)] = rng.uniform(1, 50, 40)
    ours, dist = depthops.simple_depth_completion(depth)
    ref, ref_dist = simple_depth_completion_numpy(depth)
    assert np.array_equal(ours, ref) and np.array_equal(dist, ref_dist)
    batch = depthops.simple_depth_completion_batch(np.stack([depth, depth[::-1]]))
    assert np.array_equal(batch[1], simple_depth_completion_numpy(depth[::-1])[0])


# ------------------------------------------------------------ transforms
@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(3)
    rgb = _smooth_rgb(rng, 75, 124)
    dep = np.zeros((75, 124), np.float32)
    m = rng.rand(75, 124) < 0.05
    dep[m] = rng.rand(m.sum()).astype(np.float32) * 80
    return rgb, dep


def _rgb_close(got, pil):
    ref = np.asarray(pil)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("angle", [-4.7, -1.3, 0.0, 0.01, 2.2, 4.99, 180.0, 90.0, -90.0])
def test_rotate_matches_pillow(images, angle):
    rgb, dep = images
    if abs(angle) == 90:  # Pillow transposes a square image at 90 and 270
        rgb, dep = rgb[:64, :64], dep[:64, :64]
    _rgb_close(T.rotate(rgb, angle, T.BICUBIC), JT.rotate(Image.fromarray(rgb), angle, JT.BICUBIC))
    ref = np.asarray(JT.rotate(Image.fromarray(dep, mode="F"), angle, JT.NEAREST))
    assert np.array_equal(T.rotate(dep, angle, T.NEAREST), ref)


@pytest.mark.parametrize("size", [75, 76, 88, 99, 112, 40])
def test_resize_shorter_matches_pillow(images, size):
    rgb, dep = images
    _rgb_close(T.resize_shorter(rgb, size, T.BICUBIC),
               JT.resize_shorter(Image.fromarray(rgb), size, JT.BICUBIC))
    ref = np.asarray(JT.resize_shorter(Image.fromarray(dep, mode="F"), size, JT.NEAREST))
    assert np.array_equal(T.resize_shorter(dep, size, T.NEAREST), ref)


@pytest.mark.parametrize("factor", [0.0, 0.6, 0.93, 1.0, 1.17, 1.4])
def test_colour_adjustments_match_pillow(images, factor):
    rgb = images[0]
    for name in ("adjust_brightness", "adjust_contrast", "adjust_saturation"):
        _rgb_close(getattr(T, name)(rgb, factor), getattr(JT, name)(Image.fromarray(rgb), factor))


def test_flip_crop_jitter_and_arrays_match(images):
    rgb, dep = images
    assert np.array_equal(T.hflip(rgb), np.asarray(JT.hflip(Image.fromarray(rgb))))
    for box in ((3, 5, 40, 60), (-2, 100, 30, 40), (70, 0, 10, 10)):
        assert np.array_equal(T.crop(dep, *box), np.asarray(
            JT.crop(Image.fromarray(dep, mode="F"), *box)))
        assert np.array_equal(T.crop(rgb, *box), np.asarray(JT.crop(Image.fromarray(rgb), *box)))
    for seed in range(4):
        _rgb_close(T.color_jitter(rgb, 0.4, 0.4, 0.4, random.Random(seed)),
                   JT.color_jitter(Image.fromarray(rgb), 0.4, 0.4, 0.4, random.Random(seed)))
    assert np.array_equal(T.rgb_to_normalized_array(rgb),
                          JT.rgb_to_normalized_array(Image.fromarray(rgb)))
    assert np.array_equal(T.depth_to_array(dep), JT.depth_to_array(Image.fromarray(dep, mode="F")))
    d3 = dep[..., None]
    for n in (0, 10, 10_000):
        assert np.array_equal(T.sparse_sample(d3, n, random.Random(5)),
                              JT.sparse_sample(d3, n, random.Random(5)))


def test_unsupported_resampling_raises(images):
    with pytest.raises(NotImplementedError):
        T.rotate(images[1], 3.0, T.BICUBIC)
    with pytest.raises(NotImplementedError):
        T.resize(images[0], 50, 30, 1)  # Pillow's LANCZOS
    with pytest.raises(NotImplementedError):
        T.resize(images[1].astype(np.float64), 50, 30, T.BILINEAR)


# ------------------------------------------------------------- KITTIDC
MODES = {  # name -> (split, config overrides)
    "train_augment": ("train", dict(augment=True)),
    "train_augment_sparse": ("train", dict(augment=True, num_sample=200)),
    "train_crop": ("train", dict(augment=False)),
    "val": ("val", dict()),
    "test": ("test", dict()),
    "test_crop": ("test", dict(test_crop=True)),
    "test_sparse": ("test", dict(num_sample=100)),
}


def _configs(root, **kw):
    common = dict(data_name="KITTIDC", dir_data=str(root), split_json=str(root / "split.json"),
                  patch_height=48, patch_width=160, top_crop=4, **kw)
    return Config(**common).finalize(), JConfig(**common).finalize()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kittidc_samples_match_jax(kitti_root, mode):
    """The same dataset index and seed give the same sample in both
    packages: K, dep, gt, depth_mask and depth_map exactly, rgb within one
    level."""
    split, kw = MODES[mode]
    pcfg, jcfg = _configs(kitti_root, **kw)
    ds, jds = get(pcfg)(pcfg, split), jget(jcfg)(jcfg, split)
    assert len(ds) == len(jds)
    for idx in range(len(ds)):
        for seed in (3, 11):
            a, b = ds.__getitem__(idx, seed=seed), jds.__getitem__(idx, seed=seed)
            assert a.keys() == b.keys()
            for k in ("K", "dep", "gt", "depth_mask", "depth_map"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (mode, idx, k)
            assert a["rgb"].shape == b["rgb"].shape
            assert np.abs(a["rgb"] - b["rgb"]).max() <= RGB_TOL


@pytest.mark.parametrize("mode", ["train_augment_sparse", "val", "test"])
def test_kittidc_ip_basic_matches_jax(kitti_root, mode):
    """--ip_basic densifies depth_map as JAX's does (OpenCV's route): within
    5e-4 m, the same filled pixels; every other key exactly."""
    split, kw = MODES[mode]
    pcfg, jcfg = _configs(kitti_root, ip_basic=True, **kw)
    ds, jds = get(pcfg)(pcfg, split), jget(jcfg)(jcfg, split)
    for idx in range(len(ds)):
        a, b = ds.__getitem__(idx, seed=5), jds.__getitem__(idx, seed=5)
        for k in ("K", "dep", "gt", "depth_mask"):
            assert np.array_equal(a[k], b[k]), (mode, idx, k)
        assert np.abs(a["rgb"] - b["rgb"]).max() <= RGB_TOL
        dm, jdm = a["depth_map"], b["depth_map"]
        assert dm.shape == jdm.shape == a["dep"].shape and (dm > 0).mean() > (a["dep"] > 0).mean()
        assert np.array_equal(dm > 0, jdm > 0) and np.abs(dm - jdm).max() <= 5e-4


def test_synthetic_ip_basic_matches_jax():
    kw = dict(data_name="Synthetic", patch_height=32, patch_width=48, ip_basic=True)
    pcfg, jcfg = Config(**kw).finalize(), JConfig(**kw).finalize()
    ds, jds = get(pcfg)(pcfg, "train"), jget(jcfg)(jcfg, "train")
    for idx, seed in ((0, None), (3, 17)):
        a, b = ds.__getitem__(idx, seed=seed), jds.__getitem__(idx, seed=seed)
        assert all(np.array_equal(a[k], b[k]) for k in a if k != "depth_map")
        assert np.array_equal(a["depth_map"] > 0, b["depth_map"] > 0)
        assert np.abs(a["depth_map"] - b["depth_map"]).max() <= 5e-4


# -------------------------------------------------------------- loader
class _Probe:
    """Each sample holds its index and seed."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, seed=None):
        return {"idx": np.asarray(idx), "seed": np.asarray(-1 if seed is None else seed)}


@pytest.mark.parametrize("shuffle,drop_last,hosts", [
    (True, True, (0, 1)), (True, False, (1, 3)), (False, False, (0, 1)), (False, True, (2, 4))])
def test_loader_matches_jax(shuffle, drop_last, hosts):
    """Order, per-host shards, batches, the per-epoch reshuffle and the
    per-sample seeds equal JAX's DataLoader, exactly."""
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_threads=3, prefetch=2, seed=7,
              host_index=hosts[0], host_count=hosts[1])
    ds = _Probe(23)
    ours, ref = DataLoader(ds, 4, **kw), JDataLoader(ds, 4, **kw)
    seen = []
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(ours) == len(ref)
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            assert np.array_equal(x["idx"], y["idx"]) and np.array_equal(x["seed"], y["seed"])
        assert [list(x["idx"]) for x in a] == [list(i) for i in ours.batches()]
        assert all(s == sample_seed(7, epoch, i) for x in a for i, s in zip(x["idx"], x["seed"]))
        seen.append(np.concatenate([x["idx"] for x in a]))
        assert len(ours.load_s) == len(a)
    if shuffle:
        assert not np.array_equal(seen[0], seen[1])


def test_loader_raises_worker_errors():
    class Broken(_Probe):
        def __getitem__(self, idx, seed=None):
            if idx == 5:
                raise KeyError("sample 5 is broken")
            return super().__getitem__(idx, seed)

    with pytest.raises(KeyError, match="broken"):
        list(DataLoader(Broken(8), 2, num_threads=2))


def test_synthetic_matches_jax():
    pcfg = Config(data_name="Synthetic", patch_height=32, patch_width=48).finalize()
    jcfg = JConfig(data_name="Synthetic", patch_height=32, patch_width=48).finalize()
    for mode in ("train", "val", "test"):
        ds, jds = get(pcfg)(pcfg, mode), jget(jcfg)(jcfg, mode)
        assert len(ds) == len(jds)
        for idx, seed in ((0, None), (3, 17), (15, 123456)):
            a, b = ds.__getitem__(idx, seed=seed), jds.__getitem__(idx, seed=seed)
            assert a.keys() == b.keys()
            assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
