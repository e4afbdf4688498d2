"""The port's NYUv2 data layer against the JAX package's: the NYU dataset
on a tree written by h5py (train with augmentation at two seeds, train
without, val, test, each with and without ``--ip_basic``), the transforms
it adds (BILINEAR resizes of uint8 RGB and float32 'F' images, the centre
crop, the NEAREST rotation of 'F' depth) against Pillow at NYU's sizes,
and the split generator against JAX's.

Tolerances: K, dep, gt, depth_mask and the scanline depth_map exact (the
port follows Pillow's double sums in the same order: no ulp differs);
rgb within one uint8 level (``RGB_TOL``; measured: no pixel differs);
depth_map under ``--ip_basic`` within 5e-4 m with the same filled pixels
(``tests/test_torch_ip_basic.py``); the split json equal.
"""

import json
import os
import random

import numpy as np
import pytest
from PIL import Image

h5py = pytest.importorskip("h5py")

from diffusiondepth_tpu.config import Config as JConfig  # noqa: E402
from diffusiondepth_tpu.data import get as jget  # noqa: E402
from diffusiondepth_tpu.data import transforms as JT  # noqa: E402
from diffusiondepth_tpu.tools import generate_json as JG  # noqa: E402
from diffusiondepth_tpu_torch.config import Config  # noqa: E402
from diffusiondepth_tpu_torch.data import get  # noqa: E402
from diffusiondepth_tpu_torch.data import transforms as T  # noqa: E402
from diffusiondepth_tpu_torch.data.nyu import CROP_SIZE, NYU  # noqa: E402
from diffusiondepth_tpu_torch.tools import generate_json as G  # noqa: E402

RGB_TOL = 1.0 / 255.0 / 0.224 + 1e-6  # one uint8 level after normalisation


def _frame(rng, h, w):
    ramp = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    rgb = np.clip(200 * ramp[None] * rng.rand(3, 1, 1) + 60 * rng.rand(3, h, w), 0, 255)
    depth = (0.5 + 9.0 * ramp + 0.5 * rng.rand(h, w)).astype(np.float32)
    depth[rng.rand(h, w) < 0.2] = 0.0
    return rgb.astype(np.uint8), depth


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """An NYU tree written by h5py: 3 train frames of 480x640 (NYU's size)
    and one of 250x330, and 2 test frames under val/official; a split
    json."""
    root = tmp_path_factory.mktemp("nyu")
    rng = np.random.RandomState(0)
    names = []
    for i, (h, w) in enumerate([(480, 640)] * 3 + [(250, 330)] + [(480, 640)] * 2):
        name = f"train/scene_{i % 2}/{i:05d}.h5" if i < 4 else f"val/official/{i:05d}.h5"
        os.makedirs(root / os.path.dirname(name), exist_ok=True)
        rgb, depth = _frame(rng, h, w)
        with h5py.File(root / name, "w") as f:
            f.create_dataset("rgb", data=rgb)
            f.create_dataset("depth", data=depth)
        names.append(name)
    split = {"train": [{"filename": n} for n in names[:4]],
             "val": [{"filename": n} for n in names[2:4]],
             "test": [{"filename": n} for n in names[4:]]}
    (root / "split.json").write_text(json.dumps(split))
    return root


def _configs(root, **kw):
    common = dict(dict(data_name="NYU", dir_data=str(root),
                       split_json=str(root / "split.json"), num_sample=500), **kw)
    return Config(**common).finalize(), JConfig(**common).finalize()


MODES = {  # name -> (split, config overrides)
    "train_augment": ("train", dict()),
    "train_no_augment": ("train", dict(augment=False)),
    "val": ("val", dict()),
    "test": ("test", dict()),
    "test_dense": ("test", dict(num_sample=0)),
}


@pytest.mark.parametrize("ip_basic", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_nyu_samples_match_jax(nyu_root, mode, ip_basic):
    split, kw = MODES[mode]
    pcfg, jcfg = _configs(nyu_root, ip_basic=ip_basic, **kw)
    assert get(pcfg) is NYU
    ds, jds = get(pcfg)(pcfg, split), jget(jcfg)(jcfg, split)
    assert len(ds) == len(jds)
    for idx in range(len(ds)):
        for seed in (3, 11):
            a, b = ds.__getitem__(idx, seed=seed), jds.__getitem__(idx, seed=seed)
            assert a.keys() == b.keys()
            exact = ("K", "dep", "gt", "depth_mask") + (() if ip_basic else ("depth_map",))
            for k in exact:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (mode, idx, k)
            assert a["rgb"].shape == b["rgb"].shape == CROP_SIZE + (3,)
            assert np.abs(a["rgb"] - b["rgb"]).max() <= RGB_TOL
            dm, jdm = a["depth_map"], b["depth_map"]
            assert dm.shape == jdm.shape == CROP_SIZE + (1,)
            assert np.array_equal(dm > 0, jdm > 0) and np.abs(dm - jdm).max() <= 5e-4
            assert int((a["dep"] > 0).sum()) == (min(pcfg.num_sample, int((a["gt"] > 0).sum()))
                                                 if pcfg.num_sample > 0 else 0)


def test_nyu_ignores_patch_size(nyu_root):
    """The crop is NYU's constant 228x304 whatever --patch_height/width say,
    as in the JAX package."""
    pcfg, _ = _configs(nyu_root, patch_height=64, patch_width=96)
    assert NYU(pcfg, "train").__getitem__(0, seed=1)["rgb"].shape == CROP_SIZE + (3,)


# ------------------------------------------------------------ transforms
@pytest.fixture(scope="module")
def frame():
    return _frame(np.random.RandomState(5), 480, 640)


@pytest.mark.parametrize("size", [240, 241, 288, 300, 359, 360, 480, 512])
def test_bilinear_resize_matches_pillow(frame, size):
    """BILINEAR of RGB (8-bit fixed point) and of 'F' depth (double sums),
    at the sizes NYU's scale draws give (240 to 359) and up."""
    rgb, depth = frame[0].transpose(1, 2, 0), frame[1]
    got = T.resize_shorter(rgb, size, T.BILINEAR)
    ref = np.asarray(JT.resize_shorter(Image.fromarray(rgb), size, JT.BILINEAR))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.abs(got.astype(np.int64) - ref).max() <= 1
    got = T.resize_shorter(depth, size, T.BILINEAR)
    ref = np.asarray(JT.resize_shorter(Image.fromarray(depth, mode="F"), size, JT.BILINEAR))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_bilinear_resize_odd_sizes_and_tall_images(frame):
    rgb, depth = frame[0].transpose(1, 2, 0)[:101, :77], frame[1][:101, :77]
    for new_w, new_h in ((33, 50), (77, 250), (150, 40), (1, 1)):
        got = T.resize(rgb, new_w, new_h, T.BILINEAR)
        ref = np.asarray(Image.fromarray(rgb).resize((new_w, new_h), Image.BILINEAR))
        assert np.abs(got.astype(np.int64) - ref).max() <= 1
        got = T.resize(depth, new_w, new_h, T.BILINEAR)
        ref = np.asarray(Image.fromarray(depth, mode="F").resize((new_w, new_h), Image.BILINEAR))
        assert np.array_equal(got, ref)
    assert T.resize_shorter(rgb, 40, T.BILINEAR).shape == (52, 40, 3)


def test_center_crop_and_depth_rotation_match_pillow(frame):
    rgb, depth = frame[0].transpose(1, 2, 0), frame[1]
    for hw in ((228, 304), (227, 303), (480, 640), (500, 100)):
        assert np.array_equal(T.center_crop(rgb, hw),
                              np.asarray(JT.center_crop(Image.fromarray(rgb), hw)))
        assert np.array_equal(T.center_crop(depth, hw),
                              np.asarray(JT.center_crop(Image.fromarray(depth, mode="F"), hw)))
    rng = random.Random(0)
    for angle in [rng.uniform(-5.0, 5.0) for _ in range(4)] + [-5.0, 4.999]:
        ref = np.asarray(JT.rotate(Image.fromarray(depth, mode="F"), angle, JT.NEAREST))
        assert np.array_equal(T.rotate(depth, angle, T.NEAREST), ref)
        ref = np.asarray(JT.rotate(Image.fromarray(rgb), angle, JT.NEAREST))
        assert np.array_equal(T.rotate(rgb, angle, T.NEAREST), ref)


# ------------------------------------------------------------ split json
@pytest.fixture
def nyu_listing(tmp_path):
    """The inputs of tests/test_tools.py's NYU case: 4 files in
    val/official and a 40-row train csv with a 19-character prefix."""
    root = tmp_path / "nyu"
    (root / "val" / "official").mkdir(parents=True)
    for i in range(4):
        (root / "val" / "official" / f"{i:05d}.h5").touch()
    csv_train = tmp_path / "train.csv"
    csv_train.write_text("\n".join(f"{'x' * 19}train/d{i}/{i:05d}.h5" for i in range(40)))
    csv_test = tmp_path / "test.csv"
    csv_test.write_text("")
    return root, csv_train, csv_test


@pytest.mark.parametrize("kw", [dict(val_ratio=0.1, seed=3), dict(),
                                dict(val_ratio=0.2, num_train=5, num_val=2, num_test=3)])
def test_generate_nyu_json_matches_jax(nyu_listing, kw):
    root, csv_train, csv_test = nyu_listing
    ours = G.generate_nyu_json(str(root), str(csv_train), str(csv_test), **kw)
    assert ours == JG.generate_nyu_json(str(root), str(csv_train), str(csv_test), **kw)
    if kw.get("val_ratio") == 0.1:
        assert [len(ours[k]) for k in ("train", "val", "test")] == [36, 4, 4]
        assert ours["test"][0]["filename"] == "val/official/00000.h5"


def test_generate_json_cli_matches_jax(nyu_listing, tmp_path):
    """``main`` (argparse) of both: the same file, byte for byte, for NYU
    and for KITTI (an empty tree: empty splits)."""
    root, csv_train, csv_test = nyu_listing
    for dataset in ("nyu", "kitti"):
        for mod, out in ((G, "port"), (JG, "jax")):
            mod.main([dataset, "--path_root", str(root), "--path_out", str(tmp_path / out),
                      "--csv_train", str(csv_train), "--csv_test", str(csv_test),
                      "--val_ratio", "0.25", "--seed", "5"])
        name = "nyu.json" if dataset == "nyu" else "kitti_dc.json"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    kitti = G.generate_kitti_test_json(str(root))
    assert kitti == JG.generate_kitti_test_json(str(root)) == {"test": []}
