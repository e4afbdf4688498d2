"""Batch serving from an artifact (``tools/serve.py``) on the CPU: the
counterpart of ``tests/test_serve.py``. PNGs in, KITTI-submission uint16
PNGs out, from the artifact and a checkpoint alone: the run imports no
model code, and no PIL, jax or h5py."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import diffusiondepth_tpu_torch as port
from diffusiondepth_tpu_torch.native.png import read_png, write_png
from diffusiondepth_tpu_torch.tools import export_model as em
from diffusiondepth_tpu_torch.tools.serve import pred_to_png
from diffusiondepth_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
B, H, W = 2, 32, 48

_SERVE_BLOCKED = """
import importlib.abc, json, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if (name.split(".")[0] in ("PIL", "jax", "jaxlib", "h5py")
                or name.startswith("diffusiondepth_tpu_torch.models")):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
from diffusiondepth_tpu_torch.tools.serve import main

args = json.loads(sys.argv[1])
assert main(args) == 0
print(json.dumps(sorted(m for m in sys.modules if m.startswith("diffusiondepth_tpu_torch."))))
"""


def test_serve_dir_end_to_end(tmp_path):
    """3 frames at artifact batch 2 (a ragged tail of 1, padded by repeating
    it): 3 output PNGs equal uint16(clip(pred, 0, 255) * 256) of the eager
    predictions on the same batches and generator draws, and JAX's
    ``_write_pred`` of those predictions decodes to the same values."""
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="mmbev_resnet",
                      backbone_name="mmbev_res18", head_specify="DDIMDepthEstimate_Res",
                      inference_steps=1, max_depth=88.0).finalize()
    model = port.build_model(cfg, device="cpu")
    ckpt = save_checkpoint(str(tmp_path), 1, SimpleNamespace(model=model, step=0), cfg)
    art = str(tmp_path / "model.pt2")
    em.save_exported(em.export_predict(model, em.serving_batch_spec(B, H, W)), art)

    rng = np.random.RandomState(0)
    rgb_dir, dep_dir, out_dir = tmp_path / "rgb", tmp_path / "dep", tmp_path / "out"
    rgb_dir.mkdir()
    dep_dir.mkdir()
    names = [f"{i:04d}.png" for i in range(3)]
    for n in names:
        write_png(str(rgb_dir / n), (rng.rand(H, W, 3) * 255).astype(np.uint8))
        write_png(str(dep_dir / n), (rng.rand(H, W) * 20 * 256).astype(np.uint16))

    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = ["--artifact", art, "--ckpt", ckpt, "--rgb_dir", str(rgb_dir), "--dep_dir",
            str(dep_dir), "--out_dir", str(out_dir), "--seed", "0", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-c", _SERVE_BLOCKED, json.dumps(args)], cwd=tmp_path,
                         env=env, check=True, capture_output=True, text=True).stdout
    assert "wrote 3 predictions" in out
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "diffusiondepth_tpu_torch.ops.library" in loaded
    assert not any(m.startswith("diffusiondepth_tpu_torch.models") for m in loaded)
    assert sorted(os.listdir(out_dir)) == names

    gen = torch.Generator().manual_seed(0)
    predict = em.make_predict_fn(model)
    lat_shape = em.latent_shape(model, B, H, W)
    preds = []
    for chunk in (names[:2], names[2:] + names[2:]):
        rgb = np.stack([read_png(str(rgb_dir / n)) for n in chunk]).astype(np.float32) / 255
        dep = np.stack([read_png(str(dep_dir / n)) for n in chunk]).astype(np.float32) / 256
        dep = torch.from_numpy(dep[..., None])
        batch = {"rgb": torch.from_numpy(rgb), "dep": dep, "gt": dep, "depth_map": dep,
                 "depth_mask": (dep > 0).float()}
        with torch.no_grad():
            preds.append(predict(batch, torch.randn(lat_shape, generator=gen)).numpy())
    preds = np.concatenate(preds)[:3]

    from diffusiondepth_tpu.tools.serve import _write_pred

    for j, n in enumerate(names):
        got = read_png(str(out_dir / n))
        assert got.dtype == np.uint16 and np.array_equal(got, pred_to_png(preds[j]))
        _write_pred(str(tmp_path / f"jax_{n}"), preds[j])
        assert np.array_equal(read_png(str(tmp_path / f"jax_{n}")), got)


def test_serve_without_card_raises(tmp_path):
    """Serving runs on the card unless the caller asks for the CPU: with
    no card it raises before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from diffusiondepth_tpu_torch.tools.serve import serve_dir

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_dir("missing.pt2", "missing.ckpt", str(tmp_path), str(tmp_path / "out"))
