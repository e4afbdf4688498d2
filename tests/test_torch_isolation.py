"""The port stands alone: it imports nothing of JAX or of the JAX package,
its entry points never fall back to the CPU on their own, and its kernel
wrappers take the plain versions only for CPU tensors."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import diffusiondepth_tpu_torch as port
from diffusiondepth_tpu_torch.ops import fused_denoiser as fd
from diffusiondepth_tpu_torch.ops import layernorm as ln
from diffusiondepth_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "diffusiondepth_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import diffusiondepth_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, "diffusiondepth_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "diffusiondepth_tpu"))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax():
    """A fresh interpreter imports the package and every module in it; no
    jax, jaxlib, flax or diffusiondepth_tpu module is loaded."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 15, out
    assert out[1].strip() == "[]", out


_IMPORT_ALL_RUNTIME = """
import importlib, pkgutil, sys
import diffusiondepth_tpu_torch as P
names = [m.name for m in pkgutil.walk_packages(P.__path__, "diffusiondepth_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("PIL", "matplotlib", "h5py", "cv2", "msgpack", "flax"))
print(len(names), bad)
"""

# the card's machine has none of these: the runtime (data, summaries,
# checkpoints) must not need them
_RUNTIME_FORBIDDEN = re.compile(
    r"^\s*(import\s+(PIL|matplotlib|h5py|cv2|msgpack|flax)\b"
    r"|from\s+(PIL|matplotlib|h5py|cv2|msgpack|flax)\b)", re.M)


def test_import_pulls_in_no_image_or_serialization_library():
    """A fresh interpreter imports every module of the port, the runtime's
    too (main, data, summary, utils, native); no PIL, matplotlib, h5py,
    cv2, msgpack or flax module is loaded."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL_RUNTIME], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 30, out
    assert out[1].strip() == "[]", out


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_has_no_image_or_serialization_import(path):
    src = (REPO / path).read_text()
    assert not _RUNTIME_FORBIDDEN.search(src), _RUNTIME_FORBIDDEN.search(src).group(0)


_DATA_LAYER_WITHOUT_LIBRARIES = """
import importlib.abc, json, os, sys, tempfile
import numpy as np


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("h5py", "cv2", "PIL"):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
from diffusiondepth_tpu_torch.config import Config
from diffusiondepth_tpu_torch.data import get
from diffusiondepth_tpu_torch.native.hdf5 import write_datasets
from diffusiondepth_tpu_torch.tools.generate_json import generate_nyu_json

root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, "train", "s"))
os.makedirs(os.path.join(root, "val", "official"))
r = np.random.RandomState(0)
for name in ("train/s/00000.h5", "train/s/00001.h5", "val/official/00000.h5"):
    write_datasets(os.path.join(root, name), {
        "rgb": r.randint(0, 256, (3, 60, 80), np.uint8),
        "depth": r.uniform(0.5, 10, (60, 80)).astype(np.float32)})
with open(os.path.join(root, "train.csv"), "w") as f:
    f.write("".join("x" * 19 + "train/s/%05d.h5\\n" % i for i in range(2)))
split = generate_nyu_json(root, os.path.join(root, "train.csv"), "", val_ratio=0.5)
with open(os.path.join(root, "split.json"), "w") as f:
    json.dump(split, f)
shapes = []
for ip_basic in (False, True):
    cfg = Config(data_name="NYU", dir_data=root, split_json=os.path.join(root, "split.json"),
                 ip_basic=ip_basic).finalize()
    for mode in ("train", "val", "test"):
        s = get(cfg)(cfg, mode).__getitem__(0, seed=1)
        shapes.append(s["depth_map"].shape)
    syn = Config(data_name="Synthetic", patch_height=32, patch_width=48,
                 ip_basic=ip_basic).finalize()
    shapes.append(get(syn)(syn, "train")[0]["depth_map"].shape)
print(sorted(set(shapes)),
      sorted(m for m in sys.modules if m.split(".")[0] in ("h5py", "cv2", "PIL")))
"""


def test_data_layer_runs_without_h5py_cv2_or_pil():
    """With h5py, cv2 and PIL blocked from importing, the port writes NYU
    files, makes the split, and reads NYU (with and without --ip_basic)
    and Synthetic (--ip_basic) samples: nothing reaches those libraries."""
    out = subprocess.run([sys.executable, "-c", _DATA_LAYER_WITHOUT_LIBRARIES], cwd=REPO,
                         check=True, capture_output=True, text=True).stdout
    assert out.strip() == "[(32, 48, 1), (228, 304, 1)] []", out


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|diffusiondepth_tpu)\b(?!_torch)"
    r"|from\s+(jax|flax|diffusiondepth_tpu)\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_has_no_jax_import(path):
    """No import of jax, flax or the JAX package in the port's sources or
    in chip_smoke.py."""
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.search(src), _FORBIDDEN.search(src).group(0)


def test_build_model_without_card_raises():
    """With no GPU, build_model(cfg) without device='cpu' raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the call would run on it")
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=1,
                      head_in_channels="32,64,128,256").finalize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.build_model(cfg)


def test_wrappers_take_plain_versions_on_cpu():
    """Each kernel wrapper given CPU tensors returns its plain version's
    result and launches nothing: every launch count stays 0."""
    port.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(1, 8, 10, 16, generator=g).to(bf)
    w = (torch.randn(3, 3, 16, 64, generator=g) * 0.1).to(bf)
    b = torch.randn(64, generator=g)
    y, ps = fd.conv_link(x, w, b, stats=True)
    yp, psp = fd.conv_link_plain(x, w, b, stats=True)
    assert torch.equal(y, yp) and torch.equal(ps, psp)

    u6 = torch.randn(1, 8, 10, 16, generator=g).to(bf)
    lat = torch.randn(1, 8, 10, 16, generator=g)
    a, o = torch.ones(1, 16), torch.zeros(1, 16)
    sched = torch.tensor([0.8, 0.6, 0.9, 0.43589])
    assert torch.equal(fd.ddim_step(u6, a, o, lat, sched),
                       fd.ddim_step_plain(u6, a, o, lat, sched))

    qkv = torch.randn(1, 2, 49, 96, generator=g)
    bias = torch.randn(1, 49, 49, generator=g)
    assert torch.equal(wa.window_attention(qkv, bias, None, 0.17, 1),
                       wa.window_attention_plain(qkv, bias, None, 0.17, 1))
    q, k, v = torch.randn(3, 1, 2, 1, 49, 32, generator=g).to(bf)
    mask = torch.randn(2, 49, 49, generator=g)
    assert torch.equal(wa.window_attention_split(q, k, v, bias, mask, 0.17),
                       wa.window_attention_split_plain(q, k, v, bias, mask, 0.17))
    x2 = torch.randn(37, 96, generator=g).to(bf)
    sc, sh = torch.rand(96, generator=g) + 0.5, torch.randn(96, generator=g)
    y, mean, inv = ln.layernorm_fwd(x2, sc, sh, 1e-5)
    for a, b_ in zip((y, mean, inv), ln.layernorm_fwd_plain(x2, sc, sh, 1e-5)):
        assert torch.equal(a, b_)
    dy = torch.randn(37, 96, generator=g).to(bf)
    for a, b_ in zip(ln.layernorm_bwd(x2, dy, mean, inv, sc),
                     ln.layernorm_bwd_plain(x2, dy, mean, inv, sc)):
        assert torch.equal(a, b_)
    assert set(port.LAUNCHES) >= {"conv_link", "ddim_step", "window_attention",
                                  "window_attention_split", "layernorm_fwd", "layernorm_bwd"}
    assert not any(port.LAUNCHES.values())


@pytest.mark.parametrize("kernel", ["window_attention_split", "layernorm_fwd",
                                    "layernorm_bwd"])
def test_wrappers_refuse_other_devices(kernel):
    """Off the CPU a wrapper launches its kernel or raises: given tensors
    on a device it has no kernel for (meta), it raises instead of running
    the plain version."""
    q = torch.empty(1, 2, 1, 49, 32, device="meta")
    x2 = torch.empty(8, 96, device="meta", dtype=torch.bfloat16)
    vec = torch.empty(96, device="meta")
    rows = torch.empty(8, device="meta")
    call = {
        "window_attention_split": lambda: wa.window_attention_split(
            q, q, q, torch.empty(1, 49, 49, device="meta"), None, 0.17),
        "layernorm_fwd": lambda: ln.layernorm_fwd(x2, vec, vec, 1e-5),
        "layernorm_bwd": lambda: ln.layernorm_bwd(x2, x2, rows, rows, vec),
    }[kernel]
    with pytest.raises(ValueError, match="unsupported device"):
        call()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cpu_eval_launches_no_kernel(use_pallas):
    """A whole eval step on the CPU under the bf16 policy takes the fused
    chain's plain versions and counts no launch, with flip-TTA and K8's
    route too."""
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=2, opt_level="O1",
                      head_in_channels="32,64,128,256", use_pallas=use_pallas).finalize()
    model = port.build_model(cfg, device="cpu")
    assert model.depth_head.model.fused_active(16)  # the 16x24 latent of a 32x48 batch
    port.reset_launch_counts()
    g = torch.Generator().manual_seed(1)
    batch = {"rgb": torch.randn(1, 32, 48, 3, generator=g),
             "gt": torch.rand(1, 32, 48, 1, generator=g) * 5 + 1}
    pred, met, _ = port.make_eval_step(model, tta_flip=use_pallas)(batch, generator=g)
    assert pred.shape == (1, 32, 48, 1) and bool(torch.isfinite(met).all())
    assert set(port.LAUNCHES) >= {"conv_link", "ddim_step", "window_attention"}
    assert not any(port.LAUNCHES.values())


def _grad_inputs():
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(1, 4, 6, 16, generator=g).to(bf).requires_grad_()
    w = (torch.randn(3, 3, 16, 64, generator=g) * 0.1).to(bf)
    u6 = torch.randn(1, 4, 6, 16, generator=g).to(bf).requires_grad_()
    lat = torch.randn(1, 4, 6, 16, generator=g)
    qkv = torch.randn(1, 2, 49, 96, generator=g).requires_grad_()
    return x, w, u6, lat, qkv


@pytest.mark.parametrize("kernel", ["conv_link", "ddim_step", "window_attention",
                                    "window_attention_split", "layernorm_fwd",
                                    "layernorm_bwd"])
def test_raw_wrappers_refuse_inputs_that_need_grad(kernel):
    """The raw kernel wrappers return tensors without a grad_fn on the card
    (the result is written through ctypes or Triton), so with grad mode on
    and an input that requires grad they raise, on the CPU too, instead of
    silently cutting the gradient; under no_grad they run. Training goes
    through the autograd Functions (FusedDenoiser, FusedSamplerStep,
    WindowAttentionQKV, LayerNormBF16)."""
    x, w, u6, lat, qkv = _grad_inputs()
    one, zero = torch.ones(1, 16), torch.zeros(1, 16)
    q5 = qkv.detach()[..., :32].reshape(1, 2, 1, 49, 32).requires_grad_()
    x2 = x.reshape(-1, 16)[:4]
    sched = torch.tensor([0.8, 0.6, 0.9, 0.43589])
    call = {
        "conv_link": lambda: fd.conv_link(x, w, torch.zeros(64)),
        "ddim_step": lambda: fd.ddim_step(u6, one, zero, lat, sched),
        "window_attention": lambda: wa.window_attention(qkv, torch.zeros(1, 49, 49), None,
                                                        0.17, 1),
        "window_attention_split": lambda: wa.window_attention_split(
            q5, q5, q5, torch.zeros(1, 49, 49), None, 0.17),
        "layernorm_fwd": lambda: ln.layernorm_fwd(x2, one[0], zero[0], 1e-5),
        "layernorm_bwd": lambda: ln.layernorm_bwd(x2, x2.detach(), one[0, :4], one[0, :4],
                                                  one[0]),
    }[kernel]
    with pytest.raises(RuntimeError, match="has no autograd"):
        call()
    with torch.no_grad():
        assert call() is not None


def test_chain_params_stay_in_the_graph():
    """The bf16 conv weights of ``chain_params`` carry a grad_fn back to
    the f32 conv weights: a gradient of any of them reaches the parameter."""
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=1, opt_level="O1",
                      head_in_channels="32,64,128,256").finalize()
    den = port.build_model(cfg, device="cpu").depth_head.model
    p = den.chain_params()
    w, b = p["fa"]
    assert w.dtype == torch.bfloat16 and w.grad_fn is not None
    (w.float().sum() + b.sum()).backward()
    conv = den.upsample_add.convA.conv
    assert conv.weight.grad is not None and bool((conv.weight.grad == 1).all())
    assert conv.bias.grad is not None
