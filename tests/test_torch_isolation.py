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
    assert port.LAUNCHES == {"conv_link": 0, "ddim_step": 0, "window_attention": 0}


def test_cpu_eval_launches_no_kernel():
    """A whole eval step on the CPU under the bf16 policy takes the fused
    chain's plain versions and counts no launch."""
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=2, opt_level="O1",
                      head_in_channels="32,64,128,256").finalize()
    model = port.build_model(cfg, device="cpu")
    assert model.depth_head.model.fused_active()
    port.reset_launch_counts()
    g = torch.Generator().manual_seed(1)
    batch = {"rgb": torch.randn(1, 32, 48, 3, generator=g),
             "gt": torch.rand(1, 32, 48, 1, generator=g) * 5 + 1}
    pred, met, _ = port.make_eval_step(model)(batch, generator=g)
    assert pred.shape == (1, 32, 48, 1) and bool(torch.isfinite(met).all())
    assert port.LAUNCHES == {"conv_link": 0, "ddim_step": 0, "window_attention": 0}
