"""The port's export tool (``tools/export_model.py``) against eager runs and
the JAX package, on the CPU: the counterpart of ``tests/test_export.py``.

The artifact takes the batch and the starting latent and returns pred.
Export -> save -> load must give the eager predict step's bits; the f32
artifacts are also held against JAX's ``model.apply(..., init_latent=...)``
on the same weights at rtol = atol = 1e-3, as ``test_torch_model_eval``
holds the eager step (another summation order, grown through the steps
and the reciprocal decode).

JAX's ``runs_under_outer_jit`` and ``shards_over_mesh`` have no
counterpart until the port has multi-GPU; ``multi_platform_from_cpu_host``
has none: a ``torch.export`` artifact runs on the device it was exported on.
"""

from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import diffusiondepth_tpu_torch as port  # noqa: E402
from diffusiondepth_tpu_torch.ops import native  # noqa: E402
from diffusiondepth_tpu_torch.tools import export_model as em  # noqa: E402
from diffusiondepth_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

from test_torch_support import jax_model, jax_variables, port_model  # noqa: E402

torch.set_num_threads(1)
H, W = 32, 48


def _batch(b, seed=0):
    """A serving batch (the five NHWC maps) as numpy arrays."""
    rng = np.random.RandomState(seed)
    gt = np.clip(rng.rand(b, H, W, 1) * 80 + 1, 0, 88).astype(np.float32)
    return {"rgb": rng.randn(b, H, W, 3).astype(np.float32),
            "dep": gt * (rng.rand(b, H, W, 1) > 0.8), "gt": gt, "depth_map": gt,
            "depth_mask": np.ones((b, H, W, 1), np.float32)}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _exported(model, spec, tta=False):
    """The exported program's module, not saved (the CLI and flagship
    tests cover saving and loading)."""
    return em.export_predict(model, spec, tta_flip=tta).module()


@pytest.fixture(scope="module")
def res18(tmp_path_factory):
    """mmbev_res18 + DDIMDepthEstimate_Res (2 steps, f32): the JAX model's
    pred on one batch and its mirror (one call, rows [x, flip(x)]), the
    port model with the same weights, and its artifact exported by the CLI
    from a checkpoint of those weights."""
    batch = _batch(1)
    both = {k: np.concatenate([v, v[:, :, ::-1]]) for k, v in batch.items()}
    lat = np.random.RandomState(1).randn(2, H // 2, W // 2, 16).astype(np.float32)
    jm = jax_model(steps=2, family="res18")
    variables = jax_variables(jm, batch)
    jpred = np.asarray(jax.jit(lambda v, b, l: jm.apply(v, b, train=False, init_latent=l)["pred"])(
        variables, {k: jnp.asarray(v) for k, v in both.items()}, jnp.asarray(lat)))
    model = port_model(variables, steps=2, family="res18")
    tmp = tmp_path_factory.mktemp("res18")
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="mmbev_resnet",
                      backbone_name="mmbev_res18", head_specify="DDIMDepthEstimate_Res",
                      inference_steps=2).finalize()
    ckpt = save_checkpoint(str(tmp), 1, SimpleNamespace(model=model, step=0), cfg)
    artifact = str(tmp / "res18.pt2")
    assert em.main(["--ckpt", ckpt, "--out", artifact, "--batch_size", "1", "--height", str(H),
                    "--width", str(W), "--device", "cpu"]) == 0
    return SimpleNamespace(batch=batch, lat=lat, jpred=jpred, model=model, artifact=artifact)


def test_export_cli_roundtrip_matches_eager_and_jax(res18):
    """The CLI's artifact (checkpoint + .args.json -> .pt2), reloaded,
    gives the eager predict step's bits, within 1e-3 of JAX's pred."""
    module = em.load_exported(res18.artifact).module()
    lat = torch.from_numpy(res18.lat[:1])
    with torch.no_grad():
        got = module(_t(res18.batch), lat)
        want = em.make_predict_fn(res18.model)(_t(res18.batch), lat)
    assert got.shape == (1, H, W, 1) and torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), res18.jpred[:1], rtol=1e-3, atol=1e-3)


def test_export_tta_matches_flip_ensemble(res18):
    """The --tta artifact (one doubled batch) equals the flip ensemble
    made by hand from the eager model, and JAX's ensemble formula on JAX's
    pred of the doubled batch."""
    module = _exported(res18.model, em.serving_batch_spec(1, H, W), tta=True)
    batch, lat = _t(res18.batch), torch.from_numpy(res18.lat)
    both = {k: torch.cat([v, torch.flip(v, dims=(2,))]) for k, v in batch.items()}
    with torch.no_grad():
        got = module(batch, lat)
        p = res18.model(both, init_latent=lat)["pred"]
    assert torch.equal(got, 0.5 * (p[:1] + torch.flip(p[1:], dims=(2,))))
    jens = 0.5 * (res18.jpred[:1] + res18.jpred[1:, :, ::-1])
    np.testing.assert_allclose(got.numpy(), jens, rtol=1e-3, atol=1e-3)


def test_artifact_serves_other_weights(res18):
    """Weights are the program's inputs, not constants: the artifact
    exported with one seed's weights serves another seed's exactly."""
    cfg_b = port.Config(model_name="Diffusion_DCbase_", backbone_module="mmbev_resnet",
                        backbone_name="mmbev_res18", head_specify="DDIMDepthEstimate_Res",
                        inference_steps=2, seed=11).finalize()
    model_b = port.build_model(cfg_b, device="cpu")
    module = em.load_exported(res18.artifact).module()
    module.load_state_dict(model_b.state_dict())
    batch, lat = _t(res18.batch), torch.from_numpy(res18.lat[:1])
    with torch.no_grad():
        pred_b = module(batch, lat)
        want_b = em.make_predict_fn(model_b)(batch, lat)
        pred_a = em.make_predict_fn(res18.model)(batch, lat)
    assert torch.equal(pred_b, want_b) and not torch.equal(pred_a, pred_b)


def test_export_flagship_head_swin_micro(tmp_path):
    """swin_micro under the flagship head, bf16 (2 steps, 64x96), exported
    before any eager call: its graph calls the kernels' operators as the
    eager path launches them (6 K1 and one K3 per step, one K4 per Swin
    block); the eager call after the export runs on real shift masks (the
    export cached no fake one) and gives the artifact's bits."""
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=2, opt_level="O1",
                      head_in_channels="32,64,128,256").finalize()
    model = port.build_model(cfg, device="cpu")
    spec = em.serving_batch_spec(1, 64, 96)
    ep = em.export_predict(model, spec)
    calls = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    n_blocks = sum(len(s.blocks) for s in model.depth_backbone.stages)
    assert calls.count("diffusiondepth.conv_link.default") == 6 * 2
    assert calls.count("diffusiondepth.ddim_step.default") == 2
    assert calls.count("diffusiondepth.window_attention.default") == n_blocks == 5
    # the shift masks are computed in the program, not host constants copied per call
    assert not [k for k in ep.constants if k.startswith("depth_backbone") and "lifted" in k]
    path = str(tmp_path / "micro.pt2")
    em.save_exported(ep, path)
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.rand(s, generator=g) * 5 for k, s in spec.items()}
    lat = torch.randn(em.latent_shape(model, 1, 64, 96), generator=g)
    with torch.no_grad():
        eager = em.make_predict_fn(model)(batch, lat)
        got = em.load_exported(path).module()(batch, lat)
    masks = [t for k, t in native._CONSTANTS.items() if k[0][0] == "swin_shift_mask"]
    assert masks and all(type(t) is torch.Tensor for t in native._CONSTANTS.values())
    assert torch.equal(got, eager)


@pytest.mark.parametrize("model_name", ["Diffusion_DCx4base_", "NLSPN"])
def test_export_other_model_families(model_name):
    """The X4 model (a quarter-resolution latent) and NLSPN (no latent:
    a (1, 0, 0, 0) input) export and give the eager bits."""
    cfg = port.Config(model_name=model_name, backbone_module="mmbev_resnet",
                      backbone_name="mmbev_res18", head_specify="DDIMDepthEstimate_Res",
                      inference_steps=1, max_depth=88.0, network="resnet18",
                      prop_time=2).finalize()
    model = port.build_model(cfg, device="cpu")
    module = _exported(model, em.serving_batch_spec(1, H, W))
    shape = em.latent_shape(model, 1, H, W)
    assert shape == ((1, H // 4, W // 4, 16) if model_name == "Diffusion_DCx4base_"
                     else (1, 0, 0, 0))
    batch = _t(_batch(1, seed=3))
    lat = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = module(batch, lat)
        want = em.make_predict_fn(model)(batch, lat)
    assert got.shape == (1, H, W, 1) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(88, 304), (44, 152), (22, 76), (11, 38), (8, 12), (4, 6)])
def test_shift_mask_on_device_matches_numpy(hw):
    """The mask the Swin blocks make with torch (so that an artifact
    computes it on the card) equals the numpy one bit for bit, at the
    Swin-L stages of a 352x1216 image and the micro model's."""
    from diffusiondepth_tpu_torch.models.backbones.swin import (
        shifted_window_mask, shifted_window_mask_on)

    hp, wp = (-(-n // 7) * 7 for n in hw)
    want = shifted_window_mask(hp, wp, 7, 3)
    got = shifted_window_mask_on(hp, wp, 7, 3, "cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
