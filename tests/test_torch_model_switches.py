"""The switches of the port's Swin model against the JAX package: the
flip-TTA eval step with ``use_pallas`` on and off against the JAX
``make_eval_step(tta_flip=True)`` of a ``use_pallas`` model, f32; the
backbone's block rematerialisation (port only); the registered Swin
backbones, every JAX name with the same parameters."""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.diffusion_model import Diffusion_DCbase_Model  # noqa: E402
from diffusiondepth_tpu.registry import BACKBONES as JBACKBONES  # noqa: E402
from diffusiondepth_tpu.training.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch import build_model, make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch.registry import BACKBONES  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import (  # noqa: E402
    HEAD, MICRO_CHANNELS, jax_variables, make_batch, port_config, torch_batch,
)

torch.set_num_threads(1)

STEPS = 2
_State = collections.namedtuple("_State", "params batch_stats")


class _FixedLatent:
    def __init__(self, model, latent):
        self.model, self.latent = model, latent

    def apply(self, variables, batch, **kw):
        return self.model.apply(variables, batch, init_latent=self.latent, **kw)


@pytest.fixture(scope="module")
def jax_tta():
    """The JAX flip-TTA eval step of a ``use_pallas`` swin_micro model (on
    the CPU its attention takes the einsum path), with a fixed starting
    latent of 2B rows: (variables, batch, latent, pred, metric row)."""
    batch = make_batch(4)
    b, h, w, _ = batch["gt"].shape
    lat = np.random.RandomState(5).randn(2 * b, h // 2, w // 2, 16).astype(np.float32)
    model = Diffusion_DCbase_Model(
        backbone_name="swin_micro", backbone_module="swin", head_name=HEAD,
        inference_steps=STEPS, head_in_channels=MICRO_CHANNELS, use_pallas=True)
    variables = jax_variables(model, batch, seed=6)
    step = jax_make_eval_step(_FixedLatent(model, jnp.asarray(lat)), tta_flip=True)
    pred, met, _ = step(_State(variables["params"], variables["batch_stats"]),
                        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return variables, batch, lat, np.asarray(pred), np.asarray(met)


def _port(variables, **switches):
    cfg = port_config(STEPS)
    for k, v in switches.items():
        setattr(cfg, k, v)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_to_state_dict(variables["params"], variables["batch_stats"]))
    return model


@pytest.mark.parametrize("use_pallas", [True, False])
def test_tta_eval_step_matches_jax_f32(jax_tta, use_pallas):
    """pred and the metric row of ``make_eval_step(model, tta_flip=True)``
    == the JAX flip-TTA eval step, f32, same weights, batch and 2B-row
    starting latent, with the port's attention on K8's plain version
    (``use_pallas``) and on K4's. In f32 both equal the JAX einsum path
    that the JAX model takes on the CPU. Tolerance 1e-3 relative per
    element, as the plain eval-step test (summation order, grown through
    the steps and the reciprocal decode)."""
    variables, batch, lat, jpred, jmet = jax_tta
    step = make_eval_step(_port(variables, use_pallas=use_pallas), tta_flip=True)
    pred, met, _ = step(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert pred.shape == jpred.shape
    np.testing.assert_allclose(pred.numpy(), jpred, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(met.numpy(), jmet, rtol=1e-3, atol=1e-6)


def test_tta_eval_step_refuses_a_latent_of_b_rows(jax_tta):
    """Flip-TTA runs a batch of 2B; a starting latent of B rows is refused."""
    variables, batch, lat, _, _ = jax_tta
    step = make_eval_step(_port(variables), tta_flip=True)
    with pytest.raises(ValueError, match="init_latent has 2 rows"):
        step(torch_batch(batch), init_latent=torch.from_numpy(lat[:2]))


def test_remat_gives_the_same_gradients():
    """``remat=False`` gives the gradients of ``remat=True`` (same weights,
    same drop-path masks from one generator seed, f32): each block runs
    under ``torch.utils.checkpoint`` only with remat, and the recompute
    repeats the forward's arithmetic, so the gradients agree to 1e-6 of
    each one's largest value."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    x = torch.from_numpy(np.random.RandomState(7).randn(2, 32, 48, 3).astype(np.float32))
    grads = []
    for remat in (True, False):
        torch.manual_seed(8)
        bb = BACKBONES.get("swin_micro")(remat=remat).train()
        calls.clear()
        torch.utils.checkpoint.checkpoint = counting
        try:
            outs = bb(x, generator=torch.Generator().manual_seed(9))
        finally:
            torch.utils.checkpoint.checkpoint = real
        assert len(calls) == (5 if remat else 0)  # swin_micro has 5 blocks
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        grads.append({n: p.grad for n, p in bb.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        assert (g - grads[1][n]).abs().max() <= 1e-6 * g.abs().max(), n


@pytest.mark.parametrize("name", ["swin_large_naive_l4w722422k", "swin_large_naive_nopretrain",
                                  "swin_large_naive_swinlargepreatrain_add", "swin_tiny",
                                  "swin_micro"])
def test_swin_backbones_match_jax(name):
    """Every Swin name of the JAX registry builds, in the port, a backbone
    with the same parameter tensors: the same count and sizes for each
    Swin-L name (the reference's three names of one architecture), and a
    strict load of the converted JAX tree for swin_tiny and swin_micro."""
    jmod = JBACKBONES.get(name)()
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    jsizes = sorted(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        port = BACKBONES.get(name)()
    assert sorted(p.numel() for p in port.parameters()) == jsizes
    if not name.startswith("swin_large"):
        params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                        shapes["params"])
        sd = jax_to_state_dict({"depth_backbone": params})
        port = BACKBONES.get(name)()
        port.load_state_dict({k[len("depth_backbone."):]: v for k, v in sd.items()}, strict=True)


def test_switches_reach_the_backbone():
    """build_model threads use_pallas, fused_window_attention and
    remat_backbone into every Swin block."""
    cfg = port_config(STEPS)
    cfg.use_pallas, cfg.fused_window_attention, cfg.remat_backbone = True, False, False
    bb = build_model(cfg, device="cpu").depth_backbone
    msas = [blk.attn.w_msa for st in bb.stages for blk in st.blocks]
    assert not bb.remat and len(msas) == 5
    assert all(m.use_pallas and not m.fused_qkv_attention for m in msas)
