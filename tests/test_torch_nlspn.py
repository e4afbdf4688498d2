"""The port's NLSPN against the JAX package's on the CPU: resnet18,
prop_time 3, a batch of 2 at 32x48, f32.

The offset/affinity conv starts at zero, and then every offset is 0 and
the propagation is the identity, so a parity test on fresh weights would
prove nothing: every weight is drawn at random, the offset conv's too,
and its offset channels are scaled so that some offsets lie beyond the
stencil radius of 6 (where the stencil clamps them, as JAX's does).

Cases cover each affinity mode, conf_prop on and off, legacy,
preserve_input, and the radii 0 (the bilinear gather) and 6 (the
stencil), in eval and in one training step (the loss, every gradient, the
BatchNorm statistics). Tolerances: forward outputs within 1e-4 of each
output's largest value; gradients within 1e-3 of each leaf's largest value
(``close_leaves``); the running statistics 1e-4.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.nlspn import NLSPNModel as JNLSPN  # noqa: E402
from diffusiondepth_tpu.utils.convert_torch_checkpoint import convert_nlspn  # noqa: E402
from diffusiondepth_tpu_torch import Config, LossComputer, build_model  # noqa: E402
from diffusiondepth_tpu_torch.models.nlspn import NLSPNModel  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import close_leaves, module_variables, named, rel_err  # noqa: E402

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-4, 1e-3
B, H, W = 2, 32, 48
# the offset channels' weights: a third of the offsets beyond 6 (up to ~56
# pixels). Larger offsets amplify the convolutions' f32 rounding (~1e-6 of
# the offset) through the confidence read into the affinities: at 8x the
# aff error reaches ~2e-4 in the same way in either direction
OFFSET_SCALE = 2.0
OUT_KEYS = ("pred", "pred_init", "pred_inter", "guidance", "offset", "aff", "gamma",
            "confidence")


def _flags(affinity="TGASS", conf_prop=True, legacy=False, preserve=False, radius=6,
           network="resnet18"):
    return dict(model_name="NLSPN", network=network, prop_time=3, prop_kernel=3,
                affinity=affinity, conf_prop=conf_prop, legacy=legacy,
                preserve_input=preserve, prop_stencil_radius=radius, loss="1.0*L1+1.0*L2",
                max_depth=90.0)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(B, H, W, 1) * 80 + 1).astype(np.float32)
    gt[:, :3] = 0.0  # invalid ground truth, as KITTI's sky
    dep = (gt * (rng.rand(B, H, W, 1) > 0.9)).astype(np.float32)
    return {"rgb": rng.randn(B, H, W, 3).astype(np.float32), "dep": dep, "gt": gt}


def _pair(flags, seed=0):
    """The JAX model, its random variables (offset conv scaled), and the
    port's model with the same weights."""
    jcfg = jconfig.Config(**flags).finalize()
    jm = JNLSPN(args=jcfg)
    batch = _batch(seed)
    variables = module_variables(jm, batch, seed=seed, train=False)
    prop = variables["params"]["prop_layer"]
    prop["conv_offset_aff"]["kernel"][..., :16] *= OFFSET_SCALE  # the (o1, o2) channels
    if "aff_scale_const" in prop:  # drawn as 0 (not a kernel): TGASS's start, moved
        prop["aff_scale_const"] = np.asarray([0.5 * 8 + 0.37], np.float32)
    pm = build_model(Config(**flags).finalize(), device="cpu")
    sd = jax_to_state_dict(variables["params"], variables["batch_stats"])
    if flags["affinity"] == "TC":  # the JAX tree holds TC's constant nowhere
        sd["prop_layer.aff_scale_const"] = torch.tensor([8.0])
    pm.load_state_dict(sd, strict=True)
    return jcfg, jm, variables, pm, batch


EVAL = [  # (affinity, conf_prop, legacy, preserve_input, radius)
    ("TGASS", True, False, False, 6), ("TGASS", True, False, False, 0),
    ("AS", False, False, False, 6), ("ASS", True, True, False, 0),
    ("TC", True, False, True, 6), ("TGASS", True, True, True, 0)]


@pytest.mark.parametrize("affinity,conf_prop,legacy,preserve,radius", EVAL)
def test_eval_matches_jax(affinity, conf_prop, legacy, preserve, radius):
    """Every output of the model in eval mode."""
    flags = _flags(affinity, conf_prop, legacy, preserve, radius)
    jcfg, jm, variables, pm, batch = _pair(flags)
    ref = jax.jit(lambda v, s: jm.apply(v, s, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = pm({k: torch.from_numpy(v) for k, v in batch.items()})
    if radius:
        assert float(jnp.abs(ref["offset"]).max()) > radius  # the clamp acts
    for key in OUT_KEYS:
        if ref[key] is None:
            assert out[key] is None and not conf_prop and key == "confidence"
            continue
        assert tuple(out[key].shape) == tuple(ref[key].shape), key
        assert rel_err(out[key].detach().numpy(), ref[key]) <= FWD_TOL, key
    # the propagation moved the depth: the test is not of an identity
    assert rel_err(out["pred"].numpy(), np.clip(out["pred_init"].numpy(), 0, None)) > 1e-2
    assert float((jnp.abs(ref["offset"]) > 6).mean()) > 0.1


def test_output_contract():
    """The output keys of JAX's model, pred_inter (prop_time, B, H, W, 1),
    pred >= 0, the diffusion keys None."""
    _, _, _, pm, batch = _pair(_flags())
    with torch.no_grad():
        out = pm({k: torch.from_numpy(v) for k, v in batch.items()})
    shapes = {"pred": (B, H, W, 1), "pred_init": (B, H, W, 1), "pred_inter": (3, B, H, W, 1),
              "guidance": (B, H, W, 8), "offset": (B, H, W, 18), "aff": (B, H, W, 9),
              "gamma": (1,), "confidence": (B, H, W, 1)}
    assert {k: tuple(out[k].shape) for k in shapes} == shapes
    assert all(out[k] is None for k in ("ddim_loss", "gt_map_t", "blur_depth_t",
                                        "pred_uncertainty", "weight_map"))
    assert bool((out["pred"] >= 0).all())
    np.testing.assert_array_equal(out["pred"].numpy(),
                                  np.clip(out["pred_inter"][-1].numpy(), 0, None))


TRAIN = [("TGASS", True, False, False, 6), ("TGASS", True, False, False, 0),
         ("TC", True, True, True, 6)]


@pytest.mark.parametrize("affinity,conf_prop,legacy,preserve,radius", TRAIN)
def test_train_step_matches_jax(affinity, conf_prop, legacy, preserve, radius):
    """One training step's loss (1.0*L1+1.0*L2 over the batch), the
    gradient of every parameter (aff_scale_const under TGASS too) and the
    BatchNorm statistics after the step.

    The reference is the JAX step computed in f64 (``jax.enable_x64``):
    JAX's own f32 gradient of the conv3/conv4 stages at this size lies up
    to ~9% of a leaf away from the f64 gradient of either package (XLA's
    f32 sums in the training-mode BatchNorm backward, seen with the loss
    sum(pred_init^2) too, no propagation involved), while the port's f32
    gradient lies within ~1e-5 of it (``test_jax_f32_gradient_drift``)."""
    flags = _flags(affinity, conf_prop, legacy, preserve, radius)
    jcfg, jm, variables, pm, batch = _pair(flags, seed=1)
    jl, jbs, ref = _jax_step_f64(tuple(sorted(flags.items())))

    pm.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = LossComputer(Config(**flags).finalize())(tb, pm(tb))[0] / B
    loss.backward()
    assert abs(loss.item() - jl) <= FWD_TOL * abs(jl)
    grads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert grads.keys() == ref.keys()
    if affinity == "TGASS":
        assert "prop_layer.aff_scale_const" in grads
    for part in ("conv2.", "dec3.", "prop_layer.conv_offset_aff", "cf_dec0."):
        assert any(np.abs(g).max() > 0 for n, g in grads.items() if n.startswith(part)), part
    close_leaves(grads, ref, GRAD_TOL)
    stats = {n: b.numpy() for n, b in pm.named_buffers() if "running" in n}
    ref_stats = {k: v for k, v in named(variables["params"], jbs).items() if "running" in k}
    close_leaves(stats, ref_stats, FWD_TOL)


def _jax_step(jcfg, jm, variables, batch, dtype):
    """JAX's training step in ``dtype``: (loss, batch statistics, gradients
    under the port's names, f64 numpy)."""
    jlc = JLossComputer(jcfg)

    def jloss(params, bs, s):
        out, mut = jm.apply({"params": params, "batch_stats": bs}, s, train=True,
                            mutable=["batch_stats"])
        return jlc(s, out)[0] / B, mut["batch_stats"]

    def cast(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)

    with jax.enable_x64(dtype == np.float64):
        (jl, jbs), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            cast(variables["params"]), cast(variables["batch_stats"]), cast(batch))
        to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
        return float(jl), to_np(jbs), named(to_np(jg))


@functools.lru_cache(maxsize=None)
def _jax_step_f64(flag_items):
    """``_jax_step`` in f64 for the model of ``flags`` and seed 1, once per
    configuration."""
    jcfg, jm, variables, _, batch = _pair(dict(flag_items), seed=1)
    return _jax_step(jcfg, jm, variables, batch, np.float64)


def test_jax_f32_gradient_drift():
    """The finding behind the f64 reference above, kept measured: JAX's f32
    gradient of some conv4 leaf is over 1e-2 of that leaf away from JAX's
    f64 gradient, and the port's f32 gradient is within 1e-4 of every
    leaf's f64 gradient (the floor of ``close_leaves`` aside)."""
    flags = _flags(*TRAIN[0])
    jcfg, jm, variables, pm, batch = _pair(flags, seed=1)
    _, _, g32 = _jax_step(jcfg, jm, variables, batch, np.float32)
    _, _, g64 = _jax_step_f64(tuple(sorted(flags.items())))
    drift = max(np.abs(g32[n] - g64[n]).max() / np.abs(g64[n]).max()
                for n in g64 if n.startswith("conv4."))
    assert drift > 1e-2
    pm.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (LossComputer(Config(**flags).finalize())(tb, pm(tb))[0] / B).backward()
    close_leaves({n: p.grad.numpy() for n, p in pm.named_parameters()}, g64, 1e-4)


def test_weight_bridge_both_ways():
    """JAX tree -> port (``jax_to_state_dict``, strict) -> reference names ->
    JAX tree (JAX's ``convert_nlspn``): every leaf comes back unchanged."""
    _, _, variables, pm, _ = _pair(_flags())
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    params, stats = convert_nlspn(sd)
    flat = named(params, stats)
    orig = named(variables["params"], variables["batch_stats"])
    assert flat.keys() == orig.keys() == sd.keys()
    assert all(np.array_equal(flat[k], orig[k]) for k in orig)


def test_reference_state_dict_loads_strict():
    """A reference-named NLSPN state dict (the synthetic one of the JAX
    converter's test) loads into build_model's resnet18/TGASS model with
    strict=True, and JAX's convert_nlspn of it maps back onto the same
    names and values."""
    from test_convert_mpvit_nlspn import _synth_nlspn_sd

    sd = _synth_nlspn_sd()
    pm = build_model(Config(**_flags()).finalize(), device="cpu")
    pm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    params, stats = convert_nlspn(sd)
    back = named(params, stats)
    assert back.keys() == sd.keys() and all(np.array_equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("network", ["resnet18", "resnet34"])
@pytest.mark.parametrize("affinity", ["AS", "ASS", "TC", "TGASS"])
def test_build_model_covers_the_jax_tree(network, affinity):
    """build_model builds every network and affinity mode with the names and
    shapes of the JAX model's tree (TC's constant is a buffer the JAX tree
    does not hold); TGASS's aff_scale_const starts at affinity_gamma * 8."""
    flags = _flags(affinity, network=network)
    jm = JNLSPN(args=jconfig.Config(**flags).finalize())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in _batch().items()}, train=False))
    ref = {k: tuple(v.shape) for k, v in jax_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               {k: dict(v) for k, v in shapes.items()})["params"],
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               dict(shapes["batch_stats"]))).items()}
    pm = build_model(Config(**flags).finalize(), device="cpu")
    assert isinstance(pm, NLSPNModel) and not pm.training
    ours = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    if affinity == "TC":
        assert ours.pop("prop_layer.aff_scale_const") == (1,)
    assert ours == ref
    assert len(pm.conv4) == (2 if network == "resnet18" else 6)
    if affinity == "TGASS":
        assert pm.prop_layer.aff_scale_const.item() == 0.5 * 8


def test_fresh_model_propagates_as_the_identity():
    """With the zero-initialised offset conv every offset is 0 and the
    centre affinity 1 under TGASS: pred equals clamp(pred_init, 0), at both
    radii (the JAX package's own structural check)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for radius in (0, 6):
        pm = build_model(Config(**_flags(radius=radius)).finalize(), device="cpu")
        with torch.no_grad():
            out = pm(batch)
        np.testing.assert_allclose(out["pred"].numpy(),
                                   np.clip(out["pred_init"].numpy(), 0, None),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["aff"][..., 4].numpy(), 1.0, atol=1e-6)


def test_eval_step_returns_the_summary_extras():
    """make_eval_step(extra_keys=NLSPNSummary.SAVE_KEYS) returns those
    outputs; a key the output lacks or holds as None (confidence without
    conf_prop, the diffusion keys) is left out, as JAX's eval step does."""
    from diffusiondepth_tpu_torch import make_eval_step
    from diffusiondepth_tpu_torch.summary import NLSPNSummary

    pm = build_model(Config(**_flags(conf_prop=False)).finalize(), device="cpu")
    step = make_eval_step(pm, extra_keys=NLSPNSummary.SAVE_KEYS + ("ddim_loss", "missing"))
    pred, metric, extras = step({k: torch.from_numpy(v) for k, v in _batch().items()})
    assert tuple(pred.shape) == (B, H, W, 1) and tuple(metric.shape) == (1, 8)
    assert set(extras) == set(NLSPNSummary.SAVE_KEYS) - {"confidence"}
    assert tuple(extras["pred_inter"].shape) == (3, B, H, W, 1)
