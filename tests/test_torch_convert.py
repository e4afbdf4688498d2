"""Weight bridge round trip: port state dict -> JAX trees through the JAX
package's converter -> back through ``jax_to_state_dict``, exactly, for
each ported backbone family, ``Diffusion_DCx4base_`` on each and the
concat head; and the routing the composition shares with the JAX package:
the default model, and the fused-chain guard."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.utils.convert_torch_checkpoint import (  # noqa: E402
    convert_reference_model, merge_params,
)
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.models import diffusion_model as jdm  # noqa: E402
from diffusiondepth_tpu.models.backbones import mmbev_resnet as jres  # noqa: E402
from diffusiondepth_tpu.models.heads import denoiser as jden  # noqa: E402
from diffusiondepth_tpu_torch import Config, build_model  # noqa: E402
from diffusiondepth_tpu_torch.models.backbones import mmbev_resnet as pres  # noqa: E402
from diffusiondepth_tpu_torch.models.heads import denoiser as pden  # noqa: E402
from diffusiondepth_tpu_torch.models.heads.ddim_head import DDIMDepthEstimate_Res  # noqa: E402
from diffusiondepth_tpu_torch.ops import fused_denoiser as pfd  # noqa: E402

from test_torch_support import (  # noqa: E402
    backbone_state_dict, init_latent, jax_model, jax_variables, make_batch, module_variables,
    port_config,
)

# family -> the JAX converter's Swin depths (None: not a Swin)
SWIN_DEPTHS = {"swin": (1, 2, 1, 1), "res18": None, "mpvit_tiny": None}
# model variants: "<family>+x4" is Diffusion_DCx4base_ on the family's
# model, "swin+bins" swin_micro under the concat head DDIMDepthEstimate_Swin
VARIANTS = ["swin+x4", "res18+x4", "mpvit_tiny+x4", "swin+bins"]
X4_CFG = dict(type="DeepDepthTransformWithUpsamplingX4", hidden=16, eps=1e-6)


def _split(case):
    family, _, variant = case.partition("+")
    return family, variant

torch.set_num_threads(1)


def _port_config(case):
    family, variant = _split(case)
    cfg = port_config(steps=1, family=family,
                      head="DDIMDepthEstimate_Swin" if variant == "bins" else None)
    if variant == "x4":
        cfg = dataclasses.replace(cfg, model_name="Diffusion_DCx4base_")
    return cfg


def _port_state_dict(case, seed=0):
    """A port model of ``case`` with every tensor random, BatchNorm running
    statistics included."""
    model = build_model(_port_config(case), device="cpu")
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        sd[k] = (r.abs() + 0.5) if k.endswith("running_var") else r
    model.load_state_dict(sd, strict=True)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_init(case):
    family, variant = _split(case)
    batch = make_batch(0, b=1, h=32, w=48)
    model = jax_model(steps=1, family=family,
                      head="DDIMDepthEstimate_Swin" if variant == "bins" else None)
    if variant == "x4":
        model = model.clone(depth_transform_cfg=X4_CFG)
        b, h, w, _ = batch["gt"].shape
        lat = np.zeros((b, h // 4, w // 4, 16), np.float32)
        return module_variables(model, batch, train=False, init_latent=lat)
    if case == "swin":
        return jax_variables(model, batch)
    return module_variables(model, batch, train=False, init_latent=init_latent(0, batch))


@pytest.mark.parametrize("family", sorted(SWIN_DEPTHS) + VARIANTS)
def test_state_dict_round_trip_is_exact(family):
    """convert_reference_model + merge_params over the JAX model's own init
    trees, then jax_to_state_dict: the same key set and every tensor equal
    bit for bit (the maps are transposes only). The Res head has no
    'upsample_add' convs on either side. The JAX converter reads the
    default depth transform only: under the X4 transform the port's
    transform is left out of the comparison (its tree is held by the
    leaf-count test below); the concat convs go through the converter's
    'upsample_fuse' names."""
    sd = _port_state_dict(family)
    if _split(family)[1] == "x4":
        sd = {k: v for k, v in sd.items() if ".depth_transform." not in k}
    params, stats = convert_reference_model(
        sd, swin_depths=SWIN_DEPTHS[_split(family)[0]] or (2, 2, 18, 2))

    variables = _jax_init(family)
    merged_p = merge_params(variables["params"], params)
    merged_s = merge_params(variables["batch_stats"], stats)
    back = jax_to_state_dict(merged_p, merged_s)
    if _split(family)[1] == "x4":
        back = {k: v for k, v in back.items() if ".depth_transform." not in k}

    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("family", sorted(SWIN_DEPTHS) + ["res18_cbam"] + VARIANTS)
def test_every_jax_leaf_reaches_the_port(family):
    """Every leaf of the JAX model's params and batch_stats is used: the
    port's state dict has exactly as many values as the JAX trees, and it
    loads strictly into the port's model (the X4 transform's tree and the
    concat convs included). ``res18_cbam``: the res18 layout with CBAM
    blocks, a backbone no registered name builds (no reference converter
    reads CBAM either), held alone."""
    if family == "res18_cbam":
        x = np.zeros((1, 32, 48, 3), np.float32)
        variables = module_variables(
            jres.ResNetForMMBEV(block_type="BasicBlockWithCBAM"), x, train=False)
        port = pres.ResNetForMMBEV(block_type="BasicBlockWithCBAM")
        sd = backbone_state_dict(variables)
    else:
        variables = _jax_init(family)
        port = build_model(_port_config(family), device="cpu")
        sd = jax_to_state_dict(variables["params"], variables["batch_stats"])
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
    assert sum(v.numel() for v in sd.values()) == n_jax
    port.load_state_dict(sd, strict=True)


def test_unknown_tree_raises():
    """A leaf the bridge does not map raises, as does an unknown backbone."""
    variables = _jax_init("res18")
    params = dict(variables["params"])
    params["depth_backbone"] = dict(params["depth_backbone"], extra={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="unknown ResNet subtree"):
        jax_to_state_dict(params, variables["batch_stats"])
    with pytest.raises(ValueError, match="unknown backbone"):
        jax_to_state_dict({"depth_backbone": {"blocks": {"kernel": np.zeros(3)}}})
    head = dict(params["depth_head"], stray={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        jax_to_state_dict({"depth_head": head})


def test_default_config_builds_the_jax_default_model():
    """Config(model_name="Diffusion_DCbase_") builds mmbev_res18 under
    DDIMDepthEstimate_Res in both packages: the same backbone and head
    names, the 'add' denoiser without the 'upsample_add' convs, and as
    many parameter and statistic values as the JAX model's trees."""
    jcfg = jconfig.Config(model_name="Diffusion_DCbase_")
    jm = jdm.build_model(jcfg)
    assert (jm.backbone_name, jm.head_name) == ("mmbev_res18", "DDIMDepthEstimate_Res")
    model = build_model(Config(model_name="Diffusion_DCbase_").finalize(), device="cpu")
    assert isinstance(model.depth_backbone, pres.ResNetForMMBEV)
    assert [len(layer) for layer in model.depth_backbone.layers] == [2, 2, 2, 2]
    assert type(model.depth_head) is DDIMDepthEstimate_Res
    den = model.depth_head.model
    assert den.fuse == "add" and not hasattr(den, "upsample_add")
    batch = make_batch(0, b=1, h=32, w=48)
    variables = module_variables(jm, batch, train=False, init_latent=init_latent(0, batch))
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
    assert sum(v.numel() for v in model.state_dict().values()) == n_jax


_GUARD = [(fuse, use_fused, bf16, h) for fuse in ("add", "upsample_add", "upsample_concat")
          for use_fused in (True, False) for bf16 in (True, False) for h in (16, 12)]


@pytest.mark.parametrize("fuse,use_fused,bf16,latent_h", _GUARD)
def test_fused_guard_routes_as_jax_or_add(fuse, use_fused, bf16, latent_h, monkeypatch):
    """The port's fused_active(latent_h) equals the JAX denoiser's (its TPU
    term set true, the card standing where JAX tests for a TPU), or holds
    for 'add' under the terms on which JAX's holds for 'upsample_add' (the
    port's own guard: JAX runs 'add' on XLA), and the call takes the fused
    chain exactly then: 'upsample_concat', use_fused off, f32 and latent_h
    % 8 != 0 each run the module path. latent_h 16 is the X4 latent of a
    64-pixel image (12 of a 48-pixel one)."""
    monkeypatch.setattr(jden.ScheduledCNNRefine, "_on_tpu", staticmethod(lambda: True))

    def jax_guard(f):
        jmod = jden.ScheduledCNNRefine(channels_in=64, fuse=f, use_fused=use_fused,
                                       dtype=jnp.bfloat16 if bf16 else None)
        return jmod.apply({}, latent_h, method=lambda m, h: m.fused_active(h))

    want = jax_guard(fuse) or (fuse == "add" and jax_guard("upsample_add"))
    assert want == (fuse != "upsample_concat" and use_fused and bf16 and latent_h % 8 == 0)
    pmod = pden.ScheduledCNNRefine(64, 16, fuse=fuse, use_fused=use_fused,
                                   dtype=torch.bfloat16 if bf16 else None)
    assert pmod.fused_active(latent_h) == want

    calls = []
    apply = pfd.FusedDenoiser.apply
    monkeypatch.setattr(pfd.FusedDenoiser, "apply", lambda *a: calls.append(1) or apply(*a))
    g = torch.Generator().manual_seed(0)
    lat = torch.randn(1, latent_h, 8, 16, generator=g)
    cond = torch.randn(1, latent_h, 8, 64, generator=g).to(pmod.dtype or torch.float32)
    with torch.no_grad():
        eps = pmod(lat, 500, cond)
    assert eps.shape == (1, latent_h, 8, 16) and bool(torch.isfinite(eps.float()).all())
    assert bool(calls) == want


def test_unknown_fuse_and_backbone_module_raise():
    """No fallback: a fuse that neither package has, or a backbone module
    without a default head (no head_specify), raises: the latter with
    JAX's ``KeyError``."""
    with pytest.raises(ValueError, match="bogus"):
        pden.ScheduledCNNRefine(64, 16, fuse="bogus")
    cfg = Config(model_name="Diffusion_DCbase_", backbone_module="nlspn").finalize()
    with pytest.raises(KeyError, match="nlspn"):
        build_model(cfg, device="cpu")
