"""The port's MPViT against the JAX modules on the CPU: ConvRelPosEnc and
FactorAttConvRelPosEnc alone, the ``mpvit_tiny`` pyramid at 64x96 in f32
and module by module in bf16, the ``norm_eval`` BatchNorm freeze in
training, and drop-path masks drawn from the caller's generator."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.backbones import mpvit as jmp  # noqa: E402
from diffusiondepth_tpu_torch.models.backbones import mpvit as pmp  # noqa: E402
from diffusiondepth_tpu_torch.models.common import BatchNorm2d  # noqa: E402

from test_torch_support import backbone_state_dict, module_variables, rel_err  # noqa: E402

torch.set_num_threads(1)


def _conv_weight(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


@pytest.mark.parametrize("window,heads", [({3: 1, 5: 1}, 2), ({3: 2, 5: 3, 7: 3}, 8)])
def test_conv_rel_pos_enc_matches_jax(window, heads):
    """q * depthwise-conv(v) over head groups, head-major channels: within
    1e-5 of the largest value."""
    rng = np.random.RandomState(0)
    ch = 4
    q = rng.randn(2, 6, 9, heads, ch).astype(np.float32)
    v = rng.randn(2, 6, 9, heads, ch).astype(np.float32)
    jm = jmp.ConvRelPosEnc(head_ch=ch, num_heads=heads, window=window)
    params = module_variables(jm, q, v)["params"]
    pm = pmp.ConvRelPosEnc(ch, heads, window)
    with torch.no_grad():
        for i, conv in enumerate(pm.conv_list):
            conv.weight.copy_(_conv_weight(params[f"conv_{i}"]["kernel"]))
            conv.bias.copy_(torch.from_numpy(params[f"conv_{i}"]["bias"]))
        out = pm(torch.from_numpy(q), torch.from_numpy(v))
    ref = jm.apply({"params": params}, jnp.asarray(q), jnp.asarray(v))
    assert rel_err(out.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("bf16", [False, True])
def test_factor_att_matches_jax(bf16):
    """Factorised attention with its CRPE (8 heads of 8 channels) on an
    input in the compute type: f32 within 1e-5 of the largest value, bf16
    within 2e-2."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 9, 64).astype(np.float32)
    dtype = jnp.bfloat16 if bf16 else None
    xj, xt = jnp.asarray(x, dtype or jnp.float32), torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)

    class _Att(jmp.nn.Module):
        @jmp.nn.compact
        def __call__(self, x):
            crpe = jmp.ConvRelPosEnc(head_ch=8, num_heads=8, dtype=dtype, name="crpe")
            return jmp.FactorAttConvRelPosEnc(dim=64, num_heads=8, dtype=dtype,
                                              name="att")(x, crpe)

    params = module_variables(_Att(), x, seed=1)["params"]
    pdt = torch.bfloat16 if bf16 else None
    crpe = pmp.ConvRelPosEnc(8, 8, dtype=pdt)
    att = pmp.FactorAttConvRelPosEnc(64, 8, dtype=pdt)
    with torch.no_grad():
        for i, conv in enumerate(crpe.conv_list):
            conv.weight.copy_(_conv_weight(params["crpe"][f"conv_{i}"]["kernel"]))
            conv.bias.copy_(torch.from_numpy(params["crpe"][f"conv_{i}"]["bias"]))
        for name in ("qkv", "proj"):
            lin = getattr(att, name)
            lin.weight.copy_(torch.from_numpy(params["att"][name]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(params["att"][name]["bias"]))
        out = att(xt, crpe)
    ref = _Att().apply({"params": params}, xj)
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) <= (2e-2 if bf16 else 1e-5)


def _tiny(bf16=False, seed=0):
    x = np.random.RandomState(seed).randn(2, 64, 96, 3).astype(np.float32)
    jm = jmp.mpvit_tiny(dtype=jnp.bfloat16 if bf16 else None)
    variables = module_variables(jm, x, seed=seed, train=False)
    pm = pmp.mpvit_tiny(dtype=torch.bfloat16 if bf16 else None)
    pm.load_state_dict(backbone_state_dict(variables), strict=True)
    return x, jm, variables, pm


@pytest.fixture(scope="module")
def tiny_f32():
    """f32 mpvit_tiny in both packages and the JAX pyramid in eval and in
    training mode (one compile): (x, variables, port module, eval pyramid,
    (training pyramid, batch_stats after it))."""
    x, jm, variables, pm = _tiny()
    ref, train = jax.jit(lambda v, x: (
        jm.apply(v, x, train=False), jm.apply(v, x, train=True, mutable=["batch_stats"])))(
            variables, jnp.asarray(x))
    return x, variables, pm, ref, train


def test_mpvit_tiny_pyramid_matches_jax_f32(tiny_f32):
    """The four levels of mpvit_tiny at 64x96 (1/2 .. 1/16; 96, 176, 216,
    216 channels) in eval mode, f32: within 1e-4 of each level's largest
    value (summation order)."""
    x, _, pm, ref, _ = tiny_f32
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [(2, 32, 48, 96), (2, 16, 24, 176),
                                              (2, 8, 12, 216), (2, 4, 6, 216)]
    for a, b in zip(out, ref):
        assert rel_err(a.numpy(), b) <= 1e-4


def test_mpvit_tiny_bf16_module_by_module():
    """Under the bf16 policy every module of mpvit_tiny (stem convs, patch
    embeds, InvRes, path encoders, aggregates), given the JAX module's own
    bf16 input, returns bf16 within 2e-2 of the JAX module's output's
    largest value. The whole pyramid is not compared: both packages' bf16
    levels sit 2-3.5% from the f32 levels at 64x96, and 23 blocks deep
    they drift apart by as much."""
    x, jm, variables, pm = _tiny(bf16=True, seed=2)
    _, inter = jax.jit(lambda v, x: jm.apply(v, x, train=False, capture_intermediates=True,
                                             mutable=["intermediates"]))(variables,
                                                                         jnp.asarray(x))
    got = {k: np.asarray(v["__call__"][0], np.float32)
           for k, v in inter["intermediates"].items() if k != "__call__"}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    def check(name, out):
        assert out.dtype == torch.bfloat16, name
        assert rel_err(out.float().numpy(), got[name]) < 2e-2, name

    pm.eval()
    with torch.no_grad():
        check("stem0", pm.stem[0](torch.from_numpy(x)))
        check("stem1", pm.stem[1](t(got["stem0"])))
        prev = got["stem1"]
        for s, (embed, stage) in enumerate(zip(pm.patch_embed_stages, pm.mhca_stages)):
            paths = []
            for p, pe in enumerate(embed.patch_embeds):
                check(f"stage{s}_patch_embed{p}", pe(t(prev)))
                prev = got[f"stage{s}_patch_embed{p}"]
                paths.append(prev)
            check(f"stage{s}_invres", stage.InvRes(t(paths[0])))
            feats = [got[f"stage{s}_invres"]]
            for p, enc in enumerate(stage.mhca_blks):
                check(f"stage{s}_mhca{p}", pm._encoder(enc, t(paths[p]), None))
                feats.append(got[f"stage{s}_mhca{p}"])
            check(f"stage{s}_aggregate", stage.aggregate(t(np.concatenate(feats, -1))))
            prev = got[f"stage{s}_aggregate"]


def test_norm_eval_freezes_batchnorm(tiny_f32):
    """Under norm_eval, train() leaves every BatchNorm of the backbone in
    eval mode: a training-mode forward equals flax's ``train=True`` apply
    (1e-4 of each level's largest value; mpvit_tiny has no drop-path), and
    every running statistic is bit-unchanged, as flax's batch_stats."""
    x, variables, pm, _, (ref, mut) = tiny_f32
    before = {k: v.clone() for k, v in pm.state_dict().items() if "running" in k}
    pm.train()
    assert pm.training
    assert not any(m.training for m in pm.modules() if isinstance(m, BatchNorm2d))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for a, b in zip(out, ref):
        assert rel_err(a.numpy(), b) <= 1e-4
    for k, v in pm.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k
    jax.tree_util.tree_map(np.testing.assert_array_equal, mut["batch_stats"],
                           variables["batch_stats"])


def test_drop_path_masks_come_from_the_generator():
    """A small MPViT with drop-path 0.5 in training: the same generator seed
    gives the same pyramid, another seed another one; eval draws nothing
    (the generator's state is untouched) and drops nothing."""
    torch.manual_seed(0)
    pm = pmp.MPViT(num_layers=(1, 1, 1, 1), num_path=(2, 2, 2, 2), embed_dims=(16, 16, 16, 16),
                   mlp_ratios=(2, 2, 2, 2), drop_path_rate=0.5)
    x = torch.randn(4, 32, 32, 3)
    pm.train()
    with torch.no_grad():
        a = pm(x, generator=torch.Generator().manual_seed(1))
        b = pm(x, generator=torch.Generator().manual_seed(1))
        c = pm(x, generator=torch.Generator().manual_seed(2))
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        assert not all(torch.equal(u, v) for u, v in zip(a, c))
        g = torch.Generator().manual_seed(3)
        state = g.get_state()
        pm.eval()
        pm(x, generator=g)
        assert torch.equal(g.get_state(), state)
