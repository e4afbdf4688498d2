"""The port's denoiser chain and DDIM step (plain versions of kernels K1 and
K3, the arithmetic the CUDA and Triton kernels reproduce) against the JAX
package's Pallas kernels in interpret mode and its jnp twin."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.heads.denoiser import ScheduledCNNRefine  # noqa: E402
from diffusiondepth_tpu.ops import fused_denoiser as jfd  # noqa: E402
from diffusiondepth_tpu_torch.ops import fused_denoiser as pfd  # noqa: E402

torch.set_num_threads(1)


def _setup(B=2, H=16, W=21, C=32, seed=0):
    """The JAX test's set-up (tests/test_fused_denoiser.py): randomized
    bf16-policy denoiser parameters, a bf16 latent and condition."""
    rng = np.random.RandomState(seed)
    den = ScheduledCNNRefine(channels_in=C, channels_noise=16, use_fused=False,
                             dtype=jnp.bfloat16)
    lat = jnp.asarray(rng.randn(B, H, W, 16), jnp.bfloat16)
    cond = jnp.asarray(rng.randn(B, H, W, C), jnp.bfloat16)
    vs = den.init(jax.random.PRNGKey(0), lat, 100, cond)
    leaves, tree = jax.tree_util.tree_flatten(vs["params"])
    leaves = [jnp.asarray(rng.randn(*l.shape) * 0.3, l.dtype) for l in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    te = params["time_embedding"]["embedding"][100].astype(jnp.bfloat16)
    te_b = jnp.broadcast_to(te[None, :], (B, C))
    return den, params, lat, cond, te_b


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t.to(dtype) if dtype is not None else t


def _port_params(params):
    ne0, gn0, ne1, gn1, fa, fb, pr0, gn2, pr1, gn3 = jfd._chain_params(params)

    def conv(cp):  # HWIO is the kernel's (3, 3, Cin, Cout) layout
        return _t(cp["kernel"], torch.bfloat16), _t(cp["bias"])

    def gn(gp):
        return _t(gp["scale"]), _t(gp["bias"])

    return {"ne0": conv(ne0), "gn0": gn(gn0), "ne1": conv(ne1), "gn1": gn(gn1),
            "fa": conv(fa), "fb": conv(fb), "pr0": conv(pr0), "gn2": gn(gn2),
            "pr1": conv(pr1), "gn3": gn(gn3)}


def _port_eps(params, lat, cond, te_b):
    u6, a3, b3 = pfd.denoiser_chain(_port_params(params), _t(lat, torch.bfloat16),
                                    _t(cond, torch.bfloat16), _t(te_b, torch.bfloat16))
    return pfd.finish_eps(u6, a3, b3).float().numpy()


@pytest.mark.parametrize("B,H,W,C,seed", [(2, 16, 21, 32, 0), (1, 8, 13, 32, 3)])
def test_chain_matches_pallas_interpret(B, H, W, C, seed):
    """The port's six-link chain == fused_denoiser_apply run through the
    Pallas kernels in interpret mode (odd width, B=1 included). Both round
    to bf16 at the same points; they differ by f32 summation order, which
    can move a bf16 value by one step, renormalised by four GroupNorms:
    atol 0.03 and 2e-2 of the largest value."""
    den, params, lat, cond, te_b = _setup(B, H, W, C, seed)
    ref = np.asarray(jfd.fused_denoiser_apply(params, lat, cond, te_b, interpret=True),
                     np.float32)
    out = _port_eps(params, lat, cond, te_b)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= max(0.03, 2e-2 * np.abs(ref).max())


def test_chain_matches_jnp_twin():
    """The port's chain == the JAX jnp twin ``_jnp_chain`` (bf16 convs and
    the bf16 GroupNorm of the flax module) within the JAX test's own
    tolerance for that pair (atol 0.12, rtol 0.1)."""
    den, params, lat, cond, te_b = _setup(seed=1)
    feat = cond + te_b[:, None, None, :]
    ref = np.asarray(jfd._jnp_chain(params, lat, feat), np.float32)
    out = _port_eps(params, lat, cond, te_b)
    np.testing.assert_allclose(out, ref, atol=0.12, rtol=0.1)


@pytest.mark.parametrize("link", ["plain", "gn_relu_stats", "gn_relu_add_te", "stats_16"])
def test_conv_link_matches_pallas_interpret(link):
    """One link of the port (plain K1) == ``_fused_link`` in interpret mode
    on the zero-bordered layout: y to one bf16 step (atol 2e-2 of the
    largest value) and the GroupNorm partial sums, summed over blocks, to
    f32 summation order (1e-5 relative)."""
    rng = np.random.RandomState(7)
    B, H, W = 2, 16, 13
    cin, cout = (16, 64) if link == "plain" else (64, 16) if link == "stats_16" else (32, 32)
    x = rng.randn(B, H, W, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    kw = {}
    if link != "plain":
        kw["emit_stats"] = link != "gn_relu_add_te"
    if link.startswith("gn"):
        kw.update(aeff=(1 + 0.2 * rng.randn(B, cin)).astype(np.float32),
                  beff=(0.2 * rng.randn(B, cin)).astype(np.float32), relu_in=True)
    if link == "gn_relu_add_te":
        kw.update(add=rng.randn(B, H, W, cin).astype(np.float32),
                  te=(0.3 * rng.randn(B, cin)).astype(np.float32))
    wp = jfd.padded_width(W)
    bf = jnp.bfloat16

    def pad(a):
        return jfd.pad_w(jnp.asarray(a, bf), wp)

    jy, jps = jfd._fused_link(
        pad(x), jnp.asarray(w, bf), W=W, bias=jnp.asarray(bias),
        aeff=None if "aeff" not in kw else jnp.asarray(kw["aeff"]),
        beff=None if "beff" not in kw else jnp.asarray(kw["beff"]),
        relu_in=kw.get("relu_in", False),
        add=None if "add" not in kw else pad(kw["add"]),
        te=None if "te" not in kw else jnp.asarray(kw["te"], bf),
        emit_stats=kw.get("emit_stats", False), interpret=True)
    jy = np.asarray(jy, np.float32)[:, :, 1:W + 1]

    def tb(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    py, pps = pfd.conv_link(
        tb(x), tb(w), torch.from_numpy(bias),
        aeff=None if "aeff" not in kw else torch.from_numpy(kw["aeff"]),
        beff=None if "beff" not in kw else torch.from_numpy(kw["beff"]),
        relu=kw.get("relu_in", False),
        add=None if "add" not in kw else tb(kw["add"]),
        te=None if "te" not in kw else tb(kw["te"]),
        stats=kw.get("emit_stats", False))
    py = py.float().numpy()
    assert np.abs(py - jy).max() <= 2e-2 * np.abs(jy).max()
    if kw.get("emit_stats"):
        js = np.asarray(jps).sum(1)
        ps = pps.sum(1).numpy()
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-5 * np.abs(js).max())
    else:
        assert pps is None


def test_gn_affine_from_partials_matches():
    """Partials -> GroupNorm affine in f32 (1e-6 relative)."""
    rng = np.random.RandomState(2)
    ps = rng.randn(2, 5, 2, 64).astype(np.float32)
    ps[:, :, 1] = np.abs(ps[:, :, 1]) * 10 + 5
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    ja, jb, _, _ = jfd._gn_affine_from_partials(jnp.asarray(ps), jnp.asarray(scale),
                                                jnp.asarray(bias), 4, 300)
    pa, pb = pfd.gn_affine_from_partials(torch.from_numpy(ps), torch.from_numpy(scale),
                                         torch.from_numpy(bias), 4, 300)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("a_t,a_prev", [(0.63, 0.89), (0.0047, 0.0071), (0.9899, 1.0)])
def test_ddim_step_matches_flat_ddim_update(a_t, a_prev):
    """The port's DDIM step (plain K3: GroupNorm-3 affine + ReLU in bf16,
    then the f32 update) == the JAX eval path's finish
    ``relu(u6 * aeff + beff)`` followed by ``flat_ddim_update`` (Pallas,
    interpret mode): f32 to 1e-6 relative, the same operations in the
    same order."""
    rng = np.random.RandomState(4)
    B, H, Wp = 2, 8, 32
    u6 = jnp.asarray(rng.randn(B, H, Wp, 16), jnp.bfloat16)
    x = rng.randn(B, H, Wp, 16).astype(np.float32)
    aeff = (1 + 0.3 * rng.randn(B, 16)).astype(np.float32)
    beff = (0.3 * rng.randn(B, 16)).astype(np.float32)
    sched = np.array([np.sqrt(a_t), np.sqrt(1 - a_t), np.sqrt(a_prev),
                      np.sqrt(1 - a_prev)], np.float32)
    bf = jnp.bfloat16
    eps = jnp.maximum(u6 * jnp.asarray(aeff, bf)[:, None, None, :]
                      + jnp.asarray(beff, bf)[:, None, None, :], bf(0))
    ref = jfd.ungroup16(jfd.flat_ddim_update(
        jfd.group16(eps), jfd.group16(jnp.asarray(x)), jnp.asarray(sched)), 16)
    out = pfd.ddim_step(_t(u6, torch.bfloat16), torch.from_numpy(aeff),
                        torch.from_numpy(beff), torch.from_numpy(x), torch.from_numpy(sched))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref)).max())
