"""The port's denoiser chain and DDIM step (plain versions of kernels K1 and
K3, the arithmetic the CUDA and Triton kernels reproduce) against the JAX
package's Pallas kernels in interpret mode and its jnp twin; the four-link
'add' chain (forward, and its backward behind ``FusedDenoiser`` and
``FusedSamplerStep``) against the module paths of both packages."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.heads.denoiser import ScheduledCNNRefine  # noqa: E402
from diffusiondepth_tpu.ops import fused_denoiser as jfd  # noqa: E402
from diffusiondepth_tpu_torch.models.heads import denoiser as pden  # noqa: E402
from diffusiondepth_tpu_torch.ops import fused_denoiser as pfd  # noqa: E402
from diffusiondepth_tpu_torch.utils import convert_jax_params as cj  # noqa: E402

torch.set_num_threads(1)

BF = torch.bfloat16


def _setup(B=2, H=16, W=21, C=32, seed=0, fuse="upsample_add"):
    """The JAX test's set-up (tests/test_fused_denoiser.py): randomized
    bf16-policy denoiser parameters, a bf16 latent and condition."""
    rng = np.random.RandomState(seed)
    den = ScheduledCNNRefine(channels_in=C, channels_noise=16, fuse=fuse, use_fused=False,
                             dtype=jnp.bfloat16)
    lat = jnp.asarray(rng.randn(B, H, W, 16), jnp.bfloat16)
    cond = jnp.asarray(rng.randn(B, H, W, C), jnp.bfloat16)
    vs = jax.eval_shape(lambda: den.init(jax.random.PRNGKey(0), lat, 100, cond))
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
    """Partials -> GroupNorm affine, inverse std and mean in f32 (1e-6
    relative)."""
    rng = np.random.RandomState(2)
    ps = rng.randn(2, 5, 2, 64).astype(np.float32)
    ps[:, :, 1] = np.abs(ps[:, :, 1]) * 10 + 5
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    ref = jfd._gn_affine_from_partials(jnp.asarray(ps), jnp.asarray(scale),
                                       jnp.asarray(bias), 4, 300)
    out = pfd.gn_affine_from_partials(torch.from_numpy(ps), torch.from_numpy(scale),
                                      torch.from_numpy(bias), 4, 300)
    for p, j in zip(out, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


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


# ---------------------------------------------------------------------------
# the four-link chain of the 'add' denoiser (the Res heads)
# ---------------------------------------------------------------------------


def _dist(a, b):
    """RMS distance over the reference's RMS."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-8))


def _port_add(params, C, dtype=BF, use_fused=True):
    """The port's 'add' ScheduledCNNRefine holding the JAX module's
    parameters: fused (the chain's plain versions on the CPU) or the
    module path, bf16 or f32."""
    m = pden.ScheduledCNNRefine(C, 16, fuse="add", use_fused=use_fused, dtype=dtype)
    sd = {"time_embedding.weight": params["time_embedding"]["embedding"]}
    cj._conv_gn_block(sd, "noise_embedding", params["noise_embedding"])
    cj._conv_gn_block(sd, "pred", params["pred"])
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    return m


@pytest.mark.parametrize("fuse,links", [("add", 4), ("upsample_add", 6)])
def test_chain_links_follow_the_module(fuse, links):
    """The module's own structure picks the chain: 'upsample_add' gives
    ``chain_flat`` the fusion convs and six links, 'add' four: ne0 (stats),
    ne1 (GroupNorm-0, ReLU, stats), pr0 (GroupNorm-1, ReLU, the condition
    and te added, stats), pr1 (GroupNorm-2, ReLU, stats). The
    'upsample_concat' module has no chain."""
    m = pden.ScheduledCNNRefine(32, 16, fuse=fuse, dtype=BF)
    flat = m.chain_flat()
    assert len(flat) == 2 * (links + 4)
    assert set(pfd.chain_params_from_flat(flat)) == set(pfd.chain_keys(len(flat)))
    seen = []

    def link(x, w, bias, aeff=None, beff=None, relu=False, add=None, te=None, stats=False):
        seen.append((w.shape[2], w.shape[3], aeff is not None, relu, add is not None,
                     te is not None, stats))
        return pfd.conv_link_plain(x, w, bias, aeff, beff, relu, add, te, stats)

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 5, 16, generator=g).to(BF)
    cond = torch.randn(2, 8, 5, 32, generator=g).to(BF)
    te = torch.randn(2, 32, generator=g).to(BF)
    with torch.no_grad():
        it = pfd.chain_forward(m.chain_params(), x, cond, te, link)
    assert len(seen) == links and it["u6"].shape == (2, 8, 5, 16)
    if fuse == "add":
        assert seen == [(16, 64, False, False, False, False, True),
                        (64, 32, True, True, False, False, True),
                        (32, 64, True, True, True, True, True),
                        (64, 16, True, True, False, False, True)]
        assert "u3" not in it and "u4" not in it
    with pytest.raises(ValueError, match="upsample_concat"):
        pden.ScheduledCNNRefine(32, 16, fuse="upsample_concat", dtype=BF).chain_flat()


# (B, H, W) of the latents the chain runs at: bs8 serve at 352x1216, the
# X4 model's serve latent, a training micro-batch of 352x906 crops
_LATENTS = {"serve": (8, 176, 608), "x4": (8, 88, 304), "train": (4, 176, 453)}


@pytest.mark.parametrize("latent", sorted(_LATENTS))
@pytest.mark.parametrize("fuse,names,xf", [
    ("upsample_add", ("ne0", "ne1", "fa", "fb", "pr0", "pr1"), "fa"),
    ("add", ("ne0", "ne1", "pr0", "pr1"), "pr0")])
def test_xf_path_routes_one_link_a_chain(fuse, names, xf, latent):
    """K1's transform-warp path takes exactly the link whose input takes
    the chains' transform (GroupNorm, ReLU, the add map and te) over more
    than one 64-channel chunk: fa in the six-link chain, pr0 in the 'add'
    chain's four. ne1 and pr1 (transformed, one chunk), ne0, fb and the
    six-link chain's pr0 (untransformed) keep K1's own loop, at every
    latent. The links see broadcast zeros: no arithmetic."""
    m = pden.ScheduledCNNRefine(256, 16, fuse=fuse, dtype=BF)
    B, H, W = _LATENTS[latent]
    routed = []

    def link(x, w, bias, aeff=None, beff=None, relu=False, add=None, te=None, stats=False):
        cin, cout = w.shape[2], w.shape[3]
        assert x.shape == (B, H, W, cin)
        flags = pfd.link_flags(aeff, relu, add, te, stats)
        routed.append(pfd.conv_link_xf_path(cin, cout, flags))
        y = torch.zeros((), dtype=BF).expand(B, H, W, cout)
        return y, (torch.ones(B, 1, 2, cout) if stats else None)

    x = torch.zeros((), dtype=BF).expand(B, H, W, 16)
    cond = torch.zeros((), dtype=BF).expand(B, H, W, 256)
    with torch.no_grad():
        pfd.chain_forward(m.chain_params(), x, cond, torch.zeros(B, 256, dtype=BF), link)
    assert routed == [n == xf for n in names]


@pytest.mark.parametrize("n_leaves", [0, 14, 18, 22])
def test_chain_keys_refuse_other_counts(n_leaves):
    """A flat list with a leaf missing or added is refused, not read as
    the other chain: only 20 ('upsample_add') and 16 ('add') leaves name
    a chain."""
    assert len(pfd.chain_keys(20)) == 10 and "fa" in pfd.chain_keys(20)
    assert len(pfd.chain_keys(16)) == 8 and "fa" not in pfd.chain_keys(16)
    with pytest.raises(ValueError, match="20 or 16 leaves"):
        pfd.chain_keys(n_leaves)
    with pytest.raises(ValueError, match="20 or 16 leaves"):
        pfd.chain_params_from_flat([torch.zeros(1)] * n_leaves)


_ADD_CASES = [(2, 16, 21, 32, 0), (1, 8, 13, 32, 3), (2, 16, 21, 64, 5)]


@pytest.mark.parametrize("B,H,W,C,seed", _ADD_CASES)
def test_add_chain_matches_module_paths(B, H, W, C, seed):
    """The 'add' denoiser through the four-link chain (plain K1, then
    GroupNorm-3 + ReLU as K3 finishes it), f32 parameters and bf16
    activations, against the JAX 'add' module in f32 (the reference): its
    RMS distance is at most k = 1.5 times that of the bf16 module path, the
    port's and the JAX package's (measured: chain 0.0036-0.0045, module
    paths 0.0043-0.0057, a ratio of 0.79-0.84 on these cases and up to 1.0
    on others). Against the JAX bf16 module path directly: within 2e-2 of
    its largest value (measured 0.0075-0.0113)."""
    den, params, lat, cond, _ = _setup(B, H, W, C, seed, fuse="add")
    jb = np.asarray(den.apply({"params": params}, lat, 100, cond), np.float32)
    jf = np.asarray(ScheduledCNNRefine(channels_in=C, channels_noise=16, fuse="add",
                                       use_fused=False).apply(
        {"params": params}, lat.astype(jnp.float32), 100, cond.astype(jnp.float32)), np.float32)
    fused = _port_add(params, C)
    module = _port_add(params, C, use_fused=False)
    assert fused.fused_active(H) and not module.fused_active(H)
    with torch.no_grad():
        pf = fused(_t(lat), 100, _t(cond, BF)).float().numpy()
        pm = module(_t(lat), 100, _t(cond, BF)).float().numpy()
    d = _dist(pf, jf)
    assert d <= 1.5 * _dist(pm, jf), (d, _dist(pm, jf))
    assert d <= 1.5 * _dist(jb, jf), (d, _dist(jb, jf))
    assert np.abs(pf - jb).max() <= 2e-2 * np.abs(jb).max()


def _gate(fused, twin, oracle):
    """The JAX accuracy gate (tests/test_fused_denoiser.py) on each pair of
    gradients: the fused chain's RMS distance to the f32 oracle within 2x
    the bf16 module path's + 0.05."""
    for k in oracle:
        p, tw, o = fused[k], twin[k], oracle[k]
        assert np.isfinite(p).all(), k
        assert _dist(p, o) < 2 * _dist(tw, o) + 0.05, (k, _dist(p, o), _dist(tw, o))


_KINDS = {"fused": dict(), "twin": dict(use_fused=False),
          "oracle": dict(dtype=None, use_fused=False)}


@pytest.mark.parametrize("B,H,W,seed", [(2, 8, 13, 2), (2, 16, 21, 4)])
def test_add_denoiser_grads_pass_accuracy_gate(B, H, W, seed):
    """FusedDenoiser for 'add' (the ddim_loss call, one timestep per
    sample; backward: virtual link 7, four plain K5 links, pr0's with the
    condition's cotangent) against autograd through the module path: the
    gradients of the latent, the condition and every parameter, the
    time embedding's included, pass the accuracy gate against the f32
    module path's autograd (measured: chain 0.007-0.139, bf16 module path
    0.015-0.154, the largest ratio 1.34)."""
    _, params, lat, cond, _ = _setup(B, H, W, 32, seed, fuse="add")
    ct = torch.from_numpy(np.random.RandomState(9).randn(*lat.shape) * 0.1).to(BF).float()
    out = {}
    for kind, kw in _KINDS.items():
        m = _port_add(params, 32, **kw)
        x = _t(lat).requires_grad_()
        c = _t(cond, None if kind == "oracle" else BF).requires_grad_()
        eps = m(x.to(BF) if kind == "fused" else x, torch.tensor([100, 7][:B]), c)
        eps.float().backward(ct)
        out[kind] = {"latent": x.grad.float().numpy(), "cond": c.grad.float().numpy(),
                     **{n: p.grad.float().numpy() for n, p in m.named_parameters()}}
    _gate(out["fused"], out["twin"], out["oracle"])


def test_add_sampler_step_grads_pass_accuracy_gate():
    """FusedSamplerStep for 'add' (four plain K1 links + plain K2 forward;
    plain K6, glue and four plain K5 links backward) against autograd
    through the module path followed by the DDIM update in f32: the new
    f32 latent within 2e-2 of the bf16 module step's largest value, and
    the gradients of the latent (summed over both copies), the condition
    and every parameter pass the accuracy gate against the f32 module
    path's."""
    _, params, lat, cond, _ = _setup(2, 8, 13, 32, 4, fuse="add")
    rng = np.random.RandomState(5)
    x32 = rng.randn(*lat.shape).astype(np.float32)
    a_t, a_prev = 0.63, 0.89
    sched = torch.tensor([a_t ** 0.5, (1 - a_t) ** 0.5, a_prev ** 0.5, (1 - a_prev) ** 0.5])
    sa, sb, sp, sq = (float(v) for v in sched)
    dxp = torch.from_numpy(rng.randn(*lat.shape) * 0.1).float()
    dxpb = torch.from_numpy(rng.randn(*lat.shape) * 0.1).to(BF)
    out, new = {}, {}
    for kind, kw in _KINDS.items():
        m = _port_add(params, 32, **kw)
        c = _t(cond, None if kind == "oracle" else BF).requires_grad_()
        xf = torch.from_numpy(x32).requires_grad_()
        if kind == "fused":
            xb = torch.from_numpy(x32).to(BF).requires_grad_()
            te = m.time_embed(torch.tensor(100)).expand(2, 32).contiguous()
            xp, xpb = pfd.FusedSamplerStep.apply(xf, xb, c, te, sched, *m.chain_flat())
            torch.autograd.backward((xp, xpb), (dxp, dxpb))
            dx = xf.grad + xb.grad.float()
        else:
            eps = m(xf, torch.tensor(100), c).float()
            x0 = (xf - sb * eps) / sa
            xp = sp * x0 + sq * (xf - sa * x0) / sb
            xp.backward(dxp + dxpb.float())
            dx = xf.grad
        new[kind] = xp.detach().numpy()
        out[kind] = {"latent": dx.numpy(), "cond": c.grad.float().numpy(),
                     **{n: p.grad.float().numpy() for n, p in m.named_parameters()}}
    assert np.abs(new["fused"] - new["twin"]).max() <= 2e-2 * np.abs(new["twin"]).max()
    _gate(out["fused"], out["twin"], out["oracle"])
