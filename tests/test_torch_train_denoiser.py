"""The training half of the port's denoiser chain (plain versions of
kernels K2, K5 and K6 behind ``FusedDenoiser`` and ``FusedSamplerStep``)
against the JAX package's Pallas backward kernels in interpret mode, its
jnp twin and an f32 autodiff oracle."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.ops import fused_denoiser as jfd  # noqa: E402
from diffusiondepth_tpu_torch.ops import fused_denoiser as pfd  # noqa: E402

from test_fused_denoiser import _chain_f32  # noqa: E402
from test_torch_fused_denoiser import _setup, _t  # noqa: E402

torch.set_num_threads(1)

BF = torch.bfloat16


def dist(a, b):
    """RMS distance normalised by the reference's RMS (the JAX accuracy
    gate's measure: robust to the few ReLU-kink flips bf16 noise causes)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-8))


def _flat_leaves(params):
    """The JAX chain parameters as the port's f32 leaves (CHAIN_KEYS order;
    HWIO conv kernels are the port's (3, 3, Cin, Cout) layout)."""
    out = []
    for leaf in jfd._chain_params(params):
        pair = (leaf["kernel"], leaf["bias"]) if "kernel" in leaf else (leaf["scale"], leaf["bias"])
        out += [_t(a).requires_grad_() for a in pair]
    return out


def _jax_flat(tree):
    out = []
    for leaf in jfd._chain_params(tree):
        pair = (leaf["kernel"], leaf["bias"]) if "kernel" in leaf else (leaf["scale"], leaf["bias"])
        out += [np.asarray(a, np.float32) for a in pair]
    return out


def _jit_vjp(fn, ct, *args):
    """``fn(*args)`` and its ``jax.vjp`` applied to ``ct``, compiled as one
    program (op by op, JAX compiles each of hundreds of small ops apart)."""

    def run(c, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(c)

    return jax.jit(run)(ct, *args)


def _port_vjp(params, lat, cond, te_b, ct):
    flat = _flat_leaves(params)
    x = _t(lat, BF).requires_grad_()
    c = _t(cond, BF).requires_grad_()
    te = _t(te_b, BF).requires_grad_()
    eps = pfd.FusedDenoiser.apply(x, c, te, *flat)
    eps.backward(_t(ct, BF))
    return eps, [f.grad.numpy() for f in flat], x.grad.float().numpy(), c.grad.float().numpy(), te


def test_chain_backward_matches_pallas_and_passes_accuracy_gate():
    """FusedDenoiser's backward (virtual link 7 + six plain K5 links +
    glue) with one timestep embedding per sample (the ddim_loss call)
    against ``jax.vjp`` of ``fused_denoiser`` (the Pallas backward chain in
    interpret mode), and both against the f32 autodiff oracle: each within
    2x the bf16 jnp twin's RMS distance to the oracle + 0.05 on every leaf
    (the JAX test's gate, tests/test_fused_denoiser.py), and the port
    within 0.1 RMS of the Pallas kernels (two bf16 paths that round at the
    same points, apart by summation order and ReLU-kink flips). d(te) is
    the per-sample spatial sum of d(cond)."""
    den, params, lat, cond, _ = _setup(B=2, H=8, W=13, C=32, seed=2)
    te_b = params["time_embedding"]["embedding"][jnp.asarray([100, 7])].astype(jnp.bfloat16)
    feat = cond + te_b[:, None, None, :]
    ct = jnp.asarray(np.random.RandomState(9).randn(*lat.shape) * 0.1, jnp.bfloat16)
    gP, gL, gF = _jit_vjp(jfd._jnp_chain, ct, params, lat, feat)[1]
    oP, oL, oF = _jit_vjp(_chain_f32, ct.astype(jnp.float32), params, lat, feat)[1]
    kP, kL, kF, kT = _jit_vjp(jfd.fused_denoiser, ct, params, lat, cond, te_b)[1]

    _, pP, pL, pF, te = _port_vjp(params, lat, cond, te_b, ct)
    pT = te.grad.float().numpy()
    oT = np.asarray(oF, np.float32).sum((1, 2))
    gT = np.asarray(gF, np.float32).sum((1, 2))

    for p, k, o, tw in ((pL, kL, oL, gL), (pF, kF, oF, gF), (pT, kT, oT, gT)):
        assert dist(p, o) < 2 * dist(tw, o) + 0.05, (dist(p, o), dist(tw, o))
        assert dist(p, k) < 0.1, dist(p, k)
    for p, o, tw, k in zip(pP, _jax_flat(oP), _jax_flat(gP), _jax_flat(kP)):
        assert np.isfinite(p).all()
        assert dist(p, o) < 2 * dist(tw, o) + 0.05, (dist(p, o), dist(tw, o))
        assert dist(k, o) < 2 * dist(tw, o) + 0.05
        assert dist(p, k) < 0.1, dist(p, k)


def _sampler_case():
    """A mid-trajectory sampler step at micro shape: the chain's parameters,
    the latent, condition and timestep embedding, the schedule row and
    cotangents of the (f32, bf16) latent pair."""
    den, params, lat, cond, te_b = _setup(B=2, H=8, W=13, C=32, seed=4)
    a_t, a_prev = 0.63, 0.89
    rng = np.random.RandomState(5)
    x32 = rng.randn(*lat.shape).astype(np.float32)
    sched = np.array([np.sqrt(a_t), np.sqrt(1 - a_t), np.sqrt(a_prev), np.sqrt(1 - a_prev)],
                     np.float32)
    dxp = (rng.randn(*lat.shape) * 0.1).astype(np.float32)
    dxpb = (rng.randn(*lat.shape) * 0.1).astype(np.float32)
    return params, x32, cond, te_b, sched, dxp, dxpb


def _port_sampler_step(params, x32, cond, te_b, sched, dxp, dxpb):
    """FusedSamplerStep forward and backward: (x', x'_bf16, d x_f32,
    d x_bf16, d cond, d te, parameter grads), the gradients as numpy f32."""
    flat = _flat_leaves(params)
    xf = torch.from_numpy(x32).requires_grad_()
    xb = torch.from_numpy(x32).to(BF).requires_grad_()
    c = _t(cond, BF).requires_grad_()
    te = _t(te_b, BF).requires_grad_()
    xp, xpb = pfd.FusedSamplerStep.apply(xf, xb, c, te, torch.from_numpy(sched), *flat)
    torch.autograd.backward((xp, xpb), (torch.from_numpy(dxp), torch.from_numpy(dxpb).to(BF)))
    grads = [t.grad.float().numpy() for t in (xf, xb, c, te)]
    return (xp.detach().numpy(), xpb.detach().float().numpy(), *grads,
            [f.grad.numpy() for f in flat])


def test_sampler_step_matches_jax_vjp():
    """FusedSamplerStep (six plain K1 links + plain K2 forward; plain K6,
    glue and six plain K5 links backward) against ``jax.vjp`` of
    ``fused_sampler_step`` (Pallas, interpret mode) on the zero-bordered
    layout: the f32 and bf16 latents to 2e-2 of the largest value (the
    chain's bf16 rounding), every gradient within RMS 0.1 (the K6 partials
    sum rounded t6, the JAX kernel unrounded products, ~0.3% apart)."""
    params, x32, cond, te_b, sched, dxp, dxpb = _sampler_case()
    W = x32.shape[2]
    wp = jfd.padded_width(W)

    def pad(a, dt):
        return jfd.pad_w(jnp.asarray(a, dt), wp)

    def fn(params, xf, xb, condp, te):
        return jfd.fused_sampler_step(W, True, True, params, xf, xb, condp, te, jnp.asarray(sched))

    (jxp, jxpb), (jP, jdx, jdxb, jdc, jdte) = _jit_vjp(
        fn, (pad(dxp, jnp.float32), pad(dxpb, jnp.bfloat16)),
        params, pad(x32, jnp.float32), pad(x32, jnp.bfloat16), pad(cond, jnp.bfloat16), te_b)

    def unpad(a):
        return np.asarray(a, np.float32)[:, :, 1:W + 1]

    xp, xpb, dxf, dxb, dc, dte, pP = _port_sampler_step(params, x32, cond, te_b, sched, dxp,
                                                        dxpb)
    ref = unpad(jxp)
    assert np.abs(xp - ref).max() <= 2e-2 * np.abs(ref).max()
    assert np.abs(xpb - unpad(jxpb)).max() <= 2e-2 * np.abs(ref).max()
    assert dist(dxf, unpad(jdx)) < 1e-5
    for a, b in ((dxb, unpad(jdxb)), (dc, unpad(jdc)), (dte, np.asarray(jdte, np.float32))):
        assert dist(a, b) < 0.1
    for p, k in zip(pP, _jax_flat(jP)):
        assert dist(p, k) < 0.1, dist(p, k)


def test_sampler_step_passes_accuracy_gate():
    """FusedSamplerStep's gradients (plain K6, glue, six plain K5) against
    an f32 autodiff oracle of the same step (the f32 chain, then the DDIM
    update in f32), each within 2x the RMS distance of the bf16 jnp twin's
    autodiff + 0.05: the JAX accuracy gate (tests/test_fused_denoiser.py),
    applied to the whole step. The latent's gradient is the sum over both
    copies; d(te) is the per-sample spatial sum of d(feat)."""
    params, x32, cond, te_b, sched, dxp, dxpb = _sampler_case()
    sa, sb, sp, sq = (float(v) for v in sched)
    ct = jnp.asarray(dxp + np.asarray(jnp.asarray(dxpb, jnp.bfloat16), np.float32))

    def update(eps, x):
        x0 = (x - sb * eps) / sa
        return sp * x0 + sq * (x - sa * x0) / sb

    def oracle(params, x, feat):
        return update(_chain_f32(params, x, feat), x)

    def twin(params, x, feat):
        eps = jfd._jnp_chain(params, x.astype(jnp.bfloat16), feat.astype(jnp.bfloat16))
        return update(eps.astype(jnp.float32), x)

    feat = (cond + te_b[:, None, None, :]).astype(jnp.float32)
    _, (oP, oX, oF) = _jit_vjp(oracle, ct, params, jnp.asarray(x32), feat)
    _, (gP, gX, gF) = _jit_vjp(twin, ct, params, jnp.asarray(x32), feat)
    _, _, dxf, dxb, dc, dte, pP = _port_sampler_step(params, x32, cond, te_b, sched, dxp, dxpb)

    pairs = [(dxf + dxb, oX, gX), (dc, oF, gF),
             (dte, np.asarray(oF).sum((1, 2)), np.asarray(gF, np.float32).sum((1, 2)))]
    pairs += list(zip(pP, _jax_flat(oP), _jax_flat(gP)))
    for p, o, tw in pairs:
        assert np.isfinite(p).all()
        assert dist(p, o) < 2 * dist(tw, o) + 0.05, (dist(p, o), dist(tw, o))


@pytest.mark.parametrize("a_t,a_prev", [(0.63, 0.89), (0.0047, 0.0071), (0.9899, 1.0)])
def test_sched_bwd_plain_matches_pallas(a_t, a_prev):
    """Plain K6 against ``_sched_bwd`` in interpret mode, mid-trajectory,
    at t = 950 and at the last step: dx exactly the closed form (f32,
    1e-6), t6 to one bf16 step (1e-2 of the largest value), the partials
    to 1e-2 relative (rounded vs unrounded sums)."""
    rng = np.random.RandomState(3)
    B, H, W = 2, 8, 13
    wp = jfd.padded_width(W)
    dxp = rng.randn(B, H, W, 16).astype(np.float32)
    dxpb = rng.randn(B, H, W, 16).astype(np.float32)
    u6 = rng.randn(B, H, W, 16).astype(np.float32)
    coefs = np.zeros((B, 8, 16), np.float32)
    coefs[:, 0] = 1 + 0.2 * rng.randn(B, 16)
    coefs[:, 1:4] = 0.2 * rng.randn(B, 3, 16)
    coefs[:, 4] = 1 + 0.2 * rng.randn(B, 16)
    sched = np.array([np.sqrt(a_t), np.sqrt(1 - a_t), np.sqrt(a_prev), np.sqrt(1 - a_prev)],
                     np.float32)

    def pad(a, dt):
        return jfd.pad_w(jnp.asarray(a, dt), wp)

    jdx, jt6, jps = jfd._sched_bwd(pad(dxp, jnp.float32), pad(dxpb, jnp.bfloat16),
                                   pad(u6, jnp.bfloat16), jnp.asarray(coefs),
                                   jnp.asarray(sched), W=W, interpret=True)
    dx, t6, ps = pfd.sched_bwd(torch.from_numpy(dxp), torch.from_numpy(dxpb).to(BF),
                               torch.from_numpy(u6).to(BF), torch.from_numpy(coefs),
                               torch.from_numpy(sched))
    jdx = np.asarray(jdx)[:, :, 1:W + 1]
    jt6 = np.asarray(jt6, np.float32)[:, :, 1:W + 1]
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-6, atol=1e-6 * np.abs(jdx).max())
    assert np.abs(t6.float().numpy() - jt6).max() <= 1e-2 * np.abs(jt6).max()
    js = np.asarray(jps).sum(1)
    np.testing.assert_allclose(ps.sum(1).numpy(), js, rtol=1e-2, atol=1e-2 * np.abs(js).max())
