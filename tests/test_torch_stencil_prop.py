"""The port's stencil propagation (``ops/stencil_prop.py``) on the CPU:
``build_stencil`` and ``stencil_apply`` against the JAX package's, forward
and gradients; the stencil against the port's own gather route
(``modulated_deform_conv`` with an all-ones kernel) where every |offset|
<= R, and against the gather of the clamped offsets beyond R; three
chained steps with their gradients; and the bytes autograd keeps for a
whole propagation. Tolerances: forward results within 1e-4 of their
largest value, gradients within 1e-3 (sums in another order)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.ops import stencil_prop as jsp  # noqa: E402
from diffusiondepth_tpu_torch.ops import stencil_prop as psp  # noqa: E402
from diffusiondepth_tpu_torch.ops.deform_conv import modulated_deform_conv  # noqa: E402

from test_torch_support import rel_err  # noqa: E402

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-4, 1e-3


def _inputs(seed, b=2, h=10, w=12, off_scale=2.0):
    rng = np.random.RandomState(seed)
    return {"offset": (off_scale * rng.randn(b, h, w, 18)).astype(np.float32),
            "aff": rng.randn(b, h, w, 9).astype(np.float32),
            "feat": rng.randn(b, h, w, 1).astype(np.float32)}


def _grad_check(jfn, pfn, inputs, seed=0):
    """Output and the gradient of every input under one random cotangent."""
    jin = [jnp.asarray(v) for v in inputs.values()]
    jout = jax.jit(jfn)(*jin)
    cot = np.random.RandomState(seed + 9).randn(*jout.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                              argnums=tuple(range(len(jin)))))(*jin)
    tin = [torch.tensor(v, requires_grad=True) for v in inputs.values()]
    out = pfn(*tin)
    (out * torch.from_numpy(cot)).sum().backward()
    assert tuple(out.shape) == tuple(jout.shape)
    assert rel_err(out.detach().numpy(), jout) <= FWD_TOL
    for name, t, g in zip(inputs, tin, jgrads):
        err = rel_err(t.grad.numpy(), g)
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("radius", [2, 6])
def test_build_stencil_matches_jax(radius):
    """Offsets of N(0, 2): some beyond radius 2, where the clamp acts."""
    inp = _inputs(radius)
    del inp["feat"]
    _grad_check(lambda o, a: jsp.build_stencil(o, a, radius),
                lambda o, a: psp.build_stencil(o, a, radius), inp)


@pytest.mark.parametrize("radius", [2, 6])
def test_stencil_apply_matches_jax(radius):
    rng = np.random.RandomState(10 + radius)
    D = psp.window_size(radius)
    inp = {"M": rng.randn(2, 10, 12, D * D).astype(np.float32),
           "feat": rng.randn(2, 10, 12, 1).astype(np.float32)}
    _grad_check(lambda m, f: jsp.stencil_apply(m, f, radius),
                lambda m, f: psp.stencil_apply(m, f, radius), inp)


def _gather_step(offset, aff, feat):
    ones = torch.ones(3, 3, 1, 1)
    return modulated_deform_conv(feat, offset, aff, ones, padding=1)


@pytest.mark.parametrize("radius", [3, 6])
def test_stencil_equals_gather_within_radius(radius):
    """Where every |offset| <= R the stencil step is the gather step; with
    offsets beyond R it is the gather step of the offsets clamped to
    [-R, R]. Forward and gradients."""
    inp = _inputs(20 + radius, off_scale=1.2 * radius)
    off = torch.from_numpy(inp["offset"])
    assert bool((off.abs() > radius).any()) and bool((off.abs() <= radius).any())
    for clamp in (False, True):
        o = off.clamp(-radius, radius) if clamp else off * (radius / (off.abs().max() + 1e-3))
        vals = {"offset": o.numpy(), "aff": inp["aff"], "feat": inp["feat"]}
        cot = torch.from_numpy(np.random.RandomState(1).randn(2, 10, 12, 1).astype(np.float32))
        outs, grads = [], []
        for route in ("stencil", "gather"):
            t = {k: torch.tensor(v, requires_grad=True) for k, v in vals.items()}
            if route == "stencil":
                out = psp.stencil_apply(psp.build_stencil(t["offset"], t["aff"], radius),
                                        t["feat"], radius)
            else:
                out = _gather_step(t["offset"], t["aff"], t["feat"])
            (out * cot).sum().backward()
            outs.append(out.detach().numpy())
            grads.append({k: v.grad.numpy() for k, v in t.items()})
        assert rel_err(outs[0], outs[1]) <= FWD_TOL
        for k in vals:
            if k == "offset" and clamp:
                continue  # the clamp zeroes the gradient of a clamped offset
            assert rel_err(grads[0][k], grads[1][k]) <= GRAD_TOL, k
    # beyond R: the unclamped stencil is the gather of the clamped offsets
    st = psp.stencil_apply(psp.build_stencil(off, torch.from_numpy(inp["aff"]), radius),
                           torch.from_numpy(inp["feat"]), radius)
    ref = _gather_step(off.clamp(-radius, radius), torch.from_numpy(inp["aff"]),
                       torch.from_numpy(inp["feat"]))
    assert rel_err(st.detach().numpy(), ref.numpy()) <= FWD_TOL


def test_three_chained_steps_match_jax():
    """build_stencil once, then 3 steps: the result and the gradients of
    offset, aff and the initial map, radius 6."""
    radius = 6

    def jfn(o, a, f):
        # a scan, as the JAX model runs its steps: XLA compiles 3 unrolled
        # steps and their gradient for minutes on the CPU
        m = jsp.build_stencil(o, a, radius)
        return jax.lax.scan(lambda f, _: (jsp.stencil_apply(m, f, radius), None), f, None,
                            length=3)[0]

    def pfn(o, a, f):
        m = psp.build_stencil(o, a, radius)
        for _ in range(3):
            f = psp.stencil_apply(m, f, radius)
        return f

    inp = _inputs(30, off_scale=3.0)
    inp["aff"] = (inp["aff"] / 9.0).astype(np.float32)  # keep the map O(1) over 3 steps
    _grad_check(jfn, pfn, inp)


def _saved_bytes(fn):
    """Bytes of the distinct storages autograd keeps while ``fn`` runs (a
    tensor saved by several ops, as M by every step, counts once)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def test_autograd_keeps_one_stencil():
    """A prop_time-step propagation at (1, 64, 96), radius 6, 18 steps: the
    saved bytes stay under 3 x M's bytes + 18 (1, 64, 96, 1) maps (a
    line-by-line port keeps over 27 x M: nine taps' (hy, hx, hy * hx) of
    M's size, and 256 shifted copies of the map per step); the gradients
    of every input are finite and non-zero."""
    radius, steps = 6, 18
    inp = _inputs(40, b=1, h=64, w=96)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in inp.items()}

    def prop():
        m = psp.build_stencil(t["offset"], t["aff"] / 9.0, radius)
        f = t["feat"]
        for _ in range(steps):
            f = psp.stencil_apply(m, f, radius)
        return f

    out, saved = _saved_bytes(prop)
    m_bytes = 64 * 96 * psp.window_size(radius) ** 2 * 4
    map_bytes = 64 * 96 * 4
    assert m_bytes <= saved < 3 * m_bytes + steps * map_bytes, (saved, m_bytes)
    out.sum().backward()
    assert all(bool(torch.isfinite(v.grad).all()) and v.grad.abs().sum() > 0 for v in t.values())
