"""The port's multi-scale deformable attention against the JAX package's
(``ops/msda.py``), in f32 on the CPU: the core, the mmcv layer at 3 of its
4 level slots (self- and cross-attention), its gradient, its dropout under
one keep mask, the sine positional encoding and the grid reference points.

The layer's ``sampling_offsets`` and ``attention_weights`` kernels start at
zero; here they are drawn at random, the offsets scaled so that some
sampling points fall outside the maps (else only the bias path is held)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax.linen import stochastic  # noqa: E402

from diffusiondepth_tpu.models.necks import hahi as jhahi  # noqa: E402
from diffusiondepth_tpu.models.necks import positional_encoding as jpe  # noqa: E402
from diffusiondepth_tpu.ops import msda as jmsda  # noqa: E402
from diffusiondepth_tpu_torch.models.necks import hahi as phahi  # noqa: E402
from diffusiondepth_tpu_torch.models.necks import positional_encoding as ppe  # noqa: E402
from diffusiondepth_tpu_torch.ops import msda as pmsda  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

torch.set_num_threads(1)

SHAPES = ((6, 8), (3, 4), (2, 3))  # the run's 3 levels of the layer's 4 slots
C, HEADS, P, SLOTS = 32, 4, 2, 4
NV = sum(h * w for h, w in SHAPES)


def _close(port, ref, tol):
    """Within ``tol`` of the reference's largest value."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert np.abs(port - ref).max() <= tol * np.abs(ref).max(), np.abs(port - ref).max()


def _params(seed, off_scale=3.0):
    """The layer's JAX parameters with random kernels; the offsets keep
    mmcv's rotating-grid bias."""
    rng = np.random.RandomState(seed)
    n = HEADS * SLOTS * P

    def dense(cin, cout, scale=1.0):
        return {"kernel": (scale * rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32),
                "bias": (0.1 * rng.randn(cout)).astype(np.float32)}

    p = {"value_proj": dense(C, C), "sampling_offsets": dense(C, 2 * n, off_scale),
         "attention_weights": dense(C, n), "output_proj": dense(C, C)}
    p["sampling_offsets"]["bias"] = np.asarray(
        jmsda._msda_offset_bias_init(HEADS, SLOTS, P)(None, (2 * n,)))
    return p


def _inputs(seed, nq, cross):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    q = rng.randn(2, nq, C).astype(f32)
    value = rng.randn(2, NV, C).astype(f32) if cross else None
    pos = rng.randn(2, nq, C).astype(f32)
    ref = rng.rand(2, nq, len(SHAPES), 2).astype(f32)
    return q, value, pos, ref


def _jax_layer(dropout=0.1):
    return jmsda.MultiScaleDeformableAttention(embed_dims=C, num_heads=HEADS, num_levels=SLOTS,
                                               num_points=P, dropout=dropout)


def _port_layer(params):
    m = pmsda.MultiScaleDeformableAttention(C, HEADS, SLOTS, P)
    m.load_state_dict(jax_to_state_dict(params), strict=True)
    return m


def _t(a):
    return None if a is None else torch.from_numpy(a)


def test_offset_bias_matches_jax():
    n = 2 * HEADS * SLOTS * P
    ours = pmsda._msda_offset_bias_init(HEADS, SLOTS, P)
    theirs = np.asarray(jmsda._msda_offset_bias_init(HEADS, SLOTS, P)(None, (n,)))
    assert np.array_equal(ours, theirs)
    m = pmsda.MultiScaleDeformableAttention(C, HEADS, SLOTS, P)
    assert np.array_equal(m.sampling_offsets.bias.detach().numpy(), ours)
    assert not m.sampling_offsets.weight.any() and not m.attention_weights.weight.any()


def test_ms_deform_attn_matches_jax():
    """The core at 3 levels with locations in [-0.1, 1.1] (some corners
    outside every map) and weights not normalised (1e-4 relative, 1e-5
    absolute: f32 sums in another order)."""
    rng = np.random.RandomState(1)
    b, nq = 2, 10
    value = rng.randn(b, NV, HEADS, C // HEADS).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (b, nq, HEADS, len(SHAPES), P, 2)).astype(np.float32)
    w = rng.rand(b, nq, HEADS, len(SHAPES), P).astype(np.float32)
    ref = jax.jit(jmsda.ms_deform_attn, static_argnums=1)(jnp.asarray(value), SHAPES,
                                                          jnp.asarray(loc), jnp.asarray(w))
    ours = pmsda.ms_deform_attn(_t(value), SHAPES, _t(loc), _t(w))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_msda_layer_matches_jax(cross):
    """The layer in eval mode, self-attention (value = query) and
    cross-attention (a value sequence, the identity the un-positioned
    query), with some sampling points outside the maps."""
    params = _params(2)
    nq = 12 if cross else NV  # self-attention: the query is the value
    q, value, pos, ref = _inputs(3, nq, cross)
    # where the offsets send the points: some leave [0, 1]
    off = ((q + pos) @ params["sampling_offsets"]["kernel"] + params["sampling_offsets"]["bias"])
    off = off.reshape(2, nq, HEADS, SLOTS, P, 2)[:, :, :, :len(SHAPES)]
    loc = ref[:, :, None, :, None, :] + off / np.array([[w, h] for h, w in SHAPES])[:, None]
    outside = ((loc < 0) | (loc > 1)).mean()
    assert 0.05 < outside < 0.95, outside

    layer = _jax_layer()
    fn = jax.jit(lambda p, q, v, pos, r: layer.apply({"params": p}, q, v, pos, r, SHAPES))
    jout = fn(params, q, value, pos, ref)
    with torch.no_grad():
        out = _port_layer(params).eval()(_t(q), _t(value), _t(pos), _t(ref), SHAPES)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)


def test_msda_gradient_matches_jax():
    """d(sum(out * ct)) by the query, the value and every parameter
    against ``jax.grad`` (1e-3 of each leaf's largest value)."""
    params = _params(4)
    q, value, pos, ref = _inputs(5, 12, cross=True)
    ct = np.random.RandomState(6).randn(2, 12, C).astype(np.float32)
    layer = _jax_layer()

    def loss(p, q, v):
        return jnp.sum(layer.apply({"params": p}, q, v, pos, ref, SHAPES) * ct)

    jg_p, jg_q, jg_v = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, q, value)

    m = _port_layer(params).eval()
    tq, tv = _t(q).requires_grad_(), _t(value).requires_grad_()
    (m(tq, tv, _t(pos), _t(ref), SHAPES) * _t(ct)).sum().backward()
    _close(tq.grad.numpy(), jg_q, 1e-3)
    _close(tv.grad.numpy(), jg_v, 1e-3)
    jg = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jg_p))
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), jg[name].numpy(), 1e-3)


def test_msda_dropout_matches_jax(monkeypatch):
    """In training mode both packages apply dropout (rate 0.1) to the
    output projection's result; handed one keep mask they agree."""
    params = _params(7)
    q, value, pos, ref = _inputs(8, 12, cross=True)
    keep = np.random.RandomState(9).rand(2, 12, C) < 0.9
    assert not keep.all()

    class _Random:  # stands in for jax.random inside flax's Dropout
        def __getattr__(self, k):
            return getattr(jax.random, k)

        @staticmethod
        def bernoulli(key, p, shape):
            assert tuple(shape) == keep.shape and abs(p - 0.9) < 1e-9
            return jnp.asarray(keep)

    monkeypatch.setattr(stochastic, "random", _Random())
    layer = _jax_layer()
    jout = jax.jit(lambda p: layer.apply({"params": p}, q, value, pos, ref, SHAPES, train=True,
                                         rngs={"dropout": jax.random.PRNGKey(0)}))(params)

    drawn = []

    def mask(shape, rate, generator, device):
        drawn.append((tuple(shape), rate, generator))
        return torch.from_numpy(keep)

    monkeypatch.setattr(pmsda, "keep_mask", mask)
    gen = torch.Generator().manual_seed(0)
    m = _port_layer(params).train()
    with torch.no_grad():
        out = m(_t(q), _t(value), _t(pos), _t(ref), SHAPES, generator=gen)
    assert drawn == [((2, 12, C), 0.1, gen)]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    # and the default mask: drawn from the generator, about 10% dropped
    monkeypatch.undo()
    kept = pmsda.keep_mask((64, 64), 0.1, torch.Generator().manual_seed(1), torch.device("cpu"))
    assert kept.dtype == torch.bool and 0.85 < kept.float().mean().item() < 0.95
    assert torch.equal(kept, pmsda.keep_mask((64, 64), 0.1, torch.Generator().manual_seed(1),
                                             torch.device("cpu")))


@pytest.mark.parametrize("h,w,nf", [(5, 7, 8), (11, 38, 256), (88, 304, 256)])
def test_sine_positional_encoding_bit_equal(h, w, nf):
    """The table bit for bit, and as the model gets it: cast like
    ``jnp.asarray(pe, dtype)``, made once per (h, w, device, dtype)."""
    ours = ppe.sine_positional_encoding(h, w, nf)
    assert np.array_equal(ours, jpe.sine_positional_encoding(h, w, nf))
    pe = ppe.SinePositionalEncoding(nf)
    cpu = torch.device("cpu")
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        t = pe.table(h, w, cpu, dt)
        assert t.shape == (1, h * w, 2 * nf) and t.dtype == dt
        ref = np.asarray(jnp.asarray(ours.reshape(1, h * w, -1), jdt).astype(jnp.float32))
        assert np.array_equal(t.float().numpy(), ref)
        assert pe.table(h, w, cpu, dt) is t
    assert pe.table(h, w, cpu, torch.bfloat16) is not pe.table(h, w, cpu, torch.float32)


def test_grid_reference_points_match_jax():
    shapes = ((44, 152), (22, 76), (11, 38))
    ours = phahi._grid_reference_points(shapes)
    assert ours.shape == (44 * 152 + 22 * 76 + 11 * 38, 2)
    assert np.array_equal(ours, jhahi._grid_reference_points(shapes))
