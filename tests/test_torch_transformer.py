"""The port's Deformable-DETR encoder and pixel-query decoder against the
JAX package's (``models/necks/transformer.py``), in f32 on the CPU at micro
size: ``inverse_sigmoid``, ``PureMSDEnTransformer`` (eval, and training
with the same dropout keep masks) and ``PixelTransformerDecoder`` with and
without the classification query."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax.linen import stochastic  # noqa: E402

from diffusiondepth_tpu.models.necks import transformer as jtr  # noqa: E402
from diffusiondepth_tpu_torch.models.necks import transformer as ptr  # noqa: E402
from diffusiondepth_tpu_torch.ops import msda as pmsda  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import (  # noqa: E402
    DropoutMasks, module_variables, random_msda_kernels, rel_err,
)

torch.set_num_threads(1)


def test_inverse_sigmoid_matches_jax():
    x = np.array([-0.5, 0.0, 1e-7, 0.1, 0.5, 0.9, 1.0 - 1e-7, 1.0, 1.5], np.float32)
    ours = ptr.inverse_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jtr.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(1 / (1 + np.exp(-ours[3:6])), x[3:6], rtol=1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pure_msde_transformer_matches_jax(monkeypatch, train):
    """Two encoder layers over three levels: every level's memory within
    1e-4 of its largest value; in training mode each layer's MSDA drops
    under the same keep masks in both."""
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 8 // 2 ** i, 12 // 2 ** i, 64).astype(np.float32) for i in range(3)]
    jm = jtr.PureMSDEnTransformer(num_layers=2, embed_dims=64, num_heads=4, pe_num_feats=32)
    variables = module_variables(jm, feats, seed=1)
    random_msda_kernels(variables["params"], 2)
    variables["params"]["level_embeds"] = rng.randn(3, 64).astype(np.float32)
    masks = DropoutMasks(3)
    monkeypatch.setattr(stochastic, "random", masks.random)
    monkeypatch.setattr(pmsda, "keep_mask", masks.keep_mask)
    jouts = jax.jit(lambda v, f: jm.apply(v, f, train=train,
                                          rngs={"dropout": jax.random.PRNGKey(0)}))(
        variables, [jnp.asarray(f) for f in feats])

    m = ptr.PureMSDEnTransformer(num_layers=2, embed_dims=64, num_heads=4, pe_num_feats=32,
                                 num_levels=3)
    m.load_state_dict(jax_to_state_dict(variables["params"]), strict=True)
    m.train(train)
    with torch.no_grad():
        outs = m([torch.from_numpy(f) for f in feats], generator=torch.Generator())
    assert len(masks.shapes) == (2 if train else 0)
    for a, b in zip(outs, jouts):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), np.asarray(b)) < 1e-4


@pytest.mark.parametrize("classify", [True, False])
def test_pixel_transformer_decoder_matches_jax(classify):
    """Three layers round-robin over two memories: bins, the
    range-attention maps and (with ``classify``) the class logits, each
    within 1e-4 of its largest value."""
    rng = np.random.RandomState(4)
    ms_feats = [rng.randn(2, 4 // 2 ** i, 6 // 2 ** i, 32).astype(np.float32) for i in range(2)]
    mask_features = rng.randn(2, 16, 24, 32).astype(np.float32)
    kw = dict(hidden_dim=32, num_layers=3, num_feature_levels=2, num_queries=16, num_heads=4,
              classify=classify, class_num=10, pe_num_feats=16)
    jm = jtr.PixelTransformerDecoder(**kw)
    variables = module_variables(jm, ms_feats, mask_features, seed=5)
    nq = 16 + int(classify)
    for k in ("query_embed", "query_pos"):
        variables["params"][k] = rng.randn(nq, 32).astype(np.float32)
    jbins, jmaps, jcls = jax.jit(jm.apply)(variables, [jnp.asarray(f) for f in ms_feats],
                                            jnp.asarray(mask_features))

    m = ptr.PixelTransformerDecoder(**kw)
    m.load_state_dict(jax_to_state_dict(variables["params"]), strict=True)
    with torch.no_grad():
        bins, maps, cls = m.eval()([torch.from_numpy(f) for f in ms_feats],
                                   torch.from_numpy(mask_features))
    assert bins.shape == (2, 16) and maps.shape == (2, 16, 24, 16)
    assert rel_err(bins.numpy(), np.asarray(jbins)) < 1e-4
    assert rel_err(maps.numpy(), np.asarray(jmaps)) < 1e-4
    if classify:
        assert cls.shape == (2, 10) and rel_err(cls.numpy(), np.asarray(jcls)) < 1e-4
    else:
        assert cls is None and jcls is None
