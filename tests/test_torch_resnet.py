"""The port's mmbev ResNet and CBAM against the JAX modules on the CPU:
the pyramid of each block type in f32 and bf16, training-mode BatchNorm
and its running statistics, and CBAMWithPosEmbed alone."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.backbones import mmbev_resnet as jres  # noqa: E402
from diffusiondepth_tpu.ops import cbam as jcbam  # noqa: E402
from diffusiondepth_tpu_torch.models.backbones import mmbev_resnet as pres  # noqa: E402
from diffusiondepth_tpu_torch.ops import cbam as pcbam  # noqa: E402

from test_torch_support import backbone_state_dict, module_variables, rel_err  # noqa: E402

torch.set_num_threads(1)

BLOCKS = ["Basic", "BasicBlockWithCBAM", "BottleNeck"]


def _pair(block_type, bf16=False, seed=0):
    """The JAX res18 layout with ``block_type`` blocks, its randomized
    variables, and the port's module with the same weights; a 64x96 batch
    of 2."""
    x = np.random.RandomState(seed).randn(2, 64, 96, 3).astype(np.float32)
    dtype = jnp.bfloat16 if bf16 else None
    jm = jres.ResNetForMMBEV(num_layer=(2, 2, 2, 2), block_type=block_type, dtype=dtype)
    variables = module_variables(jm, x, seed=seed, train=False)
    pm = pres.ResNetForMMBEV(num_layer=(2, 2, 2, 2), block_type=block_type,
                             dtype=torch.bfloat16 if bf16 else None)
    pm.load_state_dict(backbone_state_dict(variables), strict=True)
    return x, jm, variables, pm.eval()


@pytest.mark.parametrize("block_type", BLOCKS)
def test_pyramid_matches_jax_f32(block_type):
    """The four levels (H/2 .. H/16; 64, 128, 256, 512 channels) equal the
    JAX module's in eval mode, f32, to 1e-4 of each level's largest value
    (summation order in the convolutions)."""
    x, jm, variables, pm = _pair(block_type)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [(2, 32, 48, 64), (2, 16, 24, 128),
                                              (2, 8, 12, 256), (2, 4, 6, 512)]
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b) <= 1e-4


@pytest.mark.parametrize("block_type", ["Basic", "BasicBlockWithCBAM"])
def test_pyramid_matches_jax_bf16(block_type):
    """Under the bf16 policy each level is bf16 and within 2e-2 of the JAX
    level's largest value (8-bit rounding at other points)."""
    x, jm, variables, pm = _pair(block_type, bf16=True, seed=1)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for a, b in zip(out, ref):
        assert a.dtype == torch.bfloat16
        assert rel_err(a.float().numpy(), np.asarray(b, np.float32)) < 2e-2


# In training mode CBAM's second BatchNorm normalises a (B, 1, 1, C) map
# (the channel gate), which varies little across the batch: flax's
# variance E[x^2] - E[x]^2 cancels there, amplifying f32 rounding (6e-8)
# by E[x^2] / (var + eps), up to ~1e4, in either package, and the effect
# compounds over the blocks of a whole CBAM ResNet. So CBAM in training is
# held to 5e-3, on the module alone.
CBAM_TRAIN_TOL = 5e-3


@pytest.mark.parametrize("block_type", ["Basic", "BottleNeck"])
def test_training_mode_matches_jax(block_type):
    """In training mode the pyramid (batch statistics) and every updated
    running statistic match flax's ``train=True`` apply: outputs to 1e-4
    of each level's largest value, statistics to 1e-5 of each one's."""
    x, jm, variables, pm = _pair(block_type, seed=2)
    ref, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    pm.train()
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    for a, b in zip(out, ref):
        assert rel_err(a.numpy(), b) <= 1e-4
    want = backbone_state_dict({"params": variables["params"],
                                "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                      mut["batch_stats"])})
    stats = {k: v for k, v in pm.state_dict().items() if k.endswith(("running_mean",
                                                                      "running_var"))}
    assert stats and set(stats) <= set(want)
    for k, v in stats.items():
        assert rel_err(v.numpy(), want[k].numpy()) <= 1e-5, k


@pytest.mark.parametrize("train", [False, True])
def test_cbam_with_pos_embed_matches_jax(train):
    """CBAMWithPosEmbed alone on a (2, 8, 12, 32) map, eval and training
    BatchNorm: the output within 1e-5 of its largest value in eval,
    ``CBAM_TRAIN_TOL`` in training; the updated running statistics within
    1e-5 of each one's largest value."""
    x = np.random.RandomState(3).randn(2, 8, 12, 32).astype(np.float32)
    jm = jcbam.CBAMWithPosEmbed(pos_embed_planes=16)
    variables = module_variables(jm, x, seed=3, train=False)
    pm = pcbam.CBAMWithPosEmbed(32, 16)
    sd = backbone_state_dict({"params": {"layer0_block0": {"CBAMWithPosEmbed_0":
                                                           variables["params"]}},
                              "batch_stats": {"layer0_block0": {"CBAMWithPosEmbed_0":
                                                                variables["batch_stats"]}}})
    pm.load_state_dict({k[len("layers.0.0.cbam."):]: v for k, v in sd.items()}, strict=True)
    pm.train(train)
    ref, mut = jm.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    assert rel_err(out.numpy(), ref) <= (CBAM_TRAIN_TOL if train else 1e-5)
    want = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    for bn, key in ((pm.dim_reduce[1], "BatchNorm_0"), (pm.dim_expand[1], "BatchNorm_1")):
        for buf, leaf in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            assert rel_err(buf.numpy(), want[key]["BatchNorm_0"][leaf]) <= 1e-5
