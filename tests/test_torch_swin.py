"""The port's Swin backbone against the flax ``swin_micro`` on the CPU, f32."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu_torch.models.backbones import swin as pswin  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

torch.set_num_threads(1)


def _randomize(tree, rng):
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(64, 96), (62, 90)])
def test_pyramid_matches_flax(h, w):
    """The four pyramid levels of the port's swin_micro == flax swin_micro
    with the same weights (lifted through jax_to_state_dict), f32 to 1e-4
    of each level's largest value (summation order in the products and the
    LayerNorms). 62x90 is not a patch multiple: it exercises the patch-embed
    padding, the window padding after norm1 and the odd-size PatchMerging
    pad."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    model = jswin.swin_micro()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomize(jax.tree_util.tree_map(np.asarray, dict(params)), rng)
    ref = model.apply({"params": params}, jnp.asarray(x))

    port = pswin.swin_micro().eval()  # flax apply without train: no drop-path
    sd = jax_to_state_dict({"depth_backbone": params})
    port.load_state_dict({k[len("depth_backbone."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("h_pad,w_pad,shift", [(14, 21, 3), (21, 28, 3), (7, 7, 3)])
def test_window_constants_match(h_pad, w_pad, shift):
    """Relative-position index and shifted-window mask: identical arrays."""
    np.testing.assert_array_equal(pswin.relative_position_index(7, 7),
                                  jswin.relative_position_index(7, 7))
    np.testing.assert_array_equal(pswin.shifted_window_mask(h_pad, w_pad, 7, shift),
                                  jswin.shifted_window_mask(h_pad, w_pad, 7, shift))


def test_window_partition_roundtrip_matches():
    """window_partition / window_reverse are the JAX reshapes exactly."""
    x = np.random.RandomState(1).randn(2, 14, 21, 5).astype(np.float32)
    pw = pswin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(pswin.window_reverse(pw, 7, 14, 21).numpy(), x)
