"""Weight bridge round trip: port state dict -> JAX trees through the JAX
package's converter -> back through ``jax_to_state_dict``, exactly."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from diffusiondepth_tpu.utils.convert_torch_checkpoint import (  # noqa: E402
    convert_reference_model, merge_params,
)
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import jax_model, jax_variables, make_batch, port_config  # noqa: E402
from diffusiondepth_tpu_torch import build_model  # noqa: E402

torch.set_num_threads(1)


def _port_state_dict(seed=0):
    """A port model (swin_micro + the flagship head) with every tensor
    random, BatchNorm running statistics included."""
    model = build_model(port_config(steps=1), device="cpu")
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        sd[k] = (r.abs() + 0.5) if k.endswith("running_var") else r
    model.load_state_dict(sd, strict=True)
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_state_dict_round_trip_is_exact():
    """convert_reference_model + merge_params over the JAX model's own init
    trees, then jax_to_state_dict: the same key set and every tensor equal
    bit for bit (the maps are transposes only)."""
    sd = _port_state_dict()
    params, stats = convert_reference_model(sd, swin_depths=(1, 2, 1, 1))

    variables = jax_variables(jax_model(steps=1), make_batch(0, b=1, h=32, w=48))
    merged_p = merge_params(variables["params"], params)
    merged_s = merge_params(variables["batch_stats"], stats)
    back = jax_to_state_dict(merged_p, merged_s)

    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_every_jax_leaf_reaches_the_port():
    """Every leaf of the JAX model's params and batch_stats is used: the
    port's state dict has exactly as many values as the JAX trees."""
    variables = jax_variables(jax_model(steps=1), make_batch(0, b=1, h=32, w=48))
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
    sd = jax_to_state_dict(variables["params"], variables["batch_stats"])
    assert sum(v.numel() for v in sd.values()) == n_jax
