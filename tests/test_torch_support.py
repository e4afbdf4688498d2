"""Shared set-up for the tests of the PyTorch port (no tests here).

Inputs and weights are made from a seed with numpy; the JAX model's
parameters reach the port through ``jax_to_state_dict``. Sizes are the
ROADMAP's parity sizes: ``swin_micro`` under the flagship head, 64x96
images, at most 4 DDIM steps.
"""

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.diffusion_model import Diffusion_DCbase_Model  # noqa: E402
from diffusiondepth_tpu_torch import Config, build_model  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

HEAD = "DDIMDepthEstimate_Swin_ADDHAHI"
MICRO_CHANNELS = (32, 64, 128, 256)


def make_batch(seed=0, b=2, h=64, w=96):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * 8 + 1).astype(np.float32)
    gt[:, :4] = 0.0  # some invalid pixels, as in sparse KITTI ground truth
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "gt": gt}


def init_latent(seed, batch):
    b, h, w, _ = batch["gt"].shape
    return np.random.RandomState(seed).randn(b, h // 2, w // 2, 16).astype(np.float32)


def jax_model(steps=4, bf16=False):
    return Diffusion_DCbase_Model(
        backbone_name="swin_micro", backbone_module="swin", head_name=HEAD,
        inference_steps=steps, head_in_channels=MICRO_CHANNELS,
        dtype=jnp.bfloat16 if bf16 else None)


def _randomize(tree, rng, path=()):
    """Non-trivial values for the leaves flax initialises to constants."""
    if isinstance(tree, dict):
        return {k: _randomize(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    name = path[-1]
    if name == "var":
        return (1.0 + 0.3 * rng.rand(*a.shape)).astype(np.float32)
    if name in ("mean", "bias"):
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
    return a


def jax_variables(model, batch, seed=0):
    """Flax init of ``model`` with randomized norms, biases and running
    statistics, as nested dicts of numpy arrays."""
    key = jax.random.PRNGKey(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda key, jb, lat: model.init({"params": key, "diffusion": key}, jb,
                                                   train=False, init_latent=lat))
    vs = init(key, jb, jnp.asarray(init_latent(0, batch)))
    rng = np.random.RandomState(seed + 100)
    to_np = jax.tree_util.tree_map(np.asarray, {k: dict(v) for k, v in vs.items()})
    return {k: _randomize(v, rng) for k, v in to_np.items()}


def port_config(steps=4, opt_level="O0"):
    return Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                  backbone_name="swin_micro", head_specify=HEAD,
                  inference_steps=steps, opt_level=opt_level,
                  head_in_channels=",".join(map(str, MICRO_CHANNELS))).finalize()


def port_model(variables, steps=4, opt_level="O0"):
    model = build_model(port_config(steps, opt_level), device="cpu")
    sd = jax_to_state_dict(variables["params"], variables.get("batch_stats"))
    model.load_state_dict(sd, strict=True)
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
