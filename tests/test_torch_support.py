"""Shared set-up for the tests of the PyTorch port (no tests here).

Inputs and weights are made from a seed with numpy; the JAX model's
parameters reach the port through ``jax_to_state_dict``. Sizes are the
ROADMAP's parity sizes: 64x96 images, at most 4 DDIM steps, and per
backbone family (``FAMILIES``) its smallest model under its head:
``swin_micro`` under the flagship head, ``mmbev_res18`` under
``DDIMDepthEstimate_Res``, ``mpvit_tiny`` under
``DDIMDepthEstimate_MPVIT_ADDHAHI``.
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
# family -> (backbone_module, backbone_name, head, head_in_channels)
FAMILIES = {
    "swin": ("swin", "swin_micro", HEAD, MICRO_CHANNELS),
    "res18": ("mmbev_resnet", "mmbev_res18", "DDIMDepthEstimate_Res", None),
    "mpvit_tiny": ("mpvit", "mpvit_tiny", "DDIMDepthEstimate_MPVIT_ADDHAHI", (96, 176, 216, 216)),
}


def make_batch(seed=0, b=2, h=64, w=96):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * 8 + 1).astype(np.float32)
    gt[:, :4] = 0.0  # some invalid pixels, as in sparse KITTI ground truth
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "gt": gt}


def init_latent(seed, batch):
    b, h, w, _ = batch["gt"].shape
    return np.random.RandomState(seed).randn(b, h // 2, w // 2, 16).astype(np.float32)


def jax_model(steps=4, bf16=False, family="swin", head=None):
    """The JAX model of ``family``; ``head`` replaces the family's head."""
    module, name, fhead, channels = FAMILIES[family]
    return Diffusion_DCbase_Model(
        backbone_name=name, backbone_module=module, head_name=head or fhead,
        inference_steps=steps, head_in_channels=channels,
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


def module_variables(module, *args, seed=0, **kwargs):
    """Variables of a flax module (or model) applied to ``args`` (numpy
    arrays), drawn with numpy from ``seed``: the shapes come from
    ``jax.eval_shape`` of its init (no compile), each kernel or embedding
    ~ N(0, 1 / fan-in), norms, biases and running statistics as
    ``jax_variables`` randomizes them."""
    key = jax.random.PRNGKey(0)
    args, kwargs = jax.tree_util.tree_map(jnp.asarray, (args, kwargs))
    shapes = jax.eval_shape(lambda: module.init({"params": key, "diffusion": key},
                                                *args, **kwargs))
    rng = np.random.RandomState(seed + 100)

    def draw(tree, path=()):
        if hasattr(tree, "items"):
            return {k: draw(v, path + (k,)) for k, v in tree.items()}
        if path[-1] in ("kernel", "embedding", "relative_position_bias_table"):
            fan_in = int(np.prod(tree.shape[:-1])) if path[-1] == "kernel" else 1
            return (rng.randn(*tree.shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)
        return _randomize(np.zeros(tree.shape, np.float32), rng, path)

    return draw({k: v for k, v in shapes.items()})


def backbone_state_dict(variables):
    """A JAX backbone's variables -> the state dict of the port's backbone
    module (``jax_to_state_dict`` under ``depth_backbone.``, prefix cut)."""
    sd = jax_to_state_dict({"depth_backbone": variables["params"]},
                           {"depth_backbone": variables.get("batch_stats", {})})
    return {k[len("depth_backbone."):]: v for k, v in sd.items()}


class FixedLatent:
    """Hands the JAX step's ``model.apply`` a fixed starting latent."""

    def __init__(self, model, latent):
        self.model, self.latent = model, latent

    def apply(self, variables, batch, **kw):
        return self.model.apply(variables, batch, init_latent=self.latent, **kw)


class Draws:
    """Stands in for ``jax`` inside the JAX head: ``random.normal`` and
    ``random.randint`` return ``self.noise`` and ``self.timesteps``, read at
    the call (a traced function may set them to its arguments)."""

    def __init__(self, noise, timesteps):
        self.noise, self.timesteps = noise, timesteps
        rnd, draws = jax.random, self

        class _Random:
            def __getattr__(self, k):
                return getattr(rnd, k)

            @staticmethod
            def normal(key, shape, dtype=jnp.float32):
                return jnp.asarray(draws.noise, dtype).reshape(shape)

            @staticmethod
            def randint(key, shape, lo, hi):
                return jnp.asarray(draws.timesteps, jnp.int32).reshape(shape)

        self.random = _Random()

    def __getattr__(self, k):
        return getattr(jax, k)


def random_msda_kernels(tree, seed, offset_scale=3.0):
    """Random ``sampling_offsets`` and ``attention_weights`` kernels (the
    offsets ``offset_scale`` times N(0, 1 / fan-in)) in every MSDA of a
    parameter tree, in place."""
    rng = np.random.RandomState(seed)
    for key, v in tree.items():
        if key in ("sampling_offsets", "attention_weights"):
            k = v["kernel"]
            scale = offset_scale if key == "sampling_offsets" else 1.0
            v["kernel"] = (scale * rng.randn(*k.shape) / np.sqrt(k.shape[0])).astype(np.float32)
        elif isinstance(v, dict):
            random_msda_kernels(v, seed + 1, offset_scale)
    return tree


class DropoutMasks:
    """Dropout keep masks drawn in call order from one numpy seed: the
    same sequence of masks for flax's ``random.bernoulli`` and the port's
    ``keep_mask``."""

    def __init__(self, seed):
        self.jax_rng = np.random.RandomState(seed)
        self.port_rng = np.random.RandomState(seed)
        self.shapes = []
        masks = self

        class _Random:
            def __getattr__(self, k):
                return getattr(jax.random, k)

            @staticmethod
            def bernoulli(key, p, shape):
                return jnp.asarray(masks.jax_rng.rand(*shape) < p)

        self.random = _Random()

    def keep_mask(self, shape, rate, generator, device):
        self.shapes.append(tuple(shape))
        return torch.from_numpy(self.port_rng.rand(*shape) < 1.0 - rate)


def named(tree, batch_stats=None):
    """A JAX params (or gradient) tree under the port's parameter names."""
    return {k: v.numpy() for k, v in jax_to_state_dict(tree, batch_stats).items()}


def close_leaves(port_vals, jax_vals, tol):
    """Each leaf within ``tol`` of its largest value; a leaf whose values
    are below 1e-4 of the largest of all leaves (a gradient that vanishes
    analytically, as that of a bias followed by BatchNorm) is held to that
    floor instead: there both packages hold float noise."""
    floor = 1e-4 * max(np.abs(v).max() for v in jax_vals.values())
    for name, ref in jax_vals.items():
        err = np.abs(port_vals[name] - ref).max()
        scale = max(np.abs(ref).max(), floor)
        assert err <= tol * scale, (name, err, scale)


def port_config(steps=4, opt_level="O0", family="swin", head=None):
    module, name, fhead, channels = FAMILIES[family]
    return Config(model_name="Diffusion_DCbase_", backbone_module=module,
                  backbone_name=name, head_specify=head or fhead,
                  inference_steps=steps, opt_level=opt_level,
                  head_in_channels=channels and ",".join(map(str, channels))).finalize()


def port_model(variables, steps=4, opt_level="O0", family="swin", head=None):
    model = build_model(port_config(steps, opt_level, family, head), device="cpu")
    sd = jax_to_state_dict(variables["params"], variables.get("batch_stats"))
    model.load_state_dict(sd, strict=True)
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
