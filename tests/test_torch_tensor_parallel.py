"""The port's tensor-parallel layout in one process, against JAX's, with
no compile: exact comparisons throughout (index arithmetic and copies).

* ``state_sharding`` splits exactly the tensors that JAX's splits, on the
  dim that JAX's last axis lands on, for four families (``swin_micro``
  under the flagship head, ``mmbev_res18`` + ``DDIMDepthEstimate_Res``,
  ``mpvit_tiny`` + ``DDIMDepthEstimate_MPVIT_ADDHAHI`` and NLSPN), at
  ``min_size`` 2**12 and 2**16, over 'model' axes of 2 and 4. JAX's rule
  runs on ``jax.eval_shape`` shapes over a mesh of the conftest's virtual
  devices; each leaf JAX cuts becomes an array holding its last-axis
  index (zeros where it is replicated), which ``jax_to_state_dict``
  carries to the port's layout: the port cuts the same tensors, on the
  one dim along which that index varies. Which elements each rank owns
  is the port's own choice (contiguous chunks along that dim).
* The ranks' mesh coordinates are where JAX's ``create_mesh`` places the
  devices, and the ranks of a model group take the same rows and draws.
* Cutting a tensor into its shards and joining them gives it back, bit
  for bit (also for flax's (C, heads, head_dim) attention kernels, whose
  chunks hold whole heads).
* Swin's attention and projection dropouts: rate 0 leaves the training
  forward and the generator as they were; at p > 0 the block is the einsum
  path with the drawn masks applied and scaled by 1 / (1 - p). JAX's
  dropout bits come from its key splits and are not matched.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.models.nlspn import NLSPNModel as JNLSPN  # noqa: E402
from diffusiondepth_tpu.parallel import mesh as jmesh  # noqa: E402
from diffusiondepth_tpu_torch import Config, build_model  # noqa: E402
from diffusiondepth_tpu_torch.models.backbones.swin import (  # noqa: E402
    SwinBlock, SwinTransformer, relative_position_index, window_partition, window_reverse,
)
from diffusiondepth_tpu_torch.models.necks.transformer import PixelTransformerDecoder  # noqa: E402
from diffusiondepth_tpu_torch.parallel import (  # noqa: E402
    Mesh, activate, shard_batch, state_sharding,
)
from diffusiondepth_tpu_torch.parallel.mesh import draw_rows  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import jax_model, make_batch, port_config  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
NLSPN_FLAGS = dict(model_name="NLSPN", network="resnet18", prop_time=3, prop_kernel=3,
                   affinity="TGASS", conf_prop=True, prop_stencil_radius=6)
FAMILIES = ("swin", "res18", "mpvit_tiny", "nlspn")


@functools.lru_cache(maxsize=None)
def _models(family):
    """(JAX parameter shapes, the port's model) of a family."""
    batch = make_batch(b=2, h=32, w=48)
    if family == "nlspn":
        batch["dep"] = batch["gt"]
        jm = JNLSPN(args=jconfig.Config(**NLSPN_FLAGS).finalize())
        cfg = Config(**NLSPN_FLAGS).finalize()
    else:
        jm = jax_model(steps=2, family=family)
        cfg = port_config(2, family=family)
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "diffusion": key}, jb, train=False))
    return shapes["params"], build_model(cfg, device="cpu")


def _jax_cut(shapes, k, min_size):
    """JAX's rule over a data:2 x model:k mesh: each leaf cut over 'model'
    as the index along its last axis (+1), the others as zeros."""
    mesh = jmesh.create_mesh(f"data:2,model:{k}", jax.devices()[:2 * k])
    specs = jmesh.state_sharding(shapes, mesh, min_size=min_size)

    def marker(shape, sh):
        if sh.spec and sh.spec[-1] == "model":
            last = np.arange(shape.shape[-1]) + 1
            return np.broadcast_to(last, shape.shape).astype(np.float32)
        return np.zeros(shape.shape, np.float32)

    return jax.tree_util.tree_map(marker, shapes, specs)


def _varying_dims(t):
    return [d for d in range(t.ndim) if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("min_size", [2**12, 2**16])
@pytest.mark.parametrize("family", FAMILIES)
def test_state_sharding_matches_jax(family, min_size, k):
    """The port cuts exactly the tensors JAX cuts, on the torch dim that
    JAX's last axis lands on under ``jax_to_state_dict`` (for flax's
    attention kernels the head dims: the port's chunks hold whole heads)."""
    shapes, model = _models(family)
    ref = jax_to_state_dict(_jax_cut(shapes, k, min_size))
    mesh = Mesh({"data": 2, "model": k}, 0, 2 * k, 0, 2 * k, CPU)
    sharding = state_sharding(model, mesh, min_size)
    assert sharding.specs.keys() == ref.keys()
    for name, marker in ref.items():
        spec = sharding.specs[name]
        assert (spec is not None) == bool(marker.any()), name
        if spec is not None:
            assert _varying_dims(marker) == [spec.dim], name
            assert marker.shape[spec.dim] % k == 0, name
    assert sharding.sharded  # some tensor is cut at every size here
    whole = sum(p.numel() for p in model.parameters())
    cut = sum(p.numel() for n, p in model.named_parameters() if n in sharding.sharded)
    assert sharding.local_numel(model) == whole - cut + cut // k


@pytest.mark.parametrize("spec", ["data:2,model:2", "model:2,data:2", "model:4"])
def test_mesh_coordinates_match_jax(spec):
    """Rank r sits where JAX's create_mesh puts device r; the data and
    model groups are the ranks along those axes of JAX's device array."""
    axes = jmesh.parse_mesh_shape(spec, int(np.prod([int(a.split(":")[1])
                                                     for a in spec.split(",")])))
    n = int(np.prod(list(axes.values())))
    jm = jmesh.create_mesh(spec, jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    base = jax.devices()[0].id
    for r in range(n):
        mesh = Mesh(axes, r, n, r, n, CPU)
        where = tuple(int(c[0]) for c in np.nonzero(ids == base + r))
        names = list(jm.axis_names)
        for axis in ("data", "model"):
            assert mesh.coord(axis) == (where[names.index(axis)] if axis in names else 0)
        for axis, ranks in (("data", mesh.data_ranks()), ("model", mesh.model_ranks())):
            if axis not in names:
                assert ranks == [r]
                continue
            sel = list(where)
            sel[names.index(axis)] = slice(None)
            assert ranks == [int(i) - base for i in ids[tuple(sel)]]


def test_model_ranks_take_the_same_rows_and_draws():
    """data:2,model:2: the two ranks of a model group get the same rows of
    a batch and the same draws; the data ranks' rows make the global ones."""
    axes = {"data": 2, "model": 2}
    batch = {"x": np.arange(8)[:, None]}
    rows, draws = {}, {}
    for r in range(4):
        mesh = Mesh(axes, r, 4, r, 4, CPU)
        rows[r] = shard_batch(batch, mesh, accum_steps=2)["x"][:, 0].tolist()
        g = torch.Generator().manual_seed(3)
        with activate(mesh):
            draws[r] = draw_rows(torch.randn, (2, 5), generator=g)
    full = torch.randn((4, 5), generator=torch.Generator().manual_seed(3))
    assert rows[0] == rows[1] == [0, 1, 4, 5] and rows[2] == rows[3] == [2, 3, 6, 7]
    assert torch.equal(draws[0], draws[1]) and torch.equal(draws[2], draws[3])
    assert torch.equal(torch.cat([draws[0], draws[2]]), full)


@pytest.mark.parametrize("k", [2, 4])
def test_shard_then_gather_is_the_identity(k):
    """Each sharded tensor of swin_micro's model and of a pixel decoder
    (flax's attention kernels) cut into its k shards and joined gives the
    whole tensor back, bit for bit."""
    decoder = PixelTransformerDecoder(hidden_dim=128, num_layers=1, num_heads=4, num_queries=16)
    mesh = Mesh({"model": k}, 0, k, 0, k, CPU)
    n_heads = 0
    for model in (_models("swin")[1], decoder):
        sharding = state_sharding(model, mesh, 2**12)
        for name, p in model.named_parameters():
            spec = sharding.specs[name]
            if spec is None:
                continue
            parts = [spec.shard(p.detach(), j) for j in range(k)]
            assert all(q.shape[spec.dim] == p.shape[spec.dim] // k for q in parts)
            assert torch.equal(torch.cat(parts, spec.dim), p.detach()), name
            n_heads += len(spec.jax_shape) == 3 and name.endswith("weight")
    assert n_heads == 3 * 2  # query, key, value of both attentions of the one layer


def _dropout_block(attn_p, drop_p):
    torch.manual_seed(0)
    blk = SwinBlock(32, 2, 128, window_size=4, shift=True, drop_rate=drop_p,
                    attn_drop_rate=attn_p)
    blk.train()
    return blk


def test_swin_dropout_at_rate_zero_is_the_identity():
    """Rates 0 draw nothing: the training forward (drop-path on) and the
    generator's state are those of a Swin built without the rates."""
    x = torch.randn(2, 24, 40, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for kw in ({}, {"drop_rate": 0.0, "attn_drop_rate": 0.0}):
        torch.manual_seed(0)
        m = SwinTransformer(embed_dims=32, depths=(1, 2, 1, 1), num_heads=(1, 2, 4, 8),
                            drop_path_rate=0.3, remat=False, **kw).train()
        g = torch.Generator().manual_seed(7)
        outs.append((m(x, generator=g), torch.rand(3, generator=g)))
    assert all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])


def test_swin_dropout_is_the_einsum_path_with_the_drawn_masks():
    """A shifted block in training at attn_drop_rate = drop_rate = p: its
    output is the einsum attention with the attention mask applied to the
    probabilities and the projection and both FFN masks to their outputs,
    each kept element scaled by 1 / (1 - p); the fused route warns and
    steps aside."""
    p = 0.3
    blk = _dropout_block(p, p)
    x = torch.randn(2, 8, 12, 32, generator=torch.Generator().manual_seed(2))
    drops = blk.draw_dropout(x, torch.Generator().manual_seed(5))
    assert drops["attn"].shape == (2, 6, 2, 16, 16) and drops["ffn1"].shape == (2, 8, 12, 128)
    with pytest.warns(UserWarning, match="einsum attention path"):
        got = blk(x, None, drops)

    def drop(t, keep):
        return torch.where(keep, t / (1 - p), torch.zeros_like(t))

    msa = blk.attn.w_msa
    y = F.layer_norm(x, (32,), blk.norm1.weight, blk.norm1.bias, 1e-5)
    y = torch.roll(y, (-2, -2), dims=(1, 2))
    w = window_partition(y, 4)
    q, k, v = F.linear(w, msa.qkv.weight, msa.qkv.bias).reshape(2, 6, 16, 3, 2, 16).unbind(3)
    bias = msa.relative_position_bias_table[relative_position_index(4, 4).reshape(-1)].reshape(16, 16, 2)
    logits = torch.einsum("bwqhd,bwkhd->bwhqk", q * msa.scale, k) + bias.permute(2, 0, 1)
    logits = logits + blk._mask(8, 12, CPU)[None, :, None]
    attn = drop(torch.softmax(logits, -1), drops["attn"])
    o = torch.einsum("bwhqk,bwkhd->bwqhd", attn, v).reshape(2, 6, 16, 32)
    o = drop(F.linear(o, msa.proj.weight, msa.proj.bias), drops["proj"])
    h = x + torch.roll(window_reverse(o, 4, 8, 12), (2, 2), dims=(1, 2))
    fc1, fc2 = blk.ffn.layers[0][0], blk.ffn.layers[1]
    f = F.layer_norm(h, (32,), blk.norm2.weight, blk.norm2.bias, 1e-5)
    f = drop(F.gelu(F.linear(f, fc1.weight, fc1.bias)), drops["ffn1"])
    ref = h + drop(F.linear(f, fc2.weight, fc2.bias), drops["ffn2"])
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    kept = drops["attn"].float().mean().item()
    assert abs(kept - (1 - p)) < 0.02
