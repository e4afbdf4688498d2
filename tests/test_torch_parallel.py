"""The port's ``parallel/`` in one process: mesh specs against JAX's
``parse_mesh_shape``, the loader's rank slices against JAX's loader, the
rows of the global draws, the refusals (an indivisible batch, a 'model'
axis, a mesh over more devices than processes), and a ``data:1`` mesh
computing the no-mesh step bit for bit. Exact comparisons throughout:
index arithmetic and the same arithmetic in the same order."""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch

from diffusiondepth_tpu.data.loader import DataLoader as JDataLoader
from diffusiondepth_tpu.parallel import mesh as jmesh
from diffusiondepth_tpu_torch import Config, LossComputer, build_model, config as pconfig
from diffusiondepth_tpu_torch.data.loader import DataLoader
from diffusiondepth_tpu_torch.parallel import (
    Mesh, activate, all_reduce_sum, create_mesh, launch, parse_mesh_shape, rank_rows,
    run_in_group, shard_batch, state_sharding,
)
from diffusiondepth_tpu_torch.parallel.mesh import choose_backend, draw_rows
from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step
from diffusiondepth_tpu_torch.training.train_state import create_train_state

import test_torch_parallel_support as support

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECS = [(None, 4), ("", 2), ("data:4", 4), ("data:2,model:2", 4), ("model:2", 2),
         (" data : 2", 2), ("data:3", 4), ("data:2,model:2", 8), ("data", 2), ("data:x", 2),
         ("data:2:1", 2)]


@pytest.mark.parametrize("spec,n", SPECS)
def test_parse_mesh_shape_matches_jax(spec, n):
    """The same axes for a valid spec, the same error type and message for
    another."""
    try:
        ref = jmesh.parse_mesh_shape(spec, n)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        with pytest.raises(type(e)) as got:
            parse_mesh_shape(spec, n)
        assert str(got.value) == str(e)
    else:
        assert parse_mesh_shape(spec, n) == ref


class _Indexed:
    """A dataset whose samples carry their index and augmentation seed."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx, seed=None):
        return {"idx": np.array([idx], np.int64), "seed": np.array([seed], np.int64)}


@pytest.mark.parametrize("hosts,accum", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_rank_slices_rebuild_the_jax_batch(hosts, accum):
    """On each host, the ranks' batches are JAX's loader batch (the same
    samples with the same seeds) split by micro-block: rank r holds
    rows [i m + r m/n, i m + (r+1) m/n) of each micro-block i, so that its
    micro-batch i is its share of JAX's micro-batch i."""
    ranks, batch = 2, 8
    ds = _Indexed(40)
    for host in range(hosts):
        kw = dict(shuffle=True, drop_last=True, seed=3, host_index=host, host_count=hosts)
        ref = JDataLoader(ds, batch, **kw)
        ref.set_epoch(2)
        mine = []
        for r in range(ranks):
            loader = DataLoader(ds, batch, rank_index=r, rank_count=ranks, accum_steps=accum, **kw)
            loader.set_epoch(2)
            mine.append(list(loader))
        for i, jb in enumerate(ref):
            m = batch // accum
            for mb in range(accum):
                rows = [mine[r][i]["idx"][mb * (m // ranks):(mb + 1) * (m // ranks)]
                        for r in range(ranks)]
                np.testing.assert_array_equal(np.concatenate(rows), jb["idx"][mb * m:(mb + 1) * m])
            for r in range(ranks):
                sel = rank_rows(batch, accum, r, ranks)
                for k in ("idx", "seed"):
                    np.testing.assert_array_equal(mine[r][i][k], jb[k][sel])
        assert len(mine[0]) == len(ref) > 0


def test_rank_rows_and_shard_batch():
    assert rank_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert rank_rows(8, 1, 0, 4).tolist() == [0, 1]
    mesh = Mesh({"data": 2}, 1, 2, 1, 2, CPU)
    batch = {"x": np.arange(8)[:, None], "t": torch.arange(8), "s": np.float32(3)}
    out = shard_batch(batch, mesh, accum_steps=2)
    assert out["x"][:, 0].tolist() == [2, 3, 6, 7] and out["t"].tolist() == [2, 3, 6, 7]
    assert out["s"] == 3


@pytest.mark.parametrize("batch,accum", [(6, 2), (5, 1), (8, 3)])
def test_indivisible_batch_raises(batch, accum):
    """A micro-batch that does not divide over the ranks raises, naming
    the numbers, as JAX's placement of it on the data axis does."""
    with pytest.raises(ValueError, match=str(batch)):
        rank_rows(batch, accum, 0, 2)
    with pytest.raises(ValueError, match=str(batch)):
        DataLoader(_Indexed(4 * batch), batch, drop_last=True, rank_count=2,
                   accum_steps=accum).batches()


def test_ragged_eval_batch_raises():
    """The last eval batch of 5 samples at batch 2 holds 1 row: over 2
    ranks the pass raises before it loads anything."""
    loader = DataLoader(_Indexed(5), 2, rank_index=0, rank_count=2)
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        next(iter(loader))
    assert [b.tolist() for b in DataLoader(_Indexed(6), 2, rank_index=1,
                                           rank_count=2).batches()] == [[1], [3], [5]]


@pytest.mark.parametrize("spec", ["model:2", "data:2,model:2"])
def test_model_axis_raises(spec):
    """A 'model' axis parses at the command line as JAX's does, and
    create_mesh raises where it asks for more devices than it is given or
    than there are processes, as for a 'data' axis; state_sharding takes
    the mesh."""
    n = pconfig.mesh_devices(spec)
    assert pconfig.parse_args(["--mesh_shape", spec]).mesh_shape == spec
    with pytest.raises(ValueError, match=f"needs {n} devices, have 1"):
        create_mesh(spec, [CPU])
    with pytest.raises(ValueError, match="start one process per device"):
        create_mesh(spec, [CPU] * n)
    mesh = Mesh(pconfig.mesh_axes(spec), 0, n, 0, n, CPU)
    assert (mesh.model_size, mesh.data_size) == (2, n // 2)
    layer = torch.nn.Linear(256, 256)
    assert state_sharding(layer, mesh).sharded == ["weight"]


def test_mesh_over_more_devices_than_processes_raises():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        create_mesh("data:2", [CPU])
    with pytest.raises(ValueError, match="start one process per device"):
        create_mesh("data:2", [CPU, CPU])
    mesh = create_mesh()
    assert mesh.axes == {"data": 1} and mesh.world_size == 1 and mesh.group is None


def test_backend_from_the_devices():
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert choose_backend(cuda) == "nccl"
    assert choose_backend([cuda[0], cuda[0]]) == "gloo"  # NCCL refuses a shared card
    assert choose_backend([CPU, CPU]) == "gloo"


@pytest.mark.parametrize("segments", [1, 2])
def test_draw_rows_are_the_global_draw(segments):
    """Under a 2-rank mesh each rank's draw is its rows of the global
    batch's draw from the same generator state (under flip-TTA, of the
    batch and of its mirror), and every rank's generator then stands where
    one process's does."""
    ref_g = torch.Generator().manual_seed(4)
    full = torch.randn((8, 3), generator=ref_g)
    full_cols = torch.rand((2, 4), generator=ref_g)
    after = torch.rand(1, generator=ref_g)
    rows, cols = [], []
    for r in range(2):
        g = torch.Generator().manual_seed(4)
        with activate(Mesh({"data": 2}, r, 2, r, 2, CPU), segments):
            rows.append(draw_rows(torch.randn, (4, 3), generator=g))
            cols.append(draw_rows(torch.rand, (2, 2), dim=1, generator=g))
        assert torch.equal(torch.rand(1, generator=g), after)
    if segments == 1:
        assert torch.equal(torch.cat(rows), full)
        assert torch.equal(torch.cat(cols, 1), full_cols)
    else:  # rank r: rows [2r, 2r + 2) of each half
        assert torch.equal(torch.cat([rows[0][:2], rows[1][:2], rows[0][2:], rows[1][2:]]), full)
        assert torch.equal(torch.stack([cols[0][:, 0], cols[1][:, 0], cols[0][:, 1],
                                        cols[1][:, 1]], 1), full_cols)
    x = torch.arange(3.0)
    assert all_reduce_sum(x) is x  # no active mesh: the identity


def _micro_cfg():
    return Config(model_name="Diffusion_DCbase_", backbone_module="mmbev_resnet",
                  backbone_name="mmbev_res18", head_specify="DDIMDepthEstimate_Res",
                  inference_steps=2, batch_size=4, accum_steps=2, max_depth=10.0,
                  loss="1.0*L1+1.0*L2+1.0*Sig+1.0*DDIM").finalize()


def _steps(mesh):
    """One train and one eval step of the res18 micro model with the
    same weights, batch and seeds; ``mesh`` None or a one-rank mesh."""
    cfg = _micro_cfg()
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    rng = np.random.RandomState(0)
    gt = torch.from_numpy((rng.rand(4, 32, 48, 1) * 8 + 1).astype(np.float32))
    batch = {"rgb": torch.from_numpy(rng.randn(4, 32, 48, 3).astype(np.float32)), "gt": gt}
    state = create_train_state(model, cfg, 10)
    step = make_train_step(model, LossComputer(cfg), state.optimizer, 2, mesh=mesh)
    loss, lval, met = step(batch, torch.Generator().manual_seed(1))
    pred, emet, _ = make_eval_step(model, tta_flip=True, mesh=mesh, gather=True)(
        batch, generator=torch.Generator().manual_seed(2))
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return [loss, lval, met, pred, emet] + grads + list(model.state_dict().values())


def _in_one_rank_group(cfg, dev, mesh):
    return _steps(mesh)


def test_data_1_mesh_is_the_no_mesh_step_bit_for_bit():
    """A one-rank mesh, with no process group and inside a one-rank gloo
    group (as ``main --mesh_shape data:1`` runs), computes the no-mesh
    train step (accumulating, with Sig) and the flip-TTA eval step bit for
    bit."""
    from diffusiondepth_tpu_torch.parallel.launch import run_ranks

    ref = _steps(None)
    for got in (_steps(create_mesh("data:1", [CPU])),
                run_ranks(_in_one_rank_group, dataclasses.replace(
                    _micro_cfg(), mesh_shape="data:1", port=str(_free_port())), "cpu")):
        assert len(got) == len(ref)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_run_in_group_starts_and_ends_a_group():
    def body():
        assert torch.distributed.get_world_size() == 1
        mesh = create_mesh("data:1")
        return mesh.backend, mesh.group is not None

    assert run_in_group(body, CPU, _free_port()) == ("gloo", True)
    assert not torch.distributed.is_initialized()


def test_a_failed_rank_fails_the_launch():
    """Rank 1 raises: the launch raises (rank 0, waiting on it at a
    collective, fails too and is ended); with no failure it returns rank
    0's result."""
    from torch.multiprocessing import ProcessRaisedException

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    with pytest.raises(ProcessRaisedException, match="terminated with the following error"):
        launch(support.fail_on_rank, [CPU, CPU], _free_port(), (1,))
    assert launch(support.fail_on_rank, [CPU, CPU], _free_port(), (-1,)) == 2
