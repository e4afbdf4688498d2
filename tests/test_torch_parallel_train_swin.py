"""The swin_micro cases of ``test_torch_parallel_train.py``: the port's
data-parallel training and eval steps of swin_micro under the flagship
head (accumulating, ``1.0*L1+1.0*L2+1.0*DDIM``) on two gloo ranks against
JAX's ``data:2`` mesh in f64 and against the port's one-process step, and
the two ranks bit-equal. The same checks and tolerances as there
(``test_torch_support.dp_*``; its docstring explains them); a file of its
own so that JAX's f64 ``data:2`` step, the longest test of the suite, runs
on a worker of its own under ``--dist loadfile``.
"""

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from test_torch_support import (  # noqa: E402,F401  (dp_no_onednn: an autouse fixture)
    dp_check_matches_jax_data_mesh, dp_check_ranks_end_bit_equal,
    dp_check_ranks_match_one_process, dp_no_onednn, dp_ranks_out,
)

torch.set_num_threads(1)

FAMILIES = ["swin"]


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """The swin cases run once by two gloo ranks in one spawned group."""
    return dp_ranks_out(tmp_path_factory.mktemp("ranks"), FAMILIES)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_and_eval_step_match_jax_data_mesh(family, ranks_out, monkeypatch):
    """Two gloo ranks against JAX's data:2 mesh: one train step and one
    eval step."""
    dp_check_matches_jax_data_mesh(family, ranks_out, monkeypatch)


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_match_one_process(family, ranks_out):
    """Two ranks against one process on the same global batch and seed."""
    dp_check_ranks_match_one_process(family, ranks_out)


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_end_bit_equal(family, ranks_out):
    """Every parameter, buffer and returned row the same on both ranks,
    bit for bit."""
    dp_check_ranks_end_bit_equal(family, ranks_out)
