"""The port's data-parallel training and eval steps on two gloo ranks (CPU
processes started by the port's launcher, ``test_torch_parallel_support``)
against JAX's ``data:2`` mesh and against the port's one-process step.
The swin_micro cases are in ``test_torch_parallel_train_swin.py`` (their
JAX f64 step is the longest test of the suite: under ``--dist loadfile`` a
file of its own runs on a worker of its own); both files run the same
checks, ``test_torch_support.dp_*``.

Three families at micro size, f32: ``mmbev_res18`` + ``DDIMDepthEstimate_Res``
(the JAX data-parallel tests' model, here with the Sig term too), ``swin_micro``
under the flagship head at ``accum_steps=2`` with ``1.0*L1+1.0*L2+1.0*DDIM``,
and NLSPN (resnet18, prop_time 3). Every batch has uneven valid-pixel counts
per rank (rank 0's rows are 85% invalid, rank 1's 5%), so a batch-level term
taken per rank (a DDIM mean counted N times, per-rank Sig terms, averaged
RMSEs) would not match.

* Against JAX's ``make_train_step(mesh=create_mesh("data:2", ...))`` with the
  same weights and the same draws (the starting latent, the ddim_loss noise
  and timesteps handed to both, drop-path off): the loss, the loss and
  metric rows at ``test_torch_train_step``'s 2e-3, every gradient at 2e-3 of
  its leaf's largest value (JAX steps with SGD at lr 1, so its parameter
  change is minus the gradient), the BatchNorm statistics at 1e-5; the eval
  step's pred and metric row at ``test_torch_model_eval``'s 1e-3. JAX runs
  in f64 (``jax.enable_x64``) for swin and NLSPN, as ``test_torch_nlspn``
  holds NLSPN: at this batch JAX's own f32 gradient of swin_micro's FPN
  (``conv_up``) lies 3.7e-3 of the leaf from its f64 one, while the port's
  f32 lies within 2.3e-4. For res18 it runs in f32: CBAM's BatchNorm over
  (B, 1, 1, C) maps (ROADMAP, "Conditioning") moves the f32 gradients of
  the first stage 4.3e-3 from f64 in both packages alike, and the two f32
  steps agree to 4.9e-4.
* Against the port's one-process step on the whole batch with the same
  generator seed (no injected draws; drop-path on for swin): the draws are
  the global batch's on every rank, so the two differ only by the order of
  f32 sums (the BatchNorm moments and the gradient summed over the ranks).
  Loss and loss row to 1e-5 (measured 1.2e-7), the metric row to 1e-4 (the
  inverse-depth sums cancel: 9.6e-6 measured for NLSPN), every gradient to
  1e-3 of its leaf's largest value (measured: 4.4e-6 for NLSPN; res18 3.3e-6
  but for the bias of the depth decoder's first deconv, which BatchNorm
  follows, so that its gradient is float noise, 2.5e-4; swin 1.6e-4 in the
  denoiser's noise embedding, fed through both sampler steps), and the
  parameters after Adam's first update within 2 lr: Adam's first step is
  about lr sign(g), and a near-zero gradient whose sign flips under another
  reduction order moves a weight by up to 2 lr
  (``tests/test_parallel_training.py:96-99`` allows the same). The eval
  step's pred to 1e-5.
* The two ranks end with bit-equal parameters and buffers.

Both packages run on the CPU, the port with oneDNN off: oneDNN's
convolution backward loses precision at some shapes (NLSPN's conv5 weight
gradient at batch 4 lay 50% of the leaf from JAX's, whose f32 and f64 agree
to 7e-6; 9.4e-6 with PyTorch's own kernels).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from diffusiondepth_tpu_torch.losses import sig_loss  # noqa: E402
from diffusiondepth_tpu_torch.metrics import evaluate_depth_metrics  # noqa: E402

from test_torch_support import (  # noqa: E402,F401  (dp_no_onednn: an autouse fixture)
    DP_FAMILIES, dp_check_matches_jax_data_mesh, dp_check_ranks_end_bit_equal,
    dp_check_ranks_match_one_process, dp_no_onednn, dp_ranks_out, dp_reductions_case,
)

torch.set_num_threads(1)

FAMILIES = sorted(f for f in DP_FAMILIES if f != "swin")


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case of res18 and NLSPN, and the reductions case, run once by
    two gloo ranks in one spawned group."""
    return dp_ranks_out(tmp_path_factory.mktemp("ranks"), FAMILIES, reductions=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_and_eval_step_match_jax_data_mesh(family, ranks_out, monkeypatch):
    """Two gloo ranks against JAX's data:2 mesh: one train step and one
    eval step (see the module docstring for the tolerances)."""
    dp_check_matches_jax_data_mesh(family, ranks_out, monkeypatch)


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_match_one_process(family, ranks_out):
    """Two ranks against one process on the same global batch and seed:
    the numbers do not depend on the number of ranks."""
    dp_check_ranks_match_one_process(family, ranks_out)


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_end_bit_equal(family, ranks_out):
    """One optimizer update from the same all-reduced gradient: every
    parameter and buffer is the same on both ranks, bit for bit, and so
    are the returned rows."""
    dp_check_ranks_end_bit_equal(family, ranks_out)


def test_sig_and_metrics_over_uneven_ranks(ranks_out):
    """Sig and the metric row under the mesh are the global batch's, with
    rank 0's rows 85% invalid and rank 1's 5%; the mean of the two ranks'
    own rows is not (the error the global sums prevent)."""
    case = dp_reductions_case()
    pred, gt = torch.from_numpy(case["pred"]), torch.from_numpy(case["gt"])
    sig = sig_loss(pred, gt).item()
    row = evaluate_depth_metrics({"gt": gt}, {"pred": pred}).numpy()
    outs = ranks_out("reductions")
    for out in outs:
        np.testing.assert_allclose(out["sig"].item(), sig, rtol=1e-6)
        np.testing.assert_allclose(out["metrics"].numpy(), row, rtol=1e-6)
    naive = np.mean([o["local_metrics"].numpy() for o in outs], axis=0)
    assert np.abs(naive[0, 0] - row[0, 0]) > 1e-2 * row[0, 0]  # RMSE of the averaged rows
