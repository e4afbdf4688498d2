"""``main``'s profiler window on the CPU: ``--profile_dir`` traces steps
10-15 of the first epoch with torch.profiler (in a file of its own: the
16 training steps take a while on one thread)."""

import json

import torch

from diffusiondepth_tpu_torch import main as pmain
from diffusiondepth_tpu_torch.config import parse_args

torch.set_num_threads(1)


def test_profile_dir_traces_steps_10_to_15(tmp_path, capsys):
    """``--profile_dir`` traces steps 10-15 of the first epoch with
    torch.profiler, writes the trace and prints its table (CPU time on the
    CPU)."""
    cfg = parse_args(["--data_name", "Synthetic", "--model_name", "Diffusion_DCbase_",
                      "--backbone_module", "mmbev_resnet", "--backbone_name", "mmbev_res18",
                      "--inference_steps", "1", "--patch_height", "32", "--patch_width", "32",
                      "--batch_size", "4", "--test_batch_size", "16", "--epochs", "1",
                      "--log_every", "100", "--profile_dir", str(tmp_path / "prof")])
    cfg.save_dir = str(tmp_path / "run")
    state = pmain.train(cfg, device="cpu")
    assert state.step == 16 and len(state.timings["step_s"]) == 16
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "Self CPU time total" in capsys.readouterr().out
