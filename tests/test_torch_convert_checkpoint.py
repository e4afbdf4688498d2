"""Reference PyTorch checkpoints into the port
(``utils/convert_torch_checkpoint.py``, ``tools/convert_checkpoint.py``)
against the JAX package's converter, on the CPU.

For each layout a reference state dict goes two ways: through the port's
loader, and through the JAX package's converter
(``convert_torch_checkpoint``) and back with ``jax_to_state_dict``. The
two must hold exactly (``torch.equal``) the same tensor under every name
both produce, and the port's must hold every name the JAX path does."""

import argparse
import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.utils import convert_torch_checkpoint as jconv  # noqa: E402
import diffusiondepth_tpu_torch as port  # noqa: E402
from diffusiondepth_tpu_torch.tools.convert_checkpoint import main as convert_main  # noqa: E402
from diffusiondepth_tpu_torch.utils import convert_torch_checkpoint as conv  # noqa: E402
from diffusiondepth_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_convert_full_model import _synth_reference_sd  # noqa: E402
from test_convert_mpvit_nlspn import _synth_mpvit_sd, _synth_nlspn_sd  # noqa: E402
from test_torch_support import module_variables  # noqa: E402

torch.set_num_threads(1)
TINY_DEPTHS, TINY_DIMS, TINY_HEADS = (2, 2, 6, 2), (96, 192, 384, 768), (3, 6, 12, 24)


def _tensors(sd):
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def _same_on_common_keys(ours, theirs):
    missing = sorted(set(theirs) - set(ours))
    assert not missing, missing[:5]
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and torch.equal(ours[k].float(), v), k


def _official_swin_sd(depths=TINY_DEPTHS, dims=TINY_DIMS, heads=TINY_HEADS, win=7, seed=0):
    """Official (Microsoft) Swin classification weights: ``layers.i``,
    ``attn.qkv``, ``mlp.fc1``, concat-order patch merging, the head and the
    final norm, and the buffers the converter drops."""
    rng = np.random.RandomState(seed)

    def t(*s):
        return (rng.randn(*s) * 0.05).astype(np.float32)

    sd = {"patch_embed.proj.weight": t(dims[0], 3, 4, 4), "patch_embed.proj.bias": t(dims[0]),
          "patch_embed.norm.weight": t(dims[0]), "patch_embed.norm.bias": t(dims[0]),
          "norm.weight": t(dims[-1]), "norm.bias": t(dims[-1]),
          "head.weight": t(10, dims[-1]), "head.bias": t(10)}
    for i, (dep, d, h) in enumerate(zip(depths, dims, heads)):
        for j in range(dep):
            p = f"layers.{i}.blocks.{j}"
            for n in ("norm1", "norm2"):
                sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = t(d), t(d)
            sd[p + ".attn.qkv.weight"], sd[p + ".attn.qkv.bias"] = t(3 * d, d), t(3 * d)
            sd[p + ".attn.proj.weight"], sd[p + ".attn.proj.bias"] = t(d, d), t(d)
            sd[p + ".attn.relative_position_bias_table"] = t((2 * win - 1) ** 2, h)
            sd[p + ".attn.relative_position_index"] = np.zeros((win * win, win * win), np.int64)
            sd[p + ".mlp.fc1.weight"], sd[p + ".mlp.fc1.bias"] = t(4 * d, d), t(4 * d)
            sd[p + ".mlp.fc2.weight"], sd[p + ".mlp.fc2.bias"] = t(d, 4 * d), t(d)
        if i < len(depths) - 1:
            sd[f"layers.{i}.downsample.reduction.weight"] = t(2 * d, 4 * d)
            sd[f"layers.{i}.downsample.norm.weight"] = t(4 * d)
            sd[f"layers.{i}.downsample.norm.bias"] = t(4 * d)
    return sd


def _res18_reference_sd():
    """The reference's mmbev_res18 + DDIMDepthEstimate_Res names (the
    port's, by ROADMAP rule 1) with random values."""
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="mmbev_resnet",
                      backbone_name="mmbev_res18", head_specify="DDIMDepthEstimate_Res",
                      inference_steps=1).finalize()
    rng = np.random.RandomState(4)
    return {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for k, v in port.build_model(cfg, device="cpu").state_dict().items()
            if v.is_floating_point()}


@pytest.mark.parametrize("layout", ["mmbev_res18", "mpvit_tiny", "nlspn", "official_swin"])
def test_loader_matches_jax_converter(layout):
    if layout == "official_swin":
        sd = _official_swin_sd()
        params = jconv.convert_swin_official(sd, depths=TINY_DEPTHS)
        theirs = jax_to_state_dict({"depth_backbone": params})
    else:
        sd = {"mmbev_res18": _res18_reference_sd,
              "mpvit_tiny": lambda: _synth_mpvit_sd(dims=(64, 96, 176, 216), paths=(2, 3, 3, 3),
                                                    layers=(1, 2, 4, 1), heads=8, mlp=2,
                                                    prefix="depth_backbone."),
              "nlspn": _synth_nlspn_sd}[layout]()
        params, stats = jconv.convert_reference_model(sd)
        # a backbone-only checkpoint leaves the head's subtrees empty
        theirs = jax_to_state_dict({k: v for k, v in params.items() if v},
                                   {k: v for k, v in stats.items() if v})
    ours = conv.convert_reference_state_dict(_tensors(sd))
    _same_on_common_keys(ours, theirs)


def test_swin_mmcv_full_model_matches_jax_load(tmp_path):
    """swin_tiny + DDIMDepthEstimate_Swin_ADDHAHI in the reference's mmcv
    names (``_synth_reference_sd``), saved as ``{"net": ...}``: the port's
    ``load_reference_checkpoint`` against JAX's ``load_reference_checkpoint``
    (read, convert, merge over init) and ``jax_to_state_dict``, on every
    name the checkpoint holds."""
    sd = _synth_reference_sd()
    sd["depth_head.hahineck.self_attn.in_proj_weight"] = np.ones((3, 3), np.float32)  # dormant
    pt = str(tmp_path / "model_00022.pt")
    torch.save({"net": {"module." + k: v for k, v in _tensors(sd).items()},
                "args": argparse.Namespace(epochs=22)}, pt)

    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_tiny", head_specify="DDIMDepthEstimate_Swin_ADDHAHI",
                      head_in_channels="96,192,384,768", inference_steps=1).finalize()
    model = port.build_model(cfg, device="cpu")
    ours, replaced = conv.load_reference_checkpoint(pt, model.state_dict())
    assert replaced == len(sd) - 1

    from diffusiondepth_tpu.models.diffusion_model import Diffusion_DCbase_Model

    jmodel = Diffusion_DCbase_Model(backbone_name="swin_tiny", backbone_module="swin",
                                    head_name="DDIMDepthEstimate_Swin_ADDHAHI",
                                    inference_steps=1, head_in_channels=TINY_DIMS)
    b = {"rgb": np.zeros((1, 64, 96, 3), np.float32), "gt": np.ones((1, 64, 96, 1), np.float32)}
    variables = module_variables(jmodel, b, init_latent=np.zeros((1, 32, 48, 16), np.float32))
    merged = jconv.load_reference_checkpoint(pt, variables, swin_depths=TINY_DEPTHS)
    theirs = jax_to_state_dict(merged["params"], merged["batch_stats"])
    _same_on_common_keys(ours, {k: v for k, v in theirs.items() if k in sd})


def test_rel_pos_table_resize_matches_jax():
    """A 12-window table to the 7 window and back, as jax.image.resize
    computes it: within 1e-5 of the table's largest value (JAX's f32
    result is itself up to 2e-6 of it from the float64 value, the port's
    under 2e-7)."""
    rng = np.random.RandomState(5)
    for src, dst in ((23, 13), (13, 23)):
        table = rng.randn(src * src, 4).astype(np.float32)
        want = np.asarray(jconv.resize_rel_pos_table(table, dst * dst))
        got = conv.resize_rel_pos_table(torch.from_numpy(table), dst * dst).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_convert_cli_end_to_end(tmp_path):
    """``--torch`` a reference .pt (with the reference's args Namespace
    beside the weights) -> a port checkpoint whose every tensor the file
    names carries the file's value; the args round-trip."""
    sd = _synth_reference_sd()
    pt = str(tmp_path / "model_00022.pt")
    torch.save({"net": _tensors(sd), "args": argparse.Namespace(epochs=22)}, pt)
    out_dir = str(tmp_path / "converted")
    rc = convert_main(["--torch", pt, "--out_dir", out_dir, "--epoch", "22", "--device", "cpu",
                       "--model_name", "Diffusion_DCbase_", "--backbone_module", "swin",
                       "--backbone_name", "swin_tiny",
                       "--head_specify", "DDIMDepthEstimate_Swin_ADDHAHI",
                       "--head_in_channels", "96,192,384,768", "--inference_steps", "2"])
    assert rc == 0
    payload = load_checkpoint(f"{out_dir}/model_00022.ckpt")
    assert payload["args"].backbone_name == "swin_tiny"
    assert payload["args"].head_in_channels == "96,192,384,768"
    state = payload["state_dict"]
    for k, v in sd.items():
        assert torch.equal(state[k], torch.from_numpy(v)), k


def test_convert_cli_rejects_unknown_layout(tmp_path):
    pt = str(tmp_path / "junk.pt")
    torch.save({"net": {"some.unknown.weight": torch.zeros(3, 3)}}, pt)
    rc = convert_main(["--torch", pt, "--out_dir", str(tmp_path / "x"), "--device", "cpu",
                       "--model_name", "Diffusion_DCbase_", "--backbone_module", "mmbev_resnet",
                       "--backbone_name", "mmbev_res18", "--head_specify", "DDIMDepthEstimate_Res",
                       "--inference_steps", "2"])
    assert rc == 1  # no tensor replaced: an explicit failure


class _Opaque:
    """A class a weights-only load does not know."""


def test_loader_refuses_unknown_classes_unless_trusted(tmp_path):
    """A file that needs a class other than argparse.Namespace is refused
    by the weights-only load; ``trust_pickle`` unpickles it in full."""
    import pickle

    pt = str(tmp_path / "odd.pt")
    torch.save({"net": {"conv1_rgb.0.weight": torch.ones(1)}, "extra": _Opaque()}, pt)
    with pytest.raises(pickle.UnpicklingError):
        conv.load_torch_file(pt)
    assert torch.equal(conv.load_torch_file(pt, trust_pickle=True)["conv1_rgb.0.weight"],
                       torch.ones(1))
