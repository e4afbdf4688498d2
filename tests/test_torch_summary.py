"""The port's summaries against the JAX package's, for the same arrays:
text logs and the scalars file character for character, TensorBoard
records equal but for the wall time (image records: the same header and
the same pixels; the PNG bytes come from two encoders), the colour maps
equal, and ``save`` writing the same file names with the same pixels.
All exact."""

import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from diffusiondepth_tpu.ops import vis as jvis
from diffusiondepth_tpu.summary import get as jget_summary
from diffusiondepth_tpu.summary.tb_events import EventFileWriter as JWriter
from diffusiondepth_tpu_torch.native.png import read_png
from diffusiondepth_tpu_torch.ops import vis
from diffusiondepth_tpu_torch.summary import get as get_summary
from diffusiondepth_tpu_torch.summary.tb_events import (
    EventFileWriter, parse_event, read_events, read_records,
)


def _args(**kw):
    base = dict(model_name="Diffusion_DCbase_", loss="1.0*L1+1.0*L2+1.0*DDIM", max_depth=88.0,
                num_summary=2, save_result_only=False, save_raw_npdepth=False)
    return SimpleNamespace(**{**base, **kw})


def _batch(seed, b=3, h=12, w=20):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * 90).astype(np.float32)
    return ({"rgb": rng.randn(b, h, w, 3).astype(np.float32),
             "dep": gt * (rng.rand(b, h, w, 1) > 0.8), "gt": gt,
             "K": np.ones((b, 4), np.float32)},
            {"pred": (rng.rand(b, h, w, 1) * 95 - 2).astype(np.float32)})


def _event_file(d):
    (name,) = [f for f in os.listdir(d) if f.startswith("events.out.tfevents")]
    return os.path.join(d, name)


def _run(get, root, mode, args):
    w = get(args)(str(root), mode, args)
    rng = np.random.RandomState(1)
    for epoch in (1, 2):
        for _ in range(3):
            w.add(loss=rng.rand(1, 4).astype(np.float32) * 10,
                  metric=rng.rand(1, 8).astype(np.float32))
        sample, output = _batch(epoch)
        w.update(epoch, sample if mode != "train" else None, output if mode != "train" else None)
    w.writer.close()
    return w


@pytest.mark.parametrize("mode", ["train", "val"])
def test_logs_and_events_match_jax(tmp_path, mode):
    args = _args()
    _run(jget_summary, tmp_path / "jax", mode, args)
    _run(get_summary, tmp_path / "port", mode, args)
    for name in (f"loss_{mode}.txt", f"metric_{mode}.txt", f"scalars_{mode}.jsonl"):
        a = (tmp_path / "port" / name).read_text()
        assert a == (tmp_path / "jax" / name).read_text(), name
        assert a or name.startswith("loss_") and mode != "train"
    ours = read_records(_event_file(tmp_path / "port" / mode))
    ref = read_records(_event_file(tmp_path / "jax" / mode))  # JAX's CRCs check too
    assert len(ours) == len(ref) == 1 + 2 * (4 + 8 + (mode != "train"))
    for a, b in zip(ours, ref):
        ea, eb = parse_event(a), parse_event(b)
        if any("image" in v for v in eb["values"]):
            (va,), (vb,) = ea["values"], eb["values"]
            assert ea["step"] == eb["step"] and va["tag"] == vb["tag"]
            ia, ib = va["image"], vb["image"]
            assert [ia[k] for k in ("height", "width", "colorspace")] == [
                ib[k] for k in ("height", "width", "colorspace")]
            assert np.array_equal(np.array(Image.open(io.BytesIO(ia["png"]))),
                                  np.array(Image.open(io.BytesIO(ib["png"]))))
        else:
            # the first 9 bytes are the wall time (field 1, a double)
            assert a[0] == b[0] == 0x09 and a[9:] == b[9:]
    if mode == "val":
        for step in ("step_000001.png", "step_000002.png"):
            assert np.array_equal(read_png(str(tmp_path / "port" / mode / "images" / step)),
                                  np.array(Image.open(tmp_path / "jax" / mode / "images" / step)))


def test_event_reader_checks_crcs(tmp_path):
    w = EventFileWriter(str(tmp_path))
    w.add_scalar("Loss/L1", 0.5, 3)
    w.add_image("x", np.zeros((4, 5, 3), np.uint8), 3)
    w.close()
    events = read_events(w.path)
    assert [e["step"] for e in events] == [0, 3, 3]
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1]["values"] == [{"tag": "Loss/L1", "simple_value": 0.5}]
    data = bytearray(open(w.path, "rb").read())
    data[30] ^= 0xFF
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_records(w.path)


def test_scalar_records_byte_equal_to_jax(tmp_path, monkeypatch):
    """With the wall time fixed, every scalar record is byte-equal to the
    JAX writer's, CRCs included."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1234.5)
    for d, cls in (("p", EventFileWriter), ("j", JWriter)):
        os.makedirs(tmp_path / d)
        w = cls(str(tmp_path / d))
        for i, v in enumerate((0.25, -3.0, 1e-7)):
            w.add_scalar(f"Metric/{i}", v, i * 7)
        w.close()
    assert open(_event_file(tmp_path / "p"), "rb").read() == open(
        _event_file(tmp_path / "j"), "rb").read()


def test_colour_maps_match_jax():
    rng = np.random.RandomState(0)
    d = np.concatenate([rng.rand(50_000) * 130 - 5, [0.0, 112.0, 1e4, np.inf, np.nan]])
    d = d.astype(np.float32).reshape(5, -1)
    with np.errstate(invalid="ignore"):
        a, b = vis.color_depth(d), jvis.color_depth(d)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    x = rng.rand(30, 40) * 300 - 20
    a, b = vis.colormap_255(x), jvis.colormap_255(x)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        vis.colormap_255(x, "viridis")


@pytest.mark.parametrize("result_only,raw", [(True, True), (True, False), (False, True)])
def test_save_matches_jax(tmp_path, result_only, raw):
    """The same file names (sample b of a batch starting at dataset index
    idx as idx + b) and the same pixels: the KITTI submission PNG
    uint16(pred * 256), or the rgb / dep / pred / gt panel PNGs."""
    args = _args(save_result_only=result_only, save_raw_npdepth=raw)
    sample, output = _batch(4)
    for d, get in (("port", get_summary), ("jax", jget_summary)):
        w = get(args)(str(tmp_path / d), "test", args)
        w.save(3, 5, sample, output)
    files = {}
    for d in ("port", "jax"):
        root = tmp_path / d / "test"
        files[d] = sorted(os.path.relpath(os.path.join(r, f), root)
                          for r, _, fs in os.walk(root) for f in fs if "tfevents" not in f)
    assert files["port"] == files["jax"] and len(files["port"]) == 3 * (
        (1 + raw) if result_only else (4 + raw))
    for f in files["port"]:
        a, b = tmp_path / "port" / "test" / f, tmp_path / "jax" / "test" / f
        if f.endswith(".png"):
            assert np.array_equal(read_png(str(a)), np.array(Image.open(b))), f
        else:
            assert np.array_equal(np.load(a), np.load(b)), f
    if result_only:
        pred = np.clip(output["pred"][1, ..., 0], 0, None)
        assert np.array_equal(read_png(str(tmp_path / "port/test/epoch0003/0000000006.png")),
                              (pred * 256.0).astype(np.uint16))


def test_nlspn_summary_raises():
    """NLSPN resolves to NLSPNSummary (ported); a model without a summary
    class raises."""
    from diffusiondepth_tpu_torch.summary import NLSPNSummary

    assert get_summary(_args(model_name="NLSPN")) is NLSPNSummary
    with pytest.raises(NotImplementedError, match="NoSuchModelSummary"):
        get_summary(_args(model_name="NoSuchModel"))


def _nlspn_output(seed, b=3, h=12, w=20, steps=4):
    rng = np.random.RandomState(seed)
    return {"pred_init": (rng.rand(b, h, w, 1) * 95 - 2).astype(np.float32),
            "pred_inter": (rng.rand(steps, b, h, w, 1) * 95).astype(np.float32),
            "guidance": rng.randn(b, h, w, 8).astype(np.float32),
            "offset": rng.randn(b, h, w, 18).astype(np.float32),
            "aff": rng.randn(b, h, w, 9).astype(np.float32),
            "gamma": np.asarray([4.25], np.float32),
            "confidence": (rng.rand(b, h, w, 1) * 1.2 - 0.1).astype(np.float32)}


@pytest.mark.parametrize("result_only", [False, True])
def test_nlspn_summary_matches_jax(tmp_path, result_only):
    """NLSPNSummary: the Etc/gamma scalar and the rgb | dep | pred | gt |
    confidence panel of ``update`` (scalars file and event records, panel
    pixels), and ``save``'s per-sample files (the propagation maps, the
    gray copy, the raw dumps), against JAX's, exactly."""
    args = _args(model_name="NLSPN", loss="1.0*L1+1.0*L2", save_result_only=result_only,
                 save_raw_npdepth=True)
    sample, output = _batch(7)
    output.update(_nlspn_output(8))
    for d, get in (("port", get_summary), ("jax", jget_summary)):
        w = get(args)(str(tmp_path / d), "val", args)
        w.add(metric=np.ones((1, 8), np.float32))
        w.update(2, sample, output)
        w.save(0, 4, sample, output)
        w.writer.close()
    a = (tmp_path / "port" / "scalars_val.jsonl").read_text()
    assert a == (tmp_path / "jax" / "scalars_val.jsonl").read_text() and "Etc/gamma" in a
    ours = read_records(_event_file(tmp_path / "port" / "val"))
    ref = read_records(_event_file(tmp_path / "jax" / "val"))
    assert len(ours) == len(ref) == 1 + 8 + 1 + 1
    files = {}
    for d in ("port", "jax"):
        root = tmp_path / d / "val"
        files[d] = sorted(os.path.relpath(os.path.join(r, f), root)
                          for r, _, fs in os.walk(root) for f in fs if "tfevents" not in f)
    per_sample = 2 if result_only else 6 + 4 + 5  # PNGs, 4 step maps, dumps
    assert files["port"] == files["jax"] and len(files["port"]) == 1 + 3 * per_sample
    for f in files["port"]:
        a, b = tmp_path / "port" / "val" / f, tmp_path / "jax" / "val" / f
        if f.endswith(".png"):
            assert np.array_equal(read_png(str(a)), np.array(Image.open(b))), f
        else:
            assert np.array_equal(np.load(a), np.load(b)), f


def test_metric_and_loss_factories_match_jax():
    """``get_metric`` and ``get_loss`` build the plugins JAX's build: the
    same metric names and row (f32, 1e-5 of each value), the same loss
    terms."""
    import torch

    from diffusiondepth_tpu.losses import get_loss as jget_loss
    from diffusiondepth_tpu.metrics import get_metric as jget_metric
    from diffusiondepth_tpu_torch.losses import get_loss
    from diffusiondepth_tpu_torch.metrics import METRIC_NAMES, get_metric

    args = _args()
    sample, output = _batch(6)
    metric, jmetric = get_metric(args)(), jget_metric(args)()
    assert list(metric.metric_name) == list(jmetric.metric_name) == METRIC_NAMES
    row = metric.evaluate({"gt": torch.from_numpy(sample["gt"])},
                          {"pred": torch.from_numpy(output["pred"])}).numpy()
    np.testing.assert_allclose(row, np.asarray(jmetric.evaluate(sample, output)), rtol=1e-5)
    loss, jloss = get_loss(args)(), jget_loss(args)()
    assert loss.loss_name == jloss.loss_name == ["L1", "L2", "DDIM"]
