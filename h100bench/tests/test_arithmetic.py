"""The benchmark's arithmetic: rates over the whole window, the nearest-rank
p90, the seeded sampling, and the idle share of a synthetic
trace whose kernels overlap."""

import json

import pytest

from harness import stats, trace


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(8 * 140, 30.0) == pytest.approx(37.3333333)


def test_p90_nearest_rank():
    lat = list(range(1, 101))  # 1..100
    assert stats.percentile(lat, 90) == 90
    assert stats.percentile(lat[:11], 90) == 10  # ceil(9.9) = 10th value
    assert stats.percentile([5.0], 90) == 5.0


def test_subseeds_differ_and_repeat():
    s = 4000000001
    assert stats.subseed(s, "weights") == stats.subseed(s, "weights")
    assert stats.subseed(s, "weights") != stats.subseed(s, "inputs")
    assert 0 <= stats.subseed(2 ** 40, "x") < 2 ** 63


def test_reservoir_is_seeded_and_uniform_in_size():
    def sample(seed):
        r = stats.Reservoir(4, seed)
        for i in range(100):
            r.offer(lambda i=i: i)
        return r.items

    assert sample(7) == sample(7)
    assert len(sample(7)) == 4 and len(set(sample(7))) == 4
    small = stats.Reservoir(4, 1)
    for i in range(2):
        small.offer(lambda i=i: i)
    assert small.items == [0, 1]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_share_from_union_of_overlapping_kernels(tmp_path):
    events = [
        _ev("k1", "kernel", 1000.0, 30.0),                    # 1000..1030
        _ev("k2", "kernel", 1020.0, 20.0),                    # 1020..1040, overlaps k1
        _ev("copy", "gpu_memcpy", 1060.0, 10.0),              # 1060..1070
        _ev("k3", "kernel", 1090.0, 10.0),                    # 1090..1100
        _ev("cudaLaunchKernel", "cuda_runtime", 1045.0, 10.0),  # host during the 1040..1060 gap
        _ev("gpu_annotation", "gpu_user_annotation", 1000.0, 100.0),  # not device work
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    # the host clock's slice: 130 us, 30 of them before the first or after the last op
    s = trace.summarize(trace.load_events(str(path)), 130e-6)
    assert s["window_s"] == pytest.approx(130e-6)
    assert s["busy_s"] == pytest.approx((40 + 10 + 10) * 1e-6)  # union, not the 70 us sum
    gaps = {name: round(sec * 1e6, 6) for name, sec in s["idle_gaps"]}
    assert sorted(gaps.values()) == [20, 20, 30]  # 1040..1060, 1070..1090, the edges
    assert gaps["cuda_runtime: cudaLaunchKernel"] == 20 and gaps[trace.EDGES] == 30
    assert "host: outside any traced CUDA call (Python, CPU work)" in gaps
    assert s["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert s["kernel_counts"] == {"k1": 1, "k2": 1, "copy": 1, "k3": 1}
    # a host slice shorter than the device's span (clock skew) is the span
    assert trace.summarize(trace.load_events(str(path)), 50e-6)["window_s"] == \
        pytest.approx(100e-6)


def test_union_merges_touching_and_nested():
    assert trace.union([(0, 5), (5, 7), (1, 2), (9, 10)]) == [(0, 7), (9, 10)]
