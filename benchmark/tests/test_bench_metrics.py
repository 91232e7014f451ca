"""The benchmark's arithmetic on synthetic inputs, and the discovery of its
cells, configurations, metrics and rooflines by file name."""

import json
import types

import pytest
import torch

from benchmark.harness import spec, stats
from benchmark.harness.timeline import WINDOW, Timeline, short_name
from benchmark.rooflines import k1, k2


def run_of(**kw):
    base = dict(blocks=[], block_ms=[], timeline=None, calls={},
                rooflines=spec.rooflines(), devices=[0], message_bits=9216,
                window_s=1.0, setup_s=0.0, log=lambda m: None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_rate_counts_all_work_over_all_time_with_a_stalled_block():
    """Ten blocks of 0.1 s and one stalled for 2 s: the rate is their
    bits over the 3 s, not over the blocks' median time."""
    blocks = [dict(trials=2048)] * 11
    run = run_of(blocks=blocks, window_s=3.0)
    rate = spec.reader("decoded_bits_per_s").read(run)
    assert rate == pytest.approx(11 * 2048 * 9216 / 3.0)
    assert rate < 2048 * 9216 / 0.1


def test_percentiles_over_all_blocks():
    ms = [100.0] * 95 + [500.0] * 5
    run = run_of(block_ms=ms)
    assert spec.reader("block_ms_p50").read(run) == 100.0
    assert spec.reader("block_ms_p90").read(run) == 100.0
    ms = [float(i) for i in range(1, 201)]
    assert stats.percentile(ms, 90) == 180.0
    assert spec.reader("block_ms_p90").read(run_of(block_ms=ms)) == 180.0
    # fewer than ten blocks beyond the 90th percentile: nothing to read
    assert spec.reader("block_ms_p90").read(
        run_of(block_ms=ms[:99])) is None
    assert stats.percentile([3.0], 50) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def trace_events():
    """A 100 us window: card 0 busy 10-30 and 20-40 (overlapping) and
    60-70, card 1 busy 0-100; a K1 kernel and a memcpy among them."""
    ev = [dict(ph="X", cat="user_annotation", name=WINDOW, ts=1000,
               dur=100, tid=1),
          dict(ph="X", cat="cpu_op", name="aten::randint", ts=1040, dur=25,
               tid=1),
          dict(ph="X", cat="cpu_op", name="outer", ts=1000, dur=100, tid=1),
          dict(ph="X", cat="kernel",
               name="void k1_col_kernel<1, 2, float>(float*, int)",
               ts=1010, dur=20, args=dict(device=0)),
          dict(ph="X", cat="kernel", name="void other_kernel<3>(int)",
               ts=1020, dur=20, args=dict(device=0)),
          dict(ph="X", cat="gpu_memcpy",
               name="Memcpy PtoP (Device -> Device)", ts=1060, dur=10,
               args=dict(device=0)),
          dict(ph="X", cat="kernel", name="k1_row_kernel", ts=990, dur=120,
               args=dict(device=1))]
    return ev


def test_idle_share_from_a_made_up_timeline(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": trace_events()}))
    tl = Timeline.load(str(p))
    assert tl.seconds() == pytest.approx(100e-6)
    assert tl.busy_seconds(0) == pytest.approx(40e-6)
    assert tl.idle_share(0) == pytest.approx(0.6)
    assert tl.idle_share(1) == pytest.approx(0.0)
    run = run_of(timeline=tl, devices=[0, 1], blocks=[dict(trials=1)])
    assert spec.reader("device_idle_pct").read(run) == pytest.approx(30.0)
    gaps = dict(tl.top_idle_gaps(0))
    assert gaps["aten::randint"] == pytest.approx(20e-6)
    assert gaps["outer"] == pytest.approx(40e-6)
    ops = dict(tl.top_device_ops())
    assert ops["k1_row_kernel"] == pytest.approx(100e-6)   # clipped
    assert ops["Memcpy PtoP"] == pytest.approx(10e-6)
    # the kernels outside the port's (k1_*, bp_*): other_kernel alone
    assert spec.reader("outside_kernels_ms").read(run) == pytest.approx(
        20e-3)
    assert spec.reader("dp_gather_ms").read(run) == pytest.approx(10e-3)


def test_short_names():
    assert short_name("void k1_col_kernel<1, (anonymous namespace)::X<2>, "
                      "float>(float*, Support)") == "k1_col_kernel"
    assert short_name("void at::native::vectorized_elementwise_kernel<4>"
                      "(int)") == "vectorized_elementwise_kernel"
    assert short_name("Memset (Device)") == "Memset"
    assert short_name("void (anonymous namespace)::k1_row_kernel<512, "
                      "__nv_bfloat16, 1, 0>(__nv_bfloat16*, float*)") == (
        "k1_row_kernel")


def test_roofline_share_from_counts_and_trace(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": trace_events()}))
    tl = Timeline.load(str(p))
    rec = dict(B=2, L=64, M=64, T=4, iters=torch.tensor([4, 3]),
               noise_drawn=True)
    run = run_of(timeline=tl, calls={"k1": [rec], "k2": []})
    k1_s = 20e-6 + 100e-6
    assert spec.reader("k1_roofline").read(run) == pytest.approx(
        100 * k1.least(rec) / k1_s)
    assert spec.reader("k2_roofline").read(run) is None


def test_k1_count_reproduces_the_headline_bound():
    """17.5 ms at B = 2048, L = 1024, M = 512, T = 22 (PERF.md's bound of
    the headline call, its noise given as input), bound by operations."""
    B, T = 2048, 22
    s = k1.least_seconds(B, 1024, 512, T, B * T, noise_drawn=False)
    assert s * 1e3 == pytest.approx(17.5, abs=0.05)
    # the noise drawn in the kernel reads half the bytes, the same work
    assert k1.least_seconds(B, 1024, 512, T, B * T, True) == s


def test_k2_count_reproduces_the_concat_bound():
    """0.025 ms at the concat block (12 288 codewords of the n = 744 array
    code, 1.18 iterations each), bound by bytes."""
    N = 12288
    s = k2.least_seconds(N, 744, 31 * 96, 1.18 * N)
    assert s * 1e3 == pytest.approx(0.025, abs=0.0005)
    assert s == pytest.approx(N * (744 * 9 + 5) / 3.35e12)


def test_k1_record_takes_the_split_form_only():
    x = torch.zeros(1)
    res = (x, x, torch.tensor([3, 3], dtype=torch.int32))
    args = (None, torch.zeros(64, 64), x, 1.0, 100, 5)
    assert k1.record(args, dict(split=True), res)["T"] == 5
    assert k1.record(args, dict(split=None), res) is None      # mono
    assert k1.record(args, dict(form="slab"), res) is None
    big = (None, torch.zeros(2048, 32), x, 1.0, 100, 5)
    assert k1.record(big, {}, res)["L"] == 2048


def test_discovery_by_file_name():
    """Every cell, configuration and metric of BENCHMARK.json has its file,
    found by its name; every roofline module is found."""
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c["config_file"]["system"]
        assert spec.system(c["config_file"]["system"]).System
        assert "batch" in c["traffic_file"]
        assert set(c["check_file"]["limits"]) or c["check_file"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    assert {"k1", "k2"} <= set(spec.rooflines())
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (spec.ROOT / c["file"]).exists()
    assert names == {w["config"] for w in bench["workloads"]}


def test_metrics_for_a_cell():
    bench = spec.benchmark()
    cell = bench["workloads"][0]["name"]
    e2e = {m["name"] for m in spec.metrics_for(cell, bench, False)}
    assert e2e == {m["name"] for m in bench["end_to_end"]}
    per = {m["name"] for m in spec.metrics_for(cell, bench, True)}
    assert per and per <= {m["name"] for m in bench["per_layer"]}
    fake = {"end_to_end": [], "per_layer": [
        {"name": "a", "workloads": ["x"]}, {"name": "b"}]}
    assert [m["name"] for m in spec.metrics_for("y", fake, True)] == ["b"]


def test_comparison_numbers_on_made_up_frames():
    """Four concatenated frames: one flips its outcome, one verifies a
    codeword fewer than the reference; the limits judge each number."""
    import numpy as np

    from benchmark.reference import compare

    sent = np.zeros((4, 8), np.uint8)
    bits = sent.copy()
    bits[0, :2] = 1                                # 2 errors, ref 2
    bits[1, 0] = 1                                 # 1 error, ref 0
    ref = dict(sent=sent, bit_errors=np.array([2, 0, 0, 0]),
               iters=np.array([20, 20, 20, 20]), bp_ok=np.array([3, 3, 2, 3]))
    prog = dict(bits=bits, iters=np.array([20, 21, 20, 19]),
                bp_ok=np.array([3, 2, 2, 3]))
    v = compare.numbers(prog, ref)
    assert v["frame_flips"] == 0.25
    assert v["bit_error_l1"] == 0.5
    assert v["iters_gap"] == 0.0
    assert v["bit_error_gap"] == 0.5
    assert v["bit_error_capped_gap"] == 0.5
    assert v["bp_ok_gap"] == 1 / 11
    assert "tau2_gap" not in v
    assert compare.verdict(v, {"bp_ok_gap": 0.1, "frame_flips": 0.3})
    assert not compare.verdict(v, {"bp_ok_gap": 0.05})


def test_a_frame_that_fails_outright_moves_the_capped_gap_little():
    import numpy as np

    from benchmark.reference import compare

    it = np.array([20, 20, 20, 20])
    ref = dict(bit_errors=np.array([2, 27, 30, 1490]), iters=it)
    prog = dict(bit_errors=np.array([2, 27, 31, 700]), iters=it)
    v = compare.numbers(prog, ref)
    assert v["bit_error_gap"] == 789 / 1549
    assert v["bit_error_capped_gap"] == 1 / (59 + compare.CAP)
