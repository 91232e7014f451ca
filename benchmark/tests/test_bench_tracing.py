"""The readers of the program's spans and counters (launch_ms,
dp_shard_wait_ms, dp_gather_gb, amp_feedback_iters_mean, bp_iters_mean):
on a made-up timeline and registry, on a program without a registry (they
read nothing and raise nothing), and on traced runs of the small cells of
benchmark/tests/tiny.py on the CPU."""

import io
import json
import types
from contextlib import redirect_stdout

import pytest
import torch

import benchmark.run as run
from benchmark.harness import spec
from benchmark.harness.timeline import WINDOW, Timeline
from benchmark.tests.tiny import write_tiny
from sparc_ldpc_tpu_torch.utils import profiling

NEW = ("launch_ms", "dp_shard_wait_ms", "dp_gather_gb",
       "amp_feedback_iters_mean", "bp_iters_mean")
SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def run_of(**kw):
    base = dict(blocks=[], timeline=None, devices=[0], log=lambda m: None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, run_):
    return spec.reader(name).read(run_)


def test_launch_ms_from_a_made_up_timeline():
    """Two launches of 3 and 5 us inside the window, one outside."""
    ev = [dict(ph="X", cat="user_annotation", name=WINDOW, ts=1000, dur=100,
               tid=1),
          dict(ph="X", cat="user_annotation", name="campaign.launch",
               ts=1010, dur=3, tid=1),
          dict(ph="X", cat="user_annotation", name="campaign.launch",
               ts=1050, dur=5, tid=1),
          dict(ph="X", cat="user_annotation", name="campaign.launch",
               ts=900, dur=50, tid=1),
          dict(ph="X", cat="cpu_op", name="aten::add", ts=1060, dur=9,
               tid=1)]
    tl = Timeline(ev)
    assert read("launch_ms", run_of(timeline=tl)) == pytest.approx(4e-3)
    assert read("launch_ms", run_of()) is None
    assert read("launch_ms", run_of(timeline=Timeline(ev[:1]))) is None


def test_counter_readers_from_a_made_up_registry():
    """Counts made under a profiler: 2 blocks of 4 frames, 36 feedback
    iterations, 30 BP iterations of 12 codewords, 3e9 gathered bytes, two
    input waits of known length on the CPU's clock."""
    blocks = [dict(trials=4), dict(trials=4)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("concat.feedback_iters", torch.tensor([8, 8, 2]))
        profiling.count("concat.feedback_iters", 18)
        profiling.count("bp.iters", torch.full((12,), 2, dtype=torch.int32))
        profiling.count("bp.iters", 6)
        profiling.count("bp.codewords", 12)
        profiling.count("mesh.gather_bytes", 1_000_000_000)
        profiling.count("mesh.gather_bytes", 2_000_000_000)
        for _ in range(2):
            with profiling.interval("mesh.shard_inputs", "cpu"):
                pass
    r = run_of(blocks=blocks)
    assert read("amp_feedback_iters_mean", r) == 36 / 8
    assert read("bp_iters_mean", r) == 30 / 12
    assert read("dp_gather_gb", r) == 1.5
    waits = [ms for ms, _ in profiling.intervals_ms("mesh.shard_inputs")]
    assert read("dp_shard_wait_ms", r) == pytest.approx(sum(waits) / 2)
    profiling.reset()
    for name in NEW:
        assert read(name, r) is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    """A tree before the registry (its profiling module lacks the readers):
    every new reader returns None and raises nothing."""
    for attr in ("counters", "intervals_ms"):
        monkeypatch.delattr(profiling, attr)
    r = run_of(blocks=[dict(trials=4)], timeline=Timeline([
        dict(ph="X", cat="user_annotation", name=WINDOW, ts=0, dur=10,
             tid=1)]))
    for name in NEW:
        assert read(name, r) is None


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    d = write_tiny(tmp_path / "tiny", 6.0)
    monkeypatch.setattr(spec, "ROOT", d)
    monkeypatch.setattr(spec, "BENCH_DIR", d)
    return d


def traced_run(cell):
    devices = ["cpu", "cpu"] if cell.endswith("dp16") else ["cpu"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.3", "--trace", "1"], devices=devices)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell,present", [
    ("tiny_sparc.t16", {"launch_ms"}),
    ("tiny_concat.t16", {"launch_ms", "amp_feedback_iters_mean",
                         "bp_iters_mean"}),
    ("tiny_sparc.dp16", {"launch_ms", "dp_shard_wait_ms", "dp_gather_gb"}),
])
def test_traced_tiny_runs_report_the_new_metrics(tiny, cell, present):
    res = traced_run(cell)
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {k for k in NEW if k in m} == present
    assert m["launch_ms"] > 0
    if "amp_feedback_iters_mean" in m:
        assert 0 < m["amp_feedback_iters_mean"] <= 8      # feedback_iters
        assert 0 < m["bp_iters_mean"] <= 32               # bp_iters
    if "dp_gather_gb" in m:
        # 8 of 16 codewords' float32 beta (64 x 64), their trace (T x 8
        # float32) and iterations (8 int32)
        extra = round(m["dp_gather_gb"] * 1e9) - 8 * 64 * 64 * 4 - 8 * 4
        assert extra > 0 and extra % 32 == 0
        assert m["dp_shard_wait_ms"] >= 0
