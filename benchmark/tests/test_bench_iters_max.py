"""amp_iters_max_mean, the reader of the program's `amp.iters_max` and
`amp.calls` counters: the mean over the calls of each call's slowest
codeword, and nothing (no raise) where the program records neither, as a
tree before the counters does; read in a traced run of a small cell."""

import types

import pytest
import torch

from benchmark.harness import spec
from benchmark.tests.test_bench_tracing import traced_run
from benchmark.tests.tiny import write_tiny
from sparc_ldpc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def read(run=None):
    run = run or types.SimpleNamespace(blocks=[dict(trials=4)],
                                       timeline=None, devices=[0])
    return spec.reader("amp_iters_max_mean").read(run)


def test_mean_of_each_calls_slowest_codeword():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("amp.iters_max", torch.tensor([32], dtype=torch.int32))
        profiling.count("amp.iters_max", torch.tensor(27, dtype=torch.int32))
        profiling.count("amp.calls", 1)
        profiling.count("amp.calls", 1)
    assert read() == pytest.approx(29.5)


def test_nothing_without_the_counters(monkeypatch):
    assert read() is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("bp.iters", 3)
    assert read() is None
    # a program whose registry lacks the readers
    monkeypatch.delattr(profiling, "counters")
    assert read() is None


def test_a_traced_run_reports_it(tmp_path, monkeypatch):
    d = write_tiny(tmp_path / "tiny", 6.0)
    monkeypatch.setattr(spec, "ROOT", d)
    monkeypatch.setattr(spec, "BENCH_DIR", d)
    res = traced_run("tiny_concat.t16")
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # both AMP passes count: the first (cap 32) and the pinned one (8)
    assert 8 <= m["amp_iters_max_mean"] <= 32
    assert m["amp_iters_max_mean"] >= m["amp_iters_mean"] / 2
