"""The command's refusals: no card, too few cards, a checkout that holds
only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent


def command(cwd: Path, cell: str, env=None):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload", cell,
         "--seed", "2147483650", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))


def first_cell():
    return json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]


def assert_refused(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        assert '"metrics"' not in line


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no metrics."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: test_hidden_cards_no_result covers "
                    "this there")
    assert_refused(command(ROOT, first_cell()))


@pytest.mark.cuda
def test_hidden_cards_no_result():
    """On a card machine, with every card hidden, the command exits
    non-zero and prints no metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert_refused(command(ROOT, first_cell(),
                           env={"CUDA_VISIBLE_DEVICES": ""}))


def test_only_the_benchmark_no_result(tmp_path):
    """A directory with BENCHMARK.json and the files under paths alone:
    exit non-zero, no result."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in bench["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    assert_refused(command(tmp_path, first_cell()))
