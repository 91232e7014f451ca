"""Two processes of the port's campaign CLI with `--distributed`, joined by
torch.distributed over gloo on localhost, on the CPU: their records equal
one process's (the counters of every block are summed over the ranks, and
the draws do not depend on the number of processes), and only rank 0
writes the record and the journal.

The processes get the environment `python -m torch.distributed.run` would
give them (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT); each has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from sparc_ldpc_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parents[1]
KEYS = ("ber", "fer", "trials", "bit_errors", "bit_errors_sq",
        "frame_errors", "mean_iters", "blocks", "exec_blocks",
        "config_hash")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _argv(out, section_shards):
    return ["campaign", "--preset", "plain_small", "--cpu", "--ebno", "4.0",
            "--batch", "4", "--max-trials", "8", "--amp-iters", "8",
            "--section-shards", section_shards, "--out", str(out)]


@pytest.mark.parametrize("section_shards", ["1", "2"])
def test_two_process_records_match_one_process(tmp_path, section_shards):
    one = tmp_path / "one.jsonl"
    assert tcli.main(_argv(one, "1")) == 0
    want = json.loads(one.read_text().splitlines()[-1])

    two = tmp_path / "two.jsonl"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sparc_ldpc_tpu_torch.cli",
             *_argv(two, section_shards), "--distributed"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    assert "campaign:" in outs[0][0] and "campaign:" not in outs[1][0]
    recs = [json.loads(x) for x in two.read_text().splitlines()]
    assert len(recs) == 1                       # rank 0 alone writes
    got = recs[0]
    assert got["processes"] == 2
    assert got["mesh"] == [1, int(section_shards)]
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    journal = (tmp_path / "two.jsonl.journal").read_text().splitlines()
    assert len(journal) == got["exec_blocks"] == got["blocks"]
