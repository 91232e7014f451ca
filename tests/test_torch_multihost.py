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
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

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


# ------------------------------------- a section axis across processes

# One BLAS thread, and MKL's conditional numerical reproducibility: on the
# CPU, MKL's float32 products otherwise round by the alignment of their
# buffers, which differ between one process and two (K3 on the card is a
# kernel of its own and does not depend on them).
WORKER_ENV = dict(OMP_NUM_THREADS="1")


def _env(rank, world, port, spec):
    env = dict(os.environ, SPARC_TORCH_TEST_SPEC=json.dumps(spec),
               **WORKER_ENV)
    if world > 1:
        env.update(RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return env


def _spawn(world, spec, timeout=180):
    """`world` processes running _worker(spec) (world 1: one process
    without torch.distributed); their exit codes checked."""
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {str(REPO / 'tests')!r}); "
            f"import test_torch_multihost as m; m._worker()")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO,
        env=_env(r, world, port, spec), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    return outs


def _policy(spec):
    """The ShardingPolicy a worker runs under: a mesh of spec["local"]
    = (D, S_local) copies of the CPU; with several processes, their
    section groups of spec["section_procs"] consecutive ranks over gloo."""
    import torch.distributed as dist

    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    D, s_local = spec["local"]
    mesh = make_mesh(s_local, ["cpu"] * (D * s_local))
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo", init_method="env://")
    return ShardingPolicy.for_process(mesh, spec.get("section_procs", 1),
                                      "gloo")


def _worker():
    """One process of a test below (its spec in SPARC_TORCH_TEST_SPEC):
    "hypercube" runs the cross-process H_S on this rank's slabs of seeded
    random slabs; "decode" draws a block of a small SPARC, decodes this
    process's rows (encode and decode on the sharded transforms) and sums
    its counters over the data groups.  The results go to
    <out>/rank<r>.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = json.loads(os.environ["SPARC_TORCH_TEST_SPEC"])
    policy = _policy(spec)
    res = {}
    if spec["mode"] == "hypercube":
        from sparc_ldpc_tpu_torch.parallel.dist_fwht import hypercube

        S = spec["S"]
        full = torch.from_numpy(np.random.default_rng(spec["seed"])
                                .standard_normal((S, 3, 4, 8))
                                .astype(np.float32))
        k = policy.mesh.shape[1]
        q = policy.section_rank
        res["out"] = torch.stack(hypercube(list(full[q * k:(q + 1) * k]),
                                           policy))
    else:
        from sparc_ldpc_tpu_torch.config import SparcConfig
        from sparc_ldpc_tpu_torch.models.sparc import SparcModel
        from sparc_ldpc_tpu_torch.utils.rng import block_generator

        cfg = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard",
                          amp_iters=6, amp_tol=0.0, **spec["cfg"])
        model = SparcModel.build(cfg, 4.0, None, policy=policy)
        B = spec["batch"]
        gen = block_generator(5, 0, 0, "cpu")
        bits = torch.randint(0, 2, (B, cfg.k_bits), generator=gen,
                             dtype=torch.int32)
        noise = torch.randn((B, cfg.n), generator=gen)
        bits, noise = policy.own_rows(bits, noise)
        r = model.decode(model.encode(bits)
                         + noise * float(model.sigma2) ** 0.5)
        res.update(beta=r.beta, trace=r.tau2_trace, iters=r.iters)
        out = model.run_block(block_generator(5, 0, 1, "cpu"), B)
        keys = sorted(k for k in out if k != "tau2_final")
        vals = torch.stack([out[k].to(torch.float64) for k in keys])
        res["counters"] = dict(zip(keys, policy.all_reduce(vals).tolist()))
        rows = policy.process_rows(B)
        res["rows"] = (rows.start, rows.stop)
    torch.save(res, os.path.join(spec["out"], f"rank{policy.rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("world,local,S", [(2, 1, 2), (2, 2, 4), (4, 1, 4),
                                           (4, 1, 2)])
def test_cross_process_hypercube_matches_in_process(tmp_path, world, local,
                                                    S):
    """hypercube across the processes of a section group (stage `bit`
    exchanges with rank r ^ bit of the group, both directions posted
    together) gives the in-process H_S of the same slabs bit for bit;
    two section groups (world 4, S = 2) exchange within their own."""
    import numpy as np
    import torch

    from sparc_ldpc_tpu_torch.parallel.dist_fwht import hypercube

    G = S // local
    spec = dict(mode="hypercube", S=S, seed=11, local=[1, local],
                section_procs=G, out=str(tmp_path))
    _spawn(world, spec)
    full = torch.from_numpy(np.random.default_rng(11)
                            .standard_normal((S, 3, 4, 8))
                            .astype(np.float32))
    want = torch.stack(hypercube(list(full)))
    for group in range(world // G):
        got = torch.cat([torch.load(tmp_path / f"rank{group * G + q}.pt")
                         ["out"] for q in range(G)])
        assert torch.equal(got, want)


def _decode_case(tmp_path, world, local, section_procs, cfg, batch=8):
    """The decode worker in `world` processes against one process on a
    virtual mesh of the same global (D, S) shape: every rank's beta,
    trace and iterations are the one process's rows bit for bit, and the
    counters summed over the data groups are its counters."""
    import torch

    D, s_local = local
    S = s_local * section_procs
    groups = world // section_procs
    one = tmp_path / "one"
    one.mkdir()
    _spawn(1, dict(mode="decode", local=[D * groups, S], cfg=cfg,
                   batch=batch, out=str(one)))
    want = torch.load(one / "rank0.pt")
    many = tmp_path / "many"
    many.mkdir()
    _spawn(world, dict(mode="decode", local=list(local), cfg=cfg,
                       batch=batch, section_procs=section_procs,
                       out=str(many)))
    for rank in range(world):
        got = torch.load(many / f"rank{rank}.pt")
        g = rank // section_procs
        assert got["rows"] == (g * batch // groups, (g + 1) * batch // groups)
        rows = slice(*got["rows"])
        assert torch.equal(got["beta"], want["beta"][rows])
        assert torch.equal(got["trace"], want["trace"][:, rows])
        assert torch.equal(got["iters"], want["iters"][rows])
        assert got["counters"] == want["counters"]
    assert want["counters"]["trials"] == batch


FUSED = dict(amp_kernel="fused_split", transform_precision="bf16")
SCAN = dict(amp_kernel="xla", fwht_dist="collective",
            transform_precision="highest")


def test_two_processes_one_section_axis_fused_route(tmp_path):
    """S = 2 across two processes on the fused sharded route (K3's plain
    version, the cross-process hypercube, the denoiser, the norms summed
    over the group in shard order, beta gathered) equals one process with
    S = 2 on a virtual mesh: counters and beta bit for bit."""
    _decode_case(tmp_path, 2, (1, 1), 2, FUSED)


def test_two_processes_one_section_axis_scan_route(tmp_path):
    """The same on the scan route with fwht_dist="collective" (dist_fwht
    across the processes)."""
    _decode_case(tmp_path, 2, (1, 1), 2, SCAN)


def test_four_processes_as_two_by_two_match_one_process(tmp_path):
    """Four processes as a (2 x 2) mesh (two data groups of two ranks, one
    slab a rank), as the reference's
    test_four_process_two_device_counters_match_single: every rank's rows
    and the counters equal one process on a virtual (2 x 2) mesh."""
    _decode_case(tmp_path, 4, (1, 1), 2, FUSED)


def _cli_argv(out, *extra):
    return ["campaign", "--preset", "plain_small", "--cpu", "--ebno", "4.0",
            "--batch", "4", "--max-trials", "8", "--amp-iters", "8",
            "--out", str(out), *extra]


def test_cli_refuses_nccl_on_the_cpu(tmp_path):
    """--dist-backend nccl needs the GPUs: with --cpu the CLI refuses it."""
    with pytest.raises(SystemExit, match="nccl needs the GPUs"):
        tcli.main(_cli_argv(tmp_path / "a.jsonl", "--dist-backend", "nccl"))
