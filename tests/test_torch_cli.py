"""The port's CLI (sparc_ldpc_tpu_torch.cli) on the CPU: `se` prints what
the reference's prints, a tiny `campaign --cpu` writes a record with the
reference's keys plus backend and device, `fast_l4096` (amp_kernel
"fused" at L=4096) runs as shipped, every operator and AMP route reaches
the campaign, and what the port cannot run exits with a message that
names the ROADMAP item.
"""

import json

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

from sparc_ldpc_tpu import cli as jcli

from sparc_ldpc_tpu_torch import cli as tcli
from sparc_ldpc_tpu_torch.config import PRESETS
from sparc_ldpc_tpu_torch.utils.provenance import config_hash


@pytest.mark.parametrize("preset,ebno", [("plain_small", 2.0),
                                         ("concat", 3.0)])
def test_se_prints_the_reference_report(capsys, preset, ebno):
    argv = ["se", "--preset", preset, "--ebno", str(ebno)]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(argv) == 0
    assert json.loads(capsys.readouterr().out) == want


# the keys of a reference point record (sparc_ldpc_tpu/parallel/campaign.py
# and utils/provenance.py), commit aside (absent outside a checkout)
REF_KEYS = {"kind", "ebno_db", "ber", "fer", "trials", "bit_errors",
            "bit_errors_sq", "frame_errors", "mean_iters", "wall_s",
            "first_block_s", "bits_per_s", "blocks", "exec_blocks",
            "preset", "config_hash"}


def test_campaign_cpu_writes_a_self_identifying_record(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    argv = ["campaign", "--preset", "plain_small", "--cpu", "--ebno", "6.0",
            "--batch", "2", "--max-trials", "4", "--out", str(out)]
    assert tcli.main(argv) == 0
    assert "device=cpu" in capsys.readouterr().out
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 1
    rec = recs[0]
    assert REF_KEYS <= set(rec)
    assert rec["backend"] == "torch-cpu" and rec["device"] == "cpu"
    assert rec["preset"] == "plain_small" and rec["trials"] == 6
    journal = (tmp_path / "r.jsonl.journal").read_text().splitlines()
    assert len(journal) == rec["exec_blocks"] == rec["blocks"] == 3
    # a rerun replays the journal: the same counters, no new work
    assert tcli.main(argv) == 0
    rerun = json.loads(out.read_text().splitlines()[-1])
    assert rerun["exec_blocks"] == 0 and rerun["trials"] == rec["trials"]


def test_fused_rewrites_the_config_with_the_reference_message(tmp_path,
                                                               capsys):
    argv = ["campaign", "--preset", "plain_small", "--cpu", "--fused",
            "--ebno", "7.0", "--batch", "2", "--max-trials", "2",
            "--amp-iters", "6"]
    assert tcli.main(argv) == 0
    assert "--fused: fixed-T route replaces the preset's adaptive " \
        "amp_tol=1e-06 with 0.0" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["--preset", "fast_l4096", "--section-shards", "4"],
     "needs --distributed"),
    (["--preset", "fast_l4096", "--distributed", "--section-shards", "2"],
     "torch.distributed.run"),
    (["--preset", "concat", "--section-shards", "2"], "needs --distributed"),
    (["--preset", "concat", "--distributed", "--section-shards", "4"],
     "torch.distributed.run"),
    (["--preset", "campaign"], "not a code configuration"),
])
def test_unported_requests_exit_with_their_message(argv, needle,
                                                   monkeypatch):
    """On one GPU (stood in for here) a section axis wider than the
    process's GPUs crosses processes: without --distributed the CLI exits
    saying so, and with it but without torch.distributed.run's
    environment it exits asking for that; the cross-process campaign
    itself runs in tests/test_torch_multihost.py."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["campaign", *argv])
    assert needle in str(exc.value)


def test_nccl_between_processes_of_one_gpu_exits(monkeypatch):
    """Two processes of one GPU (stood in for here) with the section axis
    across them: NCCL refuses two ranks of one GPU, so the CLI exits with
    its message before any process group; --dist-backend gloo passes that
    check (and then asks for torch.distributed.run's environment)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    argv = ["campaign", "--preset", "fast_l4096", "--distributed",
            "--section-shards", "2"]
    with pytest.raises(SystemExit, match="NCCL refuses two ranks of one GPU"):
        tcli.main(argv)
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        tcli.main(argv + ["--dist-backend", "gloo"])


def test_section_axis_that_neither_divides_nor_spans_the_gpus_exits(
        monkeypatch):
    """Three GPUs (stood in for here) and --section-shards 2: the axis
    neither fits the process's GPUs nor spans whole processes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="one must divide the other"):
        tcli.main(["campaign", "--preset", "fast_l4096", "--section-shards",
                   "2"])


@pytest.mark.parametrize("preset,kernel", [
    ("fast_l4096", "fused"), ("fast_l4096", "fused_split"),
    ("pa_l1024", "fused"), ("pa_l1024", "fused_split")])
def test_fused_routes_are_not_refused(preset, kernel, monkeypatch):
    """Every AMP route runs at any L up to 4096: "fused" (mono at
    L <= 1024, split above), "fused_split" and "fused_slab"; so do the
    column-signed and the DCT operators (once refused, ROADMAP A2 and
    A3).  Each config, put in place of a preset, reaches the campaign
    through `campaign --cpu` unchanged (the campaign itself is stood in
    for here)."""
    reached = []
    monkeypatch.setattr(tcli, "_run_campaign",
                        lambda args, cfg, ccfg, mesh, *section:
                        reached.append(cfg))

    def runs(cfg):
        monkeypatch.setitem(PRESETS, "under_test", cfg)
        reached.clear()
        assert tcli.main(["campaign", "--preset", "under_test",
                          "--cpu"]) == 0
        return reached == [cfg]

    cfg = PRESETS[preset].replace(amp_kernel=kernel)
    assert runs(cfg)
    assert runs(cfg.replace(amp_kernel="fused_slab"))
    concat = PRESETS["concat"]
    assert runs(concat.replace(
        sparc=concat.sparc.replace(amp_kernel="fused_slab")))
    assert runs(cfg.replace(col_signs=True))
    assert runs(cfg.replace(op_kind="dct"))
    assert runs(concat.replace(sparc=concat.sparc.replace(col_signs=True)))


@pytest.mark.parametrize("extra,kernel,tol", [
    ([], "fused", 1e-4), (["--fused"], "fused_split", 0.0)])
def test_fast_l4096_campaign_runs_as_shipped(tmp_path, capsys, extra,
                                             kernel, tol):
    """`campaign --preset fast_l4096` as shipped (the split form at
    L=4096 with its in-kernel noise; here the plain version), and with
    --fused, fused_split at fixed T as in the reference; two AMP
    iterations keep it short."""
    out = tmp_path / "r.jsonl"
    argv = ["campaign", "--preset", "fast_l4096", "--cpu", "--ebno", "6.5",
            "--batch", "1", "--max-trials", "1", "--amp-iters", "2",
            "--out", str(out), *extra]
    assert tcli.main(argv) == 0
    said = capsys.readouterr().out
    assert ("--fused: fixed-T route replaces the preset's adaptive "
            "amp_tol=0.0001 with 0.0" in said) == bool(extra)
    rec = json.loads(out.read_text().splitlines()[-1])
    want = PRESETS["fast_l4096"].replace(amp_kernel=kernel, amp_tol=tol,
                                         amp_iters=2)
    assert rec["config_hash"] == config_hash(want)
    # the pipelined campaign may run one block past the budget
    assert rec["trials"] in (1, 2) and rec["preset"] == "fast_l4096"
    assert 0 <= rec["ber"] <= 1 and rec["mean_iters"] <= 2


def test_plot_without_matplotlib_says_so(tmp_path, capsys, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    path = tmp_path / "r.jsonl"
    path.write_text(json.dumps(dict(kind="point", ebno_db=1.0, ber=0.1,
                                    fer=0.5)) + "\n")
    assert tcli.main(["plot", str(path)]) == 1
    assert "matplotlib not available" in capsys.readouterr().err
