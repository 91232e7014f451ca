"""The port's CLI (sparc_ldpc_tpu_torch.cli) on the CPU: `se` prints what
the reference's prints, a tiny `campaign --cpu` writes a record with the
reference's keys plus backend and device, and what the port cannot run
exits with a message that names the ROADMAP item.
"""

import json

import pytest

from sparc_ldpc_tpu import cli as jcli

from sparc_ldpc_tpu_torch import cli as tcli


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
    (["--preset", "fast_l4096"], "K1 (f)"),
    (["--preset", "fast_l4096"], "K6"),
    (["--preset", "concat", "--section-shards", "2"], "A10"),
    (["--preset", "concat", "--distributed"], "A10"),
    (["--preset", "campaign"], "not a code configuration"),
])
def test_unported_requests_exit_with_their_message(argv, needle):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["campaign", *argv])
    assert needle in str(exc.value)


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
