"""The port's BER/FER legs (check 2 of the North star: same statistics).

`sparc_ldpc_tpu_torch/tools/ber_legs.py` decodes the points of the
reference's `scripts/ber_parity.py` GRIDS on the H100 and writes
`results/ber_parity_torch_<preset>.jsonl`.  These tests read those files
beside the reference's `results/ber_parity_<preset>.jsonl` and recompute
nothing, with the script's own `ci_ber` and `REL_FLOOR`:

  1. every point has its `torch` leg: >= 10 000 trials, the tool's seeds,
     run on an NVIDIA card through the hand-written kernels, at a commit;
  2. torch against the float64 oracle: the joint 95 % bound, floored at
     REL_FLOOR (default 1 %) of the larger BER, as tests/test_ber_parity.py;
  3. torch against the reference's own `tpu` leg: both bf16 or float32
     decodes of the same chain, so the floor is 2 %, as run_check holds
     its float32 control against the `tpu` leg;
  4. torch_noisek (K1's Philox noise) against the oracle, NOISEK_PRESETS;
  5. torch_control_f32 (the float32 scan route, no hand-written kernel)
     against torch, the REL_FLOOR presets, 2 % floor.

A missing leg fails.  The tool's own tests run on the CPU: its copied
constants and its kinds' configs equal the script's, a leg at a small
size writes a well-formed record and resumes, and `check` tells OK from
APART.
"""

import dataclasses
import json
import math
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import ber_parity as bp  # noqa: E402
from sparc_ldpc_tpu.config import PRESETS as JPRESETS  # noqa: E402
from sparc_ldpc_tpu.utils.provenance import (  # noqa: E402
    config_hash as jconfig_hash)

from sparc_ldpc_tpu_torch.tools import ber_legs as bl  # noqa: E402
from sparc_ldpc_tpu_torch.utils.provenance import config_hash  # noqa: E402

POINTS = [(p, e) for p in bp.GRIDS for e in bp.GRIDS[p]]
POINT_IDS = [f"{p}-{e}dB" for p, e in POINTS]
NOISEK_POINTS = [(p, e) for p in bp.NOISEK_PRESETS for e in bp.GRIDS[p]]
CONTROL_POINTS = [(p, e) for p in sorted(bp.REL_FLOOR)
                  for e in bp.GRIDS[p]]
SAME_PRECISION_FLOOR = 0.02
# every field of the reference's `tpu` records that a port leg carries
LEG_FIELDS = {"kind", "ebno_db", "trials", "bit_errors", "bit_errors_sq",
              "frame_errors", "k_bits", "L", "ber", "fer", "wall_s",
              "warmup_s", "bits_per_s", "kernel", "noise_in_kernel",
              "amp_iters", "seed_base", "allow_tf32", "preset",
              "config_hash", "backend", "device", "torch", "commit", "card",
              "launches"}


def _ids(points):
    return [f"{p}-{e}dB" for p, e in points]


def _leg(preset, kind, ebno, results=bl.RESULTS):
    """The last port record of `kind` at `ebno` (None if missing)."""
    return bl.last_leg(bl.load_records(bl.out_path(results, preset)), kind,
                       ebno)


def _ref(preset, kind, ebno):
    """The last reference record of `kind` at `ebno` (None if missing)."""
    return bl.last_leg(bp.load_records(preset), kind, ebno)


def _assert_within(a, b, rel, what):
    gap = abs(a["ber"] - b["ber"])
    bound = max(math.hypot(bp.ci_ber(a), bp.ci_ber(b)),
                rel * max(a["ber"], b["ber"]))
    assert gap <= bound, (
        f"{what}: BER {a['ber']:.4e} vs {b['ber']:.4e}, |gap| {gap:.3e} > "
        f"joint 95% {bound:.3e}")


# ------------------------------------------------- the tool, on the CPU

def test_copied_constants_equal_the_script():
    assert bl.GRIDS == bp.GRIDS
    assert bl.ORACLE_TRIALS_FLOOR == bp.ORACLE_TRIALS_FLOOR
    assert bl.REL_FLOOR == bp.REL_FLOOR
    assert tuple(bl.NOISEK_PRESETS) == tuple(bp.NOISEK_PRESETS)
    assert sorted(bl.CONCAT_PRESETS) == sorted(bp.CONCAT_PRESETS)


@pytest.mark.parametrize("preset", sorted(bp.CONCAT_PRESETS))
def test_concat_presets_have_the_scripts_repr_and_hash(preset):
    mine, ref = bl.CONCAT_PRESETS[preset], bp.CONCAT_PRESETS[preset]
    assert repr(mine) == repr(ref)
    assert config_hash(mine) == jconfig_hash(ref)


def _script_config(preset, kind):
    """The config each leg of the reference decodes, built as its code
    builds it: run_tpu (scripts/ber_parity.py:355), run_tpu_concat (:301)
    and concat_f32_control.py:35-40."""
    r = dataclasses.replace
    if kind == "torch_control_f32":
        cfg = bp.CONCAT_PRESETS[preset]
        return r(cfg, sparc=r(cfg.sparc, amp_kernel="xla", amp_tol=0.0,
                              transform_precision="highest"),
                 ldpc=r(cfg.ldpc, engine="qc_xla"))
    if preset in bp.CONCAT_PRESETS:
        cfg = bp.CONCAT_PRESETS[preset]
        return r(cfg, sparc=r(cfg.sparc, amp_kernel="fused_split",
                              amp_tol=0.0, transform_precision="bf16",
                              amp_noise_in_kernel=True))
    if preset == "fast_l4096":
        return JPRESETS[preset]
    return r(JPRESETS[preset], amp_kernel="fused_split", amp_tol=0.0,
             transform_precision="bf16",
             amp_noise_in_kernel=kind == "torch_noisek")


LEGS = [(p, k) for p in bp.GRIDS for k in bl.leg_kinds(p)]


@pytest.mark.parametrize("preset,kind", LEGS,
                         ids=[f"{p}-{k}" for p, k in LEGS])
def test_kind_overrides_equal_the_scripts(preset, kind):
    mine, want = bl.leg_config(preset, kind), _script_config(preset, kind)
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert repr(mine) == repr(want)
    assert config_hash(mine) == jconfig_hash(want)


def test_leg_kinds_and_batches_are_the_scripts():
    assert set(LEGS) == (
        {(p, "torch") for p in bp.GRIDS}
        | {(p, "torch_noisek") for p in bp.NOISEK_PRESETS}
        | {(p, "torch_control_f32") for p in bp.REL_FLOOR})
    assert bl.leg_batch("fast_l4096", 512) == 256       # the script's :373
    assert bl.leg_batch("pa_l1024", 512) == 512
    with pytest.raises(ValueError):
        bl.leg_config("fast_l4096", "torch_noisek")


def test_legs_on_the_cpu_write_a_record_and_resume(tmp_path, capsys):
    argv = ["legs", "--device", "cpu", "--preset", "plain_small", "--kind",
            "torch", "--ebno", "2.0", "--trials", "16", "--batch", "8",
            "--out-dir", str(tmp_path)]
    assert bl.main(argv) == 0
    path = tmp_path / "ber_parity_torch_plain_small.jsonl"
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(recs) == 1
    rec = recs[0]
    assert LEG_FIELDS <= set(rec)
    assert rec["kind"] == "torch" and rec["ebno_db"] == 2.0
    assert rec["trials"] == 16 and rec["k_bits"] == 2304 and rec["L"] == 256
    for key in ("bit_errors", "frame_errors", "section_errors", "trials"):
        assert isinstance(rec[key], int), key
    assert rec["ber"] == rec["bit_errors"] / (16 * 2304)
    assert rec["fer"] == rec["frame_errors"] / 16
    assert rec["bit_errors_sq"] >= rec["bit_errors"] ** 2 / 16
    assert rec["seed_base"] == bl.SEED_BASE and rec["device"] == "cpu"
    assert rec["kernel"] == "fused_split" and rec["amp_iters"] == 32
    assert rec["launches"] == {}             # the CPU runs the plain versions
    capsys.readouterr()
    # a second call finds the point done at this commit
    assert bl.main(argv) == 0
    assert "already done" in capsys.readouterr().out
    assert len(path.read_text().splitlines()) == 1


def _hand_made(tmp_path, torch_ber):
    """A port file and a reference file for concat_full at 3.0 dB with
    oracle, tpu, torch and control legs at 10 240 trials; the torch leg at
    BER torch_ber, the others at 1.6e-3 (frames of 0 or 15 bit errors)."""
    k, tr = 8490, 10240

    def leg(kind, ber):
        be = round(ber * tr * k)
        return dict(kind=kind, ebno_db=3.0, trials=tr, k_bits=k,
                    bit_errors=be, bit_errors_sq=15.0 * be, ber=be / (tr * k),
                    wall_s=1.0, bits_per_s=tr * k / 1.0)

    mine, ref = tmp_path / "mine", tmp_path / "ref"
    for d, legs in ((mine, [leg("torch", torch_ber),
                            leg("torch_control_f32", torch_ber)]),
                    (ref, [leg("oracle", 1.6e-3), leg("tpu", 1.6e-3)])):
        d.mkdir()
        name = "ber_parity_torch_%s.jsonl" if d == mine else \
            "ber_parity_%s.jsonl"
        (d / (name % "concat_full")).write_text(
            "".join(json.dumps(x) + "\n" for x in legs))
    return str(mine), str(ref)


@pytest.mark.parametrize("torch_ber,verdict", [(1.62e-3, "OK"),
                                               (2.4e-3, "APART")])
def test_check_tells_ok_from_apart(tmp_path, capsys, torch_ber, verdict):
    mine, ref = _hand_made(tmp_path, torch_ber)
    ok = bl.check(["concat_full"], mine, ref)
    out = capsys.readouterr().out
    assert ok == (verdict == "OK")
    assert "torch vs oracle" in out and f"-> {verdict}" in out
    assert "torch_control_f32 vs torch" in out
    # the markdown form: the same verdicts, one row for the point
    assert bl.check(["concat_full"], mine, ref, markdown=True) == ok
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 3 and rows[2].startswith("| concat_full | 3.0 |")
    cells = [c.strip() for c in rows[2].strip("|").split("|")]
    want = "OK" if verdict == "OK" else "**APART**"
    # torch vs oracle, torch vs tpu, (no noisek leg), control vs torch
    assert cells[7:11] == [want, want, "—", "OK"]
    os.remove(os.path.join(mine, "ber_parity_torch_concat_full.jsonl"))
    assert not bl.check(["concat_full"], mine, ref)
    assert "MISSING" in capsys.readouterr().out


# ------------------------------------------------- the committed legs

@pytest.mark.parametrize("preset,ebno", POINTS, ids=POINT_IDS)
def test_torch_leg_recorded(preset, ebno):
    t = _leg(preset, "torch", ebno)
    assert t is not None, (
        f"{preset} @ {ebno}: torch leg missing — python -m "
        f"sparc_ldpc_tpu_torch.tools.ber_legs legs --preset {preset}")
    assert LEG_FIELDS <= set(t), LEG_FIELDS - set(t)
    assert t["trials"] >= 10_000
    assert t["seed_base"] == bl.SEED_BASE
    assert "NVIDIA" in t["device"] and "NVIDIA" in t["card"], t["device"]
    assert t["commit"]
    assert t["allow_tf32"] is False
    assert t["launches"].get("amp_split", 0) > 0     # K1 decoded it
    if preset in bp.CONCAT_PRESETS:
        assert t["launches"].get("bp_qc_layered", 0) > 0
        assert t["noise_in_kernel"] is True
    assert t["config_hash"] == config_hash(bl.leg_config(preset, "torch"))


@pytest.mark.parametrize("preset,ebno", POINTS, ids=POINT_IDS)
def test_torch_leg_within_ci_of_the_oracle(preset, ebno):
    o, t = _ref(preset, "oracle", ebno), _leg(preset, "torch", ebno)
    assert o is not None and t is not None
    assert o["trials"] >= bp.ORACLE_TRIALS_FLOOR[preset]
    _assert_within(o, t, bp.REL_FLOOR.get(preset, 0.01),
                   f"{preset} @ {ebno} dB oracle vs torch")


@pytest.mark.parametrize("preset,ebno", POINTS, ids=POINT_IDS)
def test_torch_leg_within_ci_of_the_reference_tpu_leg(preset, ebno):
    j, t = _ref(preset, "tpu", ebno), _leg(preset, "torch", ebno)
    assert j is not None and t is not None
    _assert_within(j, t, SAME_PRECISION_FLOOR,
                   f"{preset} @ {ebno} dB reference tpu vs torch")


@pytest.mark.parametrize("preset,ebno", NOISEK_POINTS,
                         ids=_ids(NOISEK_POINTS))
def test_noisek_leg_within_ci_of_the_oracle(preset, ebno):
    o, nk = _ref(preset, "oracle", ebno), _leg(preset, "torch_noisek", ebno)
    assert o is not None
    assert nk is not None, f"{preset} @ {ebno}: torch_noisek leg missing"
    assert nk["trials"] >= 10_000 and nk["seed_base"] == bl.SEED_BASE
    assert nk["noise_in_kernel"] is True
    assert nk["launches"].get("amp_split_noise", 0) > 0
    _assert_within(o, nk, bp.REL_FLOOR.get(preset, 0.01),
                   f"{preset} @ {ebno} dB oracle vs torch_noisek")


@pytest.mark.parametrize("preset,ebno", CONTROL_POINTS,
                         ids=_ids(CONTROL_POINTS))
def test_control_leg_within_ci_of_the_torch_leg(preset, ebno):
    c = _leg(preset, "torch_control_f32", ebno)
    t = _leg(preset, "torch", ebno)
    assert c is not None, (f"{preset} @ {ebno}: torch_control_f32 leg "
                           f"missing")
    assert t is not None
    assert c["trials"] >= 10_000 and c["seed_base"] == bl.SEED_BASE
    # float32 through and through: TF32 off, no hand-written kernel
    assert c["allow_tf32"] is False and c["precision"] == "highest"
    assert c["kernel"] == "xla" and c["bp_engine"] == "qc_xla"
    assert c["launches"] == {}
    _assert_within(c, t, SAME_PRECISION_FLOOR,
                   f"{preset} @ {ebno} dB torch_control_f32 vs torch")
