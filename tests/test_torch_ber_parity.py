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
     against torch, the REL_FLOOR presets and plain_small, 2 % floor;
  6. torch_control_f32 against the reference's own float32 control
     (`control_f32xla`, the concat presets), 2 % floor;
  7. torch_f64 (plain_small: the control's received words decoded in
     float64) against the oracle, REL_FLOOR;
  8. the route kinds, each the torch leg's config on another route with
     the noise drawn outside the kernel: torch_mono (K6), torch_slab
     (K7), torch_sharded (the section-sharded loop on a virtual (1 x 2)
     mesh: K3, hypercube, K4) and torch_pallas (the --pallas scan route:
     K5, K4), each against the oracle at REL_FLOOR and, where paired,
     against its partner's decode of the same draws (K1; for torch_pallas
     the scan route without use_pallas): a base is outside when the
     whole 95 % CI of the mean per-frame difference of bit errors lies
     beyond +- 2 % of the partner's mean bit errors a frame.

Every port leg is drawn twice, from seed bases 0 and 2
(`block_generator(base, point, block)`).  A pair is APART only when its
legs on both bases are outside the bound on the same side (the
replication rule, `ber_legs.replicated`).  For plain_small's float32 legs
(torch, torch_noisek) against the oracle the floor is max(REL_FLOOR, u),
u the upper end of the 95 % CI of the float32 shift that torch_f64
measured at that point and base (`ber_legs.rule_floor`), and only where
`ber_legs.c3_floor_holds` (torch_f64 inside the oracle rule and
torch_control_f32 within 2 % of torch at every plain_small point on both
bases; the rule's third condition, the same received words deciding
alike, is tests/test_torch_c3_same_words.py).

A missing leg fails.  The tool's own tests run on the CPU: its copied
constants and its kinds' configs equal the script's, a leg at a small
size writes a well-formed record and resumes (a paired one too), `check`
tells OK from APART, the seed bases select their records, the
replication rule, the paired float32 shift and the paired route rule
behave on hand-made legs and frames.
"""

import dataclasses
import json
import math
import os
import sys

import pytest
import torch_threads  # noqa: F401  (torch's threads: this worker's share)

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
                  for e in bp.GRIDS[p]] + [
    (p, e) for p in bl.C3_PRESETS for e in bp.GRIDS[p]]
REF_CONTROL_POINTS = [(p, e) for p in sorted(bp.CONCAT_PRESETS)
                      for e in bp.GRIDS[p]]
F64_POINTS = [(p, e) for p in bl.C3_PRESETS for e in bp.GRIDS[p]]
# the route kinds (kind -> its presets, the paired ones, the amp_kernel
# that names the route, the launch counters it must move)
ROUTE_PRESETS = {
    "torch_mono": ("plain_small", "pa_l1024", "concat_small"),
    "torch_slab": ("plain_small", "pa_l1024", "concat_small", "fast_l4096"),
    "torch_sharded": ("plain_small", "pa_l1024"),
    "torch_pallas": ("plain_small", "pa_l1024"),
}
PAIRED_PRESETS = {
    "torch_mono": ("plain_small", "pa_l1024"),
    "torch_slab": ("plain_small", "pa_l1024", "fast_l4096"),
    "torch_sharded": ("plain_small", "pa_l1024"),
    "torch_pallas": ("plain_small", "pa_l1024"),
}
ROUTE_KERNEL = {"torch_mono": "fused", "torch_slab": "fused_slab",
                "torch_pallas": "xla"}
ROUTE_LAUNCHES = {"torch_mono": ("amp_mono",), "torch_slab": ("amp_slab",),
                  "torch_sharded": ("fwht_tile", "denoise"),
                  "torch_pallas": ("fwht2", "denoise")}
ROUTE_KINDS = list(ROUTE_PRESETS)
ROUTE_POINTS = [(k, p, e) for k, ps in ROUTE_PRESETS.items() for p in ps
                for e in bp.GRIDS[p]]
PAIRED_POINTS = [(k, p, e) for k, ps in PAIRED_PRESETS.items() for p in ps
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


def _leg(preset, kind, ebno, base=bl.SEED_BASE, results=bl.RESULTS):
    """The last port record of `kind` at `ebno` drawn from seed base
    `base` (None if missing)."""
    return bl.last_leg(bl.load_records(bl.out_path(results, preset)), kind,
                       ebno, base)


def _ref(preset, kind, ebno):
    """The last reference record of `kind` at `ebno` (None if missing)."""
    return bl.last_leg(bp.load_records(preset), kind, ebno)


def _compare(a, b, rel):
    """The script's joint 95 % rule (its ci_ber), a's BER minus b's."""
    diff = a["ber"] - b["ber"]
    bound = max(math.hypot(bp.ci_ber(a), bp.ci_ber(b)),
                rel * max(a["ber"], b["ber"]))
    return dict(diff=diff, gap=abs(diff), bound=bound, ok=abs(diff) <= bound)


def _assert_replicated(preset, ebno, a, b, what):
    """Port kind `a` against `b` (a reference kind, or a port kind on the
    same seed base) at rule_floor's floor, on every seed base, held by the
    replication rule: APART only when outside on both bases, on the same
    side."""
    mine = bl.load_records(bl.out_path(bl.RESULTS, preset))
    ref = bp.load_records(preset)
    c3 = bl.c3_floor_holds(preset, mine, ref)
    cmps, lines = [], []
    for base in bl.SEED_BASES:
        la = bl.last_leg(mine, a, ebno, base)
        lb = (bl.last_leg(ref, b, ebno) if b in bl.REF_KINDS
              else bl.last_leg(mine, b, ebno, base))
        assert la is not None, f"{what}: {a} (seed base {base}) missing"
        assert lb is not None, f"{what}: {b} missing"
        floor = bl.rule_floor(preset, a, b,
                              bl.last_leg(mine, "torch_f64", ebno, base), c3)
        c = _compare(la, lb, floor)
        cmps.append(c)
        lines.append(f"seed base {base}: BER {la['ber']:.4e} vs "
                     f"{lb['ber']:.4e}, gap {c['diff']:+.3e}, joint 95% "
                     f"{c['bound']:.3e} (floor {floor:.4f})")
    assert bl.replicated(cmps), f"{what}: APART on both bases: " + "; ".join(
        lines)


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
    and concat_f32_control.py:35-40; on plain_small the control's SPARC
    overrides, for torch_control_f32 and torch_f64 alike.  A route kind:
    the torch leg's config with the amp_kernel that names the route
    (torch_sharded: the torch leg's config)."""
    r = dataclasses.replace
    if kind in ROUTE_PRESETS:
        cfg = _script_config(preset, "torch")
        if kind not in ROUTE_KERNEL:
            return cfg
        if preset in bp.CONCAT_PRESETS:
            return r(cfg, sparc=r(cfg.sparc, amp_kernel=ROUTE_KERNEL[kind]))
        return r(cfg, amp_kernel=ROUTE_KERNEL[kind])
    if kind in ("torch_control_f32", "torch_f64") and preset == "plain_small":
        return r(JPRESETS[preset], amp_kernel="xla", amp_tol=0.0,
                 transform_precision="highest")
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
        | {(p, "torch_control_f32") for p in bp.REL_FLOOR}
        | {("plain_small", "torch_control_f32"), ("plain_small", "torch_f64")}
        | {(p, k) for k, ps in ROUTE_PRESETS.items() for p in ps})
    assert {k: tuple(v) for k, v in bl.PAIRED_PRESETS.items()} == \
        PAIRED_PRESETS
    assert len(ROUTE_POINTS) == 35 and len(PAIRED_POINTS) == 29
    assert bl.SEED_BASES == (0, 2) and bl.SEED_BASE == 0
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


@pytest.mark.parametrize("preset,kind", [(p, k) for k, ps in
                                         PAIRED_PRESETS.items() for p in ps])
def test_partner_configs(preset, kind):
    """K1 on the torch leg's config for mono, slab and sharded; the pallas
    leg's own config (decoded without use_pallas) for torch_pallas."""
    want = _script_config(preset, "torch_pallas" if kind == "torch_pallas"
                          else "torch")
    assert dataclasses.asdict(bl.partner_config(preset, kind)) == \
        dataclasses.asdict(want)


REHEARSALS = [("plain_small", k) for k in ROUTE_PRESETS] + [
    ("concat_small", "torch_mono")]


@pytest.mark.parametrize("preset,kind", REHEARSALS,
                         ids=[f"{p}-{k}" for p, k in REHEARSALS])
def test_route_legs_on_the_cpu_write_a_record_and_resume(tmp_path, capsys,
                                                         preset, kind):
    """A route leg at a tiny size on the CPU (its kernels' plain versions):
    a well-formed record, paired where PAIRED_PRESETS says so, with the
    route named; a second call finds it done."""
    ebno = bp.GRIDS[preset][1]
    argv = ["legs", "--device", "cpu", "--preset", preset, "--kind", kind,
            "--ebno", str(ebno), "--trials", "4", "--batch", "2",
            "--out-dir", str(tmp_path)]
    assert bl.main(argv) == 0
    path = tmp_path / f"ber_parity_torch_{preset}.jsonl"
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(recs) == 1
    rec = recs[0]
    assert LEG_FIELDS <= set(rec)
    assert rec["kind"] == kind and rec["trials"] == 4 and rec["batch"] == 2
    assert rec["launches"] == {} and rec["noise_in_kernel"] is False
    assert rec["config_hash"] == config_hash(bl.leg_config(preset, kind))
    assert rec["use_pallas"] is (kind == "torch_pallas")
    assert rec["section_shards"] == (2 if kind == "torch_sharded" else 1)
    assert rec["kernel"] == ROUTE_KERNEL.get(kind, "fused_split")
    if preset in PAIRED_PRESETS[kind]:
        p = rec["paired"]
        assert p["diff_sum"] == rec["bit_errors"] - p["partner_bit_errors"]
        assert p["diff_sq"] >= p["diff_sum"] ** 2 / 4
        assert p["partner_kernel"] == (
            "xla" if kind == "torch_pallas" else "fused_split")
        assert p["partner_use_pallas"] is False
        for key in ("partner_bit_errors", "partner_frame_errors",
                    "partner_section_errors"):
            assert isinstance(p[key], int), key
    else:
        assert "paired" not in rec and "bp_ok" in rec
    capsys.readouterr()
    assert bl.main(argv) == 0
    assert "already done" in capsys.readouterr().out
    assert len(path.read_text().splitlines()) == 1


@pytest.mark.parametrize("kind", list(PAIRED_PRESETS))
def test_paired_block_halves_are_the_routes_blocks(kind):
    """A paired block decodes the draws of run_block with the noise
    outside: its kind's counters are the kind's own run_block on the same
    generator, its partner's the partner's, counter for counter."""
    import torch

    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    model, partner = bl.route_models("plain_small", kind, 3.0, "cpu")
    got = bl.paired_block(model, block_generator(2, 1, 0), 4,
                          (("", model.frame_counts),
                           ("partner_", partner.frame_counts)))
    for tag, m in (("", model), ("partner_", partner)):
        assert not m.noise_in_kernel
        want = m.run_block(block_generator(2, 1, 0), 4)
        for k in ("bit_errors", "frame_errors", "section_errors",
                  "iters_sum"):
            assert int(got[tag + k]) == int(want[k]), (tag, k)
        assert float(got[tag + "bit_errors_sq"]) == float(
            want["bit_errors_sq"])
    assert float(got["diff_sum"]) == int(got["bit_errors"]) - int(
        got["partner_bit_errors"])
    assert got["diff_sum"].dtype == torch.float64


def _hand_leg(kind, ber, ebno=3.0, base=None, k=8490, tr=10240, frame=15):
    """A hand-made leg at BER ber: frames of 0 or `frame` bit errors."""
    be = round(ber * tr * k)
    rec = dict(kind=kind, ebno_db=ebno, trials=tr, k_bits=k,
               bit_errors=be, bit_errors_sq=float(frame) * be,
               ber=be / (tr * k),
               wall_s=1.0, bits_per_s=tr * k / 1.0)
    if base is not None:
        rec["seed_base"] = base
    return rec


def _write(d, name, legs):
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text("".join(json.dumps(x) + "\n" for x in legs))


def _hand_made(tmp_path, torch_ber, torch_ber_2=None):
    """A port file and a reference file for concat_full at 3.0 dB with
    oracle, tpu and control_f32xla legs and the port's torch and control
    legs on both seed bases, at 10 240 trials; the torch leg at BER
    torch_ber (torch_ber_2 on seed base 2, default the same), the others
    at 1.6e-3."""
    torch_ber_2 = torch_ber if torch_ber_2 is None else torch_ber_2
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    port = []
    for base, ber in zip(bl.SEED_BASES, (torch_ber, torch_ber_2)):
        port += [_hand_leg("torch", ber, base=base),
                 _hand_leg("torch_control_f32", ber, base=base)]
    _write(mine, "ber_parity_torch_concat_full.jsonl", port)
    _write(ref, "ber_parity_concat_full.jsonl",
           [_hand_leg(k, 1.6e-3) for k in bl.REF_KINDS])
    return str(mine), str(ref)


@pytest.mark.parametrize("torch_ber,verdict", [(1.62e-3, "OK"),
                                               (2.4e-3, "APART")])
def test_check_tells_ok_from_apart(tmp_path, capsys, torch_ber, verdict):
    mine, ref = _hand_made(tmp_path, torch_ber)
    ok = bl.check(["concat_full"], mine, ref)
    out = capsys.readouterr().out
    assert ok == (verdict == "OK")
    assert f"torch vs oracle -> {verdict}" in out
    assert "torch_control_f32 vs torch -> OK" in out
    assert "torch_control_f32 vs control_f32xla" in out
    assert "(seed base 2)" in out
    # the markdown form: the same verdicts, one row for the point
    assert bl.check(["concat_full"], mine, ref, markdown=True) == ok
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 3 and rows[2].startswith("| concat_full | 3.0 |")
    header = [c.strip() for c in rows[0].strip("|").split("|")]
    cells = dict(zip(header, (c.strip() for c in
                              rows[2].strip("|").split("|"))))
    assert len(cells) == len(header)
    side = "in/in" if verdict == "OK" else "out/out"
    want = ("OK" if verdict == "OK" else "**APART**") + f" ({side})"
    assert cells["torch vs oracle"] == want
    assert cells["torch vs tpu"] == want
    assert cells["torch_noisek vs oracle"] == "—"
    assert cells["torch_control_f32 vs torch"] == "OK (in/in)"
    assert cells["torch_f64 vs oracle"] == "—"
    os.remove(os.path.join(mine, "ber_parity_torch_concat_full.jsonl"))
    assert not bl.check(["concat_full"], mine, ref)
    assert "MISSING" in capsys.readouterr().out


@pytest.mark.parametrize("ber_0,ber_2,verdict", [
    (1.62e-3, 1.62e-3, "OK"),        # inside on both bases
    (2.4e-3, 1.62e-3, "OK"),         # outside on base 0 only
    (1.62e-3, 0.9e-3, "OK"),         # outside on base 2 only
    (2.4e-3, 0.9e-3, "OK"),          # outside on both, on opposite sides
    (2.4e-3, 2.2e-3, "APART"),       # outside on both, above
    (0.9e-3, 1.0e-3, "APART"),       # outside on both, below
])
def test_replication_rule_on_hand_made_legs(tmp_path, capsys, ber_0, ber_2,
                                            verdict):
    mine, ref = _hand_made(tmp_path, ber_0, ber_2)
    legs, pairs = bl.point_pairs(
        "concat_full", 3.0,
        bl.load_records(bl.out_path(mine, "concat_full")),
        bl.load_records(bl.ref_path(ref, "concat_full")))
    got = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    cmps, ok = got[("torch", "oracle")]
    assert [c["ok"] for c in cmps.values()] == [
        _compare(_hand_leg("torch", x), _hand_leg("oracle", 1.6e-3),
                 0.15)["ok"] for x in (ber_0, ber_2)]
    assert ok == (verdict == "OK")
    assert bl.replicated(list(cmps.values())) == ok
    assert bl.check(["concat_full"], mine, ref) == (verdict == "OK")
    capsys.readouterr()


def test_replicated_is_the_rule():
    def c(ok, diff):
        return dict(ok=ok, diff=diff)

    assert bl.replicated([c(True, 1.0), c(True, -1.0)])
    assert bl.replicated([c(False, 1.0), c(True, 1.0)])
    assert bl.replicated([c(True, 1.0), c(False, -1.0)])
    assert bl.replicated([c(False, 1.0), c(False, -1.0)])
    assert not bl.replicated([c(False, 1.0), c(False, 2.0)])
    assert not bl.replicated([c(False, -1.0), c(False, -2.0)])


def _paired_leg(d64, d32, base=0, ebno=3.0, k=2304):
    """A hand-made torch_f64 record from per-frame bit errors: d64 of the
    float64 decode, d32 of the float32 decode of the same frames."""
    import numpy as np

    d64, d32 = np.asarray(d64, float), np.asarray(d32, float)
    d = d32 - d64
    tr = d64.size
    return dict(kind="torch_f64", ebno_db=ebno, trials=tr, k_bits=k,
                seed_base=base, bit_errors=int(d64.sum()),
                bit_errors_sq=float((d64 ** 2).sum()),
                ber=d64.sum() / (tr * k), wall_s=1.0,
                bits_per_s=tr * k / 1.0,
                paired=dict(f32_bit_errors=int(d32.sum()),
                            diff_sum=float(d.sum()),
                            diff_sq=float((d * d).sum())))


def test_f32_shift_ci_on_hand_made_frames():
    import numpy as np

    rng = np.random.default_rng(3)
    d64 = rng.integers(0, 40, 4096) * (rng.random(4096) < 0.3)
    d32 = d64 + rng.integers(-2, 4, 4096) * (rng.random(4096) < 0.2)
    s = bl.f32_shift(_paired_leg(d64, d32))
    d = (d32 - d64).astype(float)
    rel = d.sum() / d64.sum()
    half = 1.96 * d.std() / np.sqrt(d.size) * d.size / d64.sum()
    assert s["rel"] == pytest.approx(rel, rel=1e-12)
    assert s["half"] == pytest.approx(half, rel=1e-9)
    assert s["lo"] == pytest.approx(rel - half) and s["hi"] == pytest.approx(
        rel + half)
    assert s["lo"] < s["rel"] < s["hi"]
    # the same frames: no shift and no spread
    z = bl.f32_shift(_paired_leg(d64, d64))
    assert z == dict(rel=0.0, half=0.0, lo=0.0, hi=0.0)
    # every frame 10 % worse in float32: a shift of 0.1 (spread from the
    # frames' own spread)
    t = bl.f32_shift(_paired_leg(np.full(100, 10), np.full(100, 11)))
    assert t["rel"] == pytest.approx(0.1) and t["half"] == pytest.approx(0.0)
    assert bl.f32_shift(_paired_leg(np.zeros(8), np.ones(8))) is None


def _c3_files(tmp_path, f64_ber=2.08e-2, control_ber=2.30e-2,
              shift=(0.12, 0.13)):
    """plain_small legs at its three points: the oracle at 2.08e-2, tpu
    and torch and torch_noisek at 2.30e-2 (10.6 % above), the control at
    control_ber and torch_f64 at f64_ber on both bases, whose paired
    frames give the float32 shifts `shift` (base 0, base 2); frames of 0
    or F bit errors."""
    import numpy as np

    k, tr, F = 2304, 10240, 200
    port, ref = [], []
    for ebno in bp.GRIDS["plain_small"]:
        ref += [_hand_leg("oracle", 2.08e-2, ebno, k=k, tr=10000, frame=F),
                _hand_leg("tpu", 2.30e-2, ebno, k=k, frame=F)]
        for base, sh in zip(bl.SEED_BASES, shift):
            port += [_hand_leg(kd, 2.30e-2, ebno, base, k=k, frame=F)
                     for kd in ("torch", "torch_noisek")]
            port.append(_hand_leg("torch_control_f32", control_ber, ebno,
                                  base, k=k, frame=F))
            n_err = round(f64_ber * tr * k / F)
            d64 = np.zeros(tr)
            d64[:n_err] = F
            d32 = d64.copy()
            extra = round(sh * d64.sum() / F)
            d32[n_err:n_err + extra] = F
            port.append(dict(_paired_leg(d64, d32, base, ebno, k)))
            # the route legs: at the float64 leg's BER, the same bit
            # errors as their partners frame for frame
            port += [_route_leg(kd, ebno, base, 0.0, n_err, k, tr, F)
                     for kd in ROUTE_PRESETS]
    _write(tmp_path / "mine", "ber_parity_torch_plain_small.jsonl", port)
    _write(tmp_path / "ref", "ber_parity_plain_small.jsonl", ref)
    return (bl.load_records(bl.out_path(str(tmp_path / "mine"),
                                        "plain_small")),
            bl.load_records(bl.ref_path(str(tmp_path / "ref"),
                                        "plain_small")))


def test_c3_floor_is_the_measured_shift_only_where_its_conditions_hold(
        tmp_path):
    mine, ref = _c3_files(tmp_path / "a")
    assert bl.c3_floor_holds("plain_small", mine, ref)
    legs, pairs = bl.point_pairs("plain_small", 3.0, mine, ref)
    got = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    for base, sh in zip(bl.SEED_BASES, (0.12, 0.13)):
        hi = bl.f32_shift(legs[("torch_f64", base)])["hi"]
        assert sh < hi < sh + 0.03
        for a in ("torch", "torch_noisek"):
            assert got[(a, "oracle")][0][base]["floor"] == pytest.approx(hi)
        # the other pairs keep their floors
        assert got[("torch", "tpu")][0][base]["floor"] == 0.02
        assert got[("torch_f64", "oracle")][0][base]["floor"] == 0.01
    assert got[("torch", "oracle")][1] and got[("torch_noisek", "oracle")][1]
    # the control 5 % off torch: the floor stays REL_FLOOR's and the
    # float32 legs are APART again
    mine, ref = _c3_files(tmp_path / "b", control_ber=2.19e-2)
    assert not bl.c3_floor_holds("plain_small", mine, ref)
    legs, pairs = bl.point_pairs("plain_small", 3.0, mine, ref)
    got = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    assert got[("torch", "oracle")][0][0]["floor"] == 0.01
    assert not got[("torch", "oracle")][1]
    # torch_f64 off the oracle: the same
    mine, ref = _c3_files(tmp_path / "c", f64_ber=2.25e-2)
    assert not bl.c3_floor_holds("plain_small", mine, ref)
    # a negative shift leaves REL_FLOOR
    mine, ref = _c3_files(tmp_path / "d", shift=(-0.05, -0.05))
    assert bl.c3_floor_holds("plain_small", mine, ref)
    legs, pairs = bl.point_pairs("plain_small", 3.0, mine, ref)
    got = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    assert got[("torch", "oracle")][0][2]["floor"] == 0.01


def _route_leg(kind, ebno, base, shift, n_err=1000, k=8490, tr=10240, F=15):
    """A hand-made paired route leg: the partner's frames n_err of F bit
    errors; the kind's the same and round(shift * n_err) frames of F more
    (shift > 0) or fewer (shift < 0)."""
    extra = round(shift * n_err)
    be = (n_err + extra) * F
    return dict(kind=kind, ebno_db=ebno, trials=tr, k_bits=k, seed_base=base,
                bit_errors=be, bit_errors_sq=float(F * be),
                ber=be / (tr * k), wall_s=1.0, bits_per_s=tr * k / 1.0,
                paired=dict(partner_bit_errors=n_err * F,
                            partner_bit_errors_sq=float(n_err * F * F),
                            diff_sum=float(extra * F),
                            diff_sq=float(abs(extra) * F * F)))


def _route_files(tmp_path, shift_0, shift_2):
    """pa_l1024 at its three points: the reference's oracle and tpu legs
    and every port kind at the same BER; torch_mono's paired frames shifted
    by shift_0 (seed base 0) and shift_2 (base 2), the other route kinds'
    not at all."""
    k, tr, F, n_err = 8490, 10240, 15, 1000
    ber = n_err * F / (tr * k)
    port, ref = [], []
    for ebno in bp.GRIDS["pa_l1024"]:
        ref += [_hand_leg(kd, ber, ebno, k=k, frame=F)
                for kd in ("oracle", "tpu")]
        for base, sh in zip(bl.SEED_BASES, (shift_0, shift_2)):
            port += [_hand_leg(kd, ber, ebno, base, k=k, frame=F)
                     for kd in ("torch", "torch_noisek")]
            port += [_route_leg(kd, ebno, base, sh if kd == "torch_mono"
                                else 0.0, n_err, k, tr, F)
                     for kd in ROUTE_PRESETS]
    _write(tmp_path / "mine", "ber_parity_torch_pa_l1024.jsonl", port)
    _write(tmp_path / "ref", "ber_parity_pa_l1024.jsonl", ref)
    return str(tmp_path / "mine"), str(tmp_path / "ref")


def test_paired_compare_on_hand_made_frames():
    """The mean per-frame d and its 95 % CI half-width from the leg's sum
    and sum of squares, against numpy on the frames; the bound is 2 % of
    the partner's mean bit errors a frame."""
    import numpy as np

    rng = np.random.default_rng(5)
    partner = rng.integers(0, 40, 4096) * (rng.random(4096) < 0.3)
    kind = partner + rng.integers(-1, 4, 4096) * (rng.random(4096) < 0.1)
    d = (kind - partner).astype(float)
    rec = dict(trials=4096, paired=dict(
        partner_bit_errors=int(partner.sum()), diff_sum=float(d.sum()),
        diff_sq=float((d * d).sum())))
    c = bl.paired_compare(rec)
    assert c["diff"] == pytest.approx(d.mean(), rel=1e-12)
    assert c["half"] == pytest.approx(1.96 * d.std() / np.sqrt(d.size),
                                      rel=1e-9)
    assert c["bound"] == pytest.approx(0.02 * partner.mean(), rel=1e-12)
    assert c["ok"] == (abs(d.mean()) - c["half"] <= c["bound"])
    # the same frames: no difference, inside
    same = dict(rec, paired=dict(rec["paired"], diff_sum=0.0, diff_sq=0.0))
    assert bl.paired_compare(same) == dict(diff=0.0, half=0.0, gap=0.0,
                                           bound=c["bound"], ok=True)


@pytest.mark.parametrize("shift_0,shift_2,verdict", [
    (0.01, 0.01, "OK"),          # inside on both bases
    (0.05, 0.01, "OK"),          # outside on base 0 only
    (0.0, -0.05, "OK"),          # outside on base 2 only
    (0.05, -0.05, "OK"),         # outside on both, on opposite sides
    (0.05, 0.06, "APART"),       # outside on both, above
    (-0.05, -0.04, "APART"),     # outside on both, below
])
def test_paired_rule_tells_ok_from_apart(tmp_path, capsys, shift_0, shift_2,
                                         verdict):
    """torch_mono's paired frames shifted by a few % of the partner's bit
    errors: a base is outside when the whole CI of the mean d lies beyond
    2 %, and the pair is APART only when both bases are outside on the
    same side; `check` and its markdown list the route kinds."""
    mine, ref = _route_files(tmp_path, shift_0, shift_2)
    legs, pairs = bl.point_pairs(
        "pa_l1024", 2.25, bl.load_records(bl.out_path(mine, "pa_l1024")),
        bl.load_records(bl.ref_path(ref, "pa_l1024")))
    got = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    assert set(got) >= {(k, b) for k in ROUTE_PRESETS
                        for b in ("oracle", "paired")}
    cmps, ok = got[("torch_mono", "paired")]
    assert [c["ok"] for c in cmps.values()] == [abs(x) < 0.03
                                                for x in (shift_0, shift_2)]
    assert ok == (verdict == "OK") == bl.replicated(list(cmps.values()))
    for kind in ("torch_slab", "torch_sharded", "torch_pallas"):
        assert got[(kind, "paired")][1] and got[(kind, "oracle")][1]
    assert bl.check(["pa_l1024"], mine, ref) == (verdict == "OK")
    out = capsys.readouterr().out
    assert f"pa_l1024 @ 2.25: torch_mono vs paired -> {verdict}" in out
    assert "torch_pallas vs its partner on the same frames (seed base 2)" \
        in out
    # the markdown: the first table as before, then a row a route kind and
    # point
    assert bl.check(["pa_l1024"], mine, ref, markdown=True) == (
        verdict == "OK")
    lines = capsys.readouterr().out.splitlines()
    at = lines.index("")
    header = [c.strip() for c in lines[at + 1].strip("|").split("|")]
    rows = [dict(zip(header, (c.strip() for c in x.strip("|").split("|"))))
            for x in lines[at + 3:]]
    assert [(r["dB"], r["kind"]) for r in rows] == [
        (str(e), k) for e in bp.GRIDS["pa_l1024"] for k in ROUTE_PRESETS]
    mono = rows[ROUTE_KINDS.index("torch_mono")]    # at 1.5 dB, as at 2.25
    assert mono["vs oracle"] == "OK (in/in)"
    sides = "/".join("in" if abs(x) < 0.03 else "out"
                     for x in (shift_0, shift_2))
    assert mono["vs partner"] == ("OK" if verdict == "OK"
                                  else "**APART**") + f" ({sides})"
    assert mono["mean d a frame (base 0; 2)"] == "; ".join(
        f"{c['diff']:+.3f} ± {c['half']:.3f}" for c in cmps.values())
    assert "torch_mono vs oracle" not in lines[0]


def test_seed_bases_select_their_records_and_resume_apart(tmp_path, capsys):
    recs = [dict(kind="torch", ebno_db=2.0, seed_base=b, ber=x)
            for b, x in ((0, 0.1), (2, 0.2), (0, 0.3))]
    assert bl.last_leg(recs, "torch", 2.0, 0)["ber"] == 0.3
    assert bl.last_leg(recs, "torch", 2.0, 2)["ber"] == 0.2
    assert bl.last_leg(recs, "torch", 2.0)["ber"] == 0.3
    assert bl.last_leg(recs, "torch", 2.0, 1) is None
    argv = ["legs", "--device", "cpu", "--preset", "plain_small", "--kind",
            "torch", "--ebno", "4.0", "--trials", "4", "--batch", "4",
            "--out-dir", str(tmp_path)]
    for base in ("0", "2", "2"):
        assert bl.main(argv + ["--seed-base", base]) == 0
    out = capsys.readouterr().out
    assert out.count("already done") == 1
    path = tmp_path / "ber_parity_torch_plain_small.jsonl"
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["seed_base"] for r in recs] == [0, 2]
    # base 1 is spent and 10**6 is the warm-up's: refused
    for base in ("1", str(bl.WARMUP_BASE)):
        with pytest.raises(SystemExit):
            bl.main(argv + ["--seed-base", base])
    with pytest.raises(ValueError):
        bl.run_leg("plain_small", "torch", 0, 4, 4, "cpu", seed_base=1)
    capsys.readouterr()


def test_f64_block_float32_half_is_the_control_block():
    """torch_f64's float32 decode is the control's block on the same
    generator, counter for counter; its float64 decode runs in float64."""
    import torch

    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    cfg = bl.leg_config("plain_small", "torch_f64")
    assert cfg == bl.leg_config("plain_small", "torch_control_f32")
    model = SparcModel.build(cfg.replace(amp_iters=8), 3.0, "cpu")
    want = model.run_block(block_generator(2, 1, 0), 4)
    got = bl.f64_block(model, block_generator(2, 1, 0), 4)
    for k in ("bit_errors", "frame_errors", "section_errors", "iters_sum"):
        assert int(got["f32_" + k]) == int(want[k]), k
    assert float(got["f32_bit_errors_sq"]) == float(want["bit_errors_sq"])
    d = int(got["f32_bit_errors"]) - int(got["bit_errors"])
    assert float(got["diff_sum"]) == d
    assert float(got["diff_sq"]) >= d * d / 4
    assert got["bit_errors"].dtype == torch.int64


# ------------------------------------------------- the committed legs

def _port_records(preset):
    return bl.load_records(bl.out_path(bl.RESULTS, preset))


@pytest.mark.parametrize("preset,ebno", POINTS, ids=POINT_IDS)
def test_torch_leg_recorded(preset, ebno):
    for base in bl.SEED_BASES:
        t = _leg(preset, "torch", ebno, base)
        assert t is not None, (
            f"{preset} @ {ebno}: torch leg (seed base {base}) missing — "
            f"python -m sparc_ldpc_tpu_torch.tools.ber_legs legs --preset "
            f"{preset} --seed-base {base}")
        assert LEG_FIELDS <= set(t), LEG_FIELDS - set(t)
        assert t["trials"] >= 10_000
        assert t["seed_base"] == base
        assert "NVIDIA" in t["device"] and "NVIDIA" in t["card"], t["device"]
        assert t["commit"]
        assert t["allow_tf32"] is False
        assert t["launches"].get("amp_split", 0) > 0     # K1 decoded it
        if preset in bp.CONCAT_PRESETS:
            assert t["launches"].get("bp_qc_layered", 0) > 0
            assert t["noise_in_kernel"] is True
        assert t["config_hash"] == config_hash(bl.leg_config(preset,
                                                             "torch"))


ALL_LEGS = [(p, k, e) for p, k in LEGS for e in bp.GRIDS[p]]


@pytest.mark.parametrize("preset,kind,ebno", ALL_LEGS,
                         ids=[f"{p}-{k}-{e}dB" for p, k, e in ALL_LEGS])
def test_every_leg_recorded_on_both_seed_bases(preset, kind, ebno):
    """Every kind at every point, from seed bases 0 and 2, on an NVIDIA
    card, with its commit, source digest and card line; the seed-base-0
    records come first in the file (the earlier ones kept as they were)."""
    recs = _port_records(preset)
    for base in bl.SEED_BASES:
        r = bl.last_leg(recs, kind, ebno, base)
        assert r is not None, (f"{preset} @ {ebno}: {kind} (seed base "
                               f"{base}) missing")
        assert r["trials"] >= 10_000 and r["seed_base"] == base
        assert "NVIDIA" in r["card"] and r["commit"] and r["source_sha1"]
        assert r["allow_tf32"] is False
        assert r["config_hash"] == config_hash(bl.leg_config(preset, kind))
        assert r["ber"] == r["bit_errors"] / (r["trials"] * r["k_bits"])
        assert bl.ci_ber(r) == bp.ci_ber(r)


@pytest.mark.parametrize("preset,ebno", POINTS, ids=POINT_IDS)
def test_torch_leg_within_ci_of_the_oracle(preset, ebno):
    o = _ref(preset, "oracle", ebno)
    assert o is not None
    assert o["trials"] >= bp.ORACLE_TRIALS_FLOOR[preset]
    _assert_replicated(preset, ebno, "torch", "oracle",
                       f"{preset} @ {ebno} dB oracle vs torch")


@pytest.mark.parametrize("preset,ebno", POINTS, ids=POINT_IDS)
def test_torch_leg_within_ci_of_the_reference_tpu_leg(preset, ebno):
    assert _ref(preset, "tpu", ebno) is not None
    _assert_replicated(preset, ebno, "torch", "tpu",
                       f"{preset} @ {ebno} dB reference tpu vs torch")


@pytest.mark.parametrize("preset,ebno", NOISEK_POINTS,
                         ids=_ids(NOISEK_POINTS))
def test_noisek_leg_within_ci_of_the_oracle(preset, ebno):
    assert _ref(preset, "oracle", ebno) is not None
    for base in bl.SEED_BASES:
        nk = _leg(preset, "torch_noisek", ebno, base)
        assert nk is not None, (f"{preset} @ {ebno}: torch_noisek leg "
                                f"(seed base {base}) missing")
        assert nk["trials"] >= 10_000 and nk["seed_base"] == base
        assert nk["noise_in_kernel"] is True
        assert nk["launches"].get("amp_split_noise", 0) > 0
    _assert_replicated(preset, ebno, "torch_noisek", "oracle",
                       f"{preset} @ {ebno} dB oracle vs torch_noisek")


@pytest.mark.parametrize("preset,ebno", CONTROL_POINTS,
                         ids=_ids(CONTROL_POINTS))
def test_control_leg_within_ci_of_the_torch_leg(preset, ebno):
    for base in bl.SEED_BASES:
        c = _leg(preset, "torch_control_f32", ebno, base)
        assert c is not None, (f"{preset} @ {ebno}: torch_control_f32 leg "
                               f"(seed base {base}) missing")
        assert _leg(preset, "torch", ebno, base) is not None
        assert c["trials"] >= 10_000 and c["seed_base"] == base
        # float32 through and through: TF32 off, no hand-written kernel
        assert c["allow_tf32"] is False and c["precision"] == "highest"
        assert c["kernel"] == "xla" and c["launches"] == {}
        if preset in bp.CONCAT_PRESETS:
            assert c["bp_engine"] == "qc_xla"
    _assert_replicated(preset, ebno, "torch_control_f32", "torch",
                       f"{preset} @ {ebno} dB torch_control_f32 vs torch")


@pytest.mark.parametrize("preset,ebno", REF_CONTROL_POINTS,
                         ids=_ids(REF_CONTROL_POINTS))
def test_control_leg_within_ci_of_the_reference_control_leg(preset, ebno):
    """The port's float32 control against the reference's own
    (`control_f32xla`, scripts/concat_f32_control.py), 2 % floor."""
    assert _ref(preset, "control_f32xla", ebno) is not None
    _assert_replicated(preset, ebno, "torch_control_f32", "control_f32xla",
                       f"{preset} @ {ebno} dB reference control_f32xla vs "
                       f"torch_control_f32")


@pytest.mark.parametrize("kind,preset,ebno", ROUTE_POINTS,
                         ids=[f"{k}-{p}-{e}dB" for k, p, e in ROUTE_POINTS])
def test_route_leg_recorded(kind, preset, ebno):
    """Every route leg on both seed bases ran its route's hand-written
    kernels with the noise drawn outside them; a paired one carries its
    partner's counters (K1 once a block where the partner is K1)."""
    for base in bl.SEED_BASES:
        r = _leg(preset, kind, ebno, base)
        assert r is not None, (f"{preset} @ {ebno}: {kind} (seed base "
                               f"{base}) missing — python -m "
                               f"sparc_ldpc_tpu_torch.tools.ber_legs legs "
                               f"--preset {preset} --kind {kind} "
                               f"--seed-base {base}")
        assert r["noise_in_kernel"] is False
        assert r["kernel"] == ROUTE_KERNEL.get(
            kind, bl.leg_config(preset, "torch").sparc.amp_kernel
            if preset in bp.CONCAT_PRESETS else "fused_split")
        assert r["use_pallas"] is (kind == "torch_pallas")
        assert r["section_shards"] == (2 if kind == "torch_sharded" else 1)
        for name in ROUTE_LAUNCHES[kind]:
            assert r["launches"].get(name, 0) > 0, (name, r["launches"])
        if preset in bp.CONCAT_PRESETS:
            assert r["launches"].get("bp_qc_layered", 0) > 0
        blocks = r["trials"] // r["batch"]
        if preset in PAIRED_PRESETS[kind]:
            p = r["paired"]
            assert p["diff_sum"] == r["bit_errors"] - p["partner_bit_errors"]
            if kind != "torch_pallas":
                assert r["launches"]["amp_split"] == blocks
        else:
            assert "paired" not in r
            assert r["launches"].get("amp_split", 0) == 0


@pytest.mark.parametrize("kind,preset,ebno", ROUTE_POINTS,
                         ids=[f"{k}-{p}-{e}dB" for k, p, e in ROUTE_POINTS])
def test_route_leg_within_ci_of_the_oracle(kind, preset, ebno):
    assert _ref(preset, "oracle", ebno) is not None
    _assert_replicated(preset, ebno, kind, "oracle",
                       f"{preset} @ {ebno} dB oracle vs {kind}")


@pytest.mark.parametrize("kind,preset,ebno", PAIRED_POINTS,
                         ids=[f"{k}-{p}-{e}dB" for k, p, e in PAIRED_POINTS])
def test_route_leg_within_the_paired_rule(kind, preset, ebno):
    """The route's decode against its partner's on the same frames: APART
    only when the 95 % CI of the mean per-frame d lies wholly beyond +- 2 %
    of the partner's mean bit errors a frame on both seed bases, on the
    same side."""
    cmps, lines = [], []
    for base in bl.SEED_BASES:
        r = _leg(preset, kind, ebno, base)
        assert r is not None and "paired" in r, (kind, preset, ebno, base)
        p, tr = r["paired"], r["trials"]
        mean = p["diff_sum"] / tr
        half = 1.96 * math.sqrt(max(p["diff_sq"] / tr - mean ** 2, 0.0) / tr)
        bound = SAME_PRECISION_FLOOR * p["partner_bit_errors"] / tr
        ok = not (mean - half > bound or mean + half < -bound)
        assert bl.paired_compare(r)["ok"] == ok
        cmps.append(dict(ok=ok, diff=mean))
        lines.append(f"seed base {base}: mean d {mean:+.4f} ± {half:.4f} "
                     f"a frame, bound ±{bound:.4f}")
    assert bl.replicated(cmps), (f"{preset} @ {ebno} dB {kind} vs its "
                                 f"partner: APART on both bases: "
                                 + "; ".join(lines))


def test_check_passes_on_the_committed_legs(capsys):
    """`ber_legs check --markdown` on the records on disk: every leg there
    and no pair APART; its second table has a row for every route kind
    and point."""
    assert bl.main(["check", "--markdown"]) == 0
    out = capsys.readouterr().out
    for kind, preset, ebno in ROUTE_POINTS:
        assert f"| {preset} | {ebno} | {kind} |" in out, (kind, preset, ebno)
    assert "APART" not in out and "missing" not in out


K1_PARTNER_POINTS = [(k, p, e) for k, p, e in PAIRED_POINTS
                     if k != "torch_pallas" and p in bp.NOISEK_PRESETS]


@pytest.mark.parametrize("kind,preset,ebno", K1_PARTNER_POINTS,
                         ids=[f"{k}-{p}-{e}dB"
                              for k, p, e in K1_PARTNER_POINTS])
def test_k1_partner_decodes_the_torch_legs_draws(kind, preset, ebno):
    """At plain_small and pa_l1024 the torch leg draws its noise outside
    K1 from the same generators, so a route leg's K1 partner decodes that
    leg's draws: its counters are the torch leg's of the same seed base
    (bit_errors_sq up to run_block's float32 sum)."""
    for base in bl.SEED_BASES:
        p = _leg(preset, kind, ebno, base)["paired"]
        t = _leg(preset, "torch", ebno, base)
        assert t["noise_in_kernel"] is False
        for key in ("bit_errors", "frame_errors", "section_errors"):
            assert p["partner_" + key] == t[key], (key, base)
        assert p["partner_bit_errors_sq"] == pytest.approx(
            t["bit_errors_sq"], rel=1e-6)


@pytest.mark.parametrize("preset,ebno", F64_POINTS, ids=_ids(F64_POINTS))
def test_f64_leg_within_ci_of_the_oracle(preset, ebno):
    """torch_f64 (the control's received words decoded in float64) against
    the float64 oracle at REL_FLOOR; its float32 half is the control leg
    of the same seed base, counter for counter."""
    for base in bl.SEED_BASES:
        f = _leg(preset, "torch_f64", ebno, base)
        c = _leg(preset, "torch_control_f32", ebno, base)
        assert f is not None and c is not None, (
            f"{preset} @ {ebno}: torch_f64 or its control (seed base "
            f"{base}) missing")
        assert f["dtype"] == "float64" and f["launches"] == {}
        assert f["trials"] == c["trials"] and f["batch"] == c["batch"]
        p = f["paired"]
        assert p["f32_bit_errors"] == c["bit_errors"]
        assert p["f32_frame_errors"] == c["frame_errors"]
        assert p["f32_section_errors"] == c["section_errors"]
        assert p["diff_sum"] == p["f32_bit_errors"] - f["bit_errors"]
    _assert_replicated(preset, ebno, "torch_f64", "oracle",
                       f"{preset} @ {ebno} dB oracle vs torch_f64")
