#!/usr/bin/env python3
"""BER/FER legs of the port, for the float64 oracle legs on disk (port of
the leg-running half of scripts/ber_parity.py, `run_tpu` and
`run_tpu_concat`, and of scripts/concat_f32_control.py).

    python -m sparc_ldpc_tpu_torch.tools.ber_legs legs [--preset P ...]
        [--kind K ...] [--ebno DB ...] [--trials 10240] [--batch 512]
        [--out-dir results] [--device cuda|cpu] [--force] [--commit C]
    python -m sparc_ldpc_tpu_torch.tools.ber_legs check [--preset P ...]
        [--markdown]

`legs` decodes each point of GRIDS on the port and appends one JSON line
a leg to `<out-dir>/ber_parity_torch_<preset>.jsonl`.  Three kinds, each
with the reference script's overrides of the preset (`leg_config`):

  torch              plain_small, pa_l1024: fused_split, amp_tol=0, bf16,
                     the noise drawn outside (K1); fast_l4096: the preset
                     verbatim at batch <= 256 (K1 at L=4096, its noise in
                     the kernel); the concat presets: fused_split,
                     amp_tol=0, bf16, the noise in the kernel (K1 twice a
                     block, then K2);
  torch_noisek       NOISEK_PRESETS: as torch, the noise drawn in K1
                     (its Philox stream);
  torch_control_f32  the REL_FLOOR presets: the scan route in float32
                     (amp_kernel="xla", amp_tol=0, "highest") and the
                     plain layered BP engine (engine="qc_xla"): no
                     hand-written kernel, TF32 off.

Block b of point p (p its index in GRIDS[preset]) draws from
`utils.rng.block_generator(SEED_BASE, p, b)` on the model's device; a
warm-up block on `block_generator(WARMUP_BASE, p, 0)`, outside that
space, is left out of the counts and of `wall_s`.  On the GPU a point's
trials are max(--trials, MIN_TRIALS) rounded up to whole blocks; with
`--device cpu` (a rehearsal at a small size: such a record never stands
for the card) they are --trials rounded up.  TF32 is off for every leg
(`allow_tf32` in each record).  A record carries the reference's `tpu`
fields, `seed_base`, the launches of each hand-written kernel, the port's
`artifact_meta` (its `commit` from git, or --commit where the tree is not
a checkout), `source_sha1` (`source_digest`: the port's code as run) and
the card's `nvidia-smi` name and power limit.  A point
whose record of that kind exists at the same commit is skipped; --force
appends a new one.

`check` prints, point by point, the rules of the reference's `run_check`
for the port's legs beside the reference's `results/ber_parity_<preset>
.jsonl` (read only): torch against the oracle (joint 95 % CI floored at
REL_FLOOR, default 1 %), torch against the reference's own `tpu` leg and
torch_control_f32 against torch (2 % floor), torch_noisek against the
oracle; it exits 1 if a point is APART or a required leg is missing.
With --markdown it prints the same verdicts as a markdown table, a row a
point, each leg's BER with its 95 % CI half-width.

On a machine where the tree is not a git checkout, pass --commit (e.g.
`git describe --always --dirty` of the tree copied there), write to a
scratch --out-dir and copy the files into results/ byte for byte.
Without a GPU and without `--device cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import torch

from ..config import PRESETS, ConcatConfig, LdpcConfig, SparcConfig

# The reference script's reduced concat chains (scripts/ber_parity.py:55)
# with the port's config classes: same fields, same repr and config_hash.
CONCAT_PRESETS = {
    "concat_small": ConcatConfig(
        sparc=SparcConfig(L=256, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard"),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        bp_iters=24, engine="qc", schedule="layered"),
        f_prot=0.5, feedback_iters=8),
    "concat_wifi_small": ConcatConfig(
        sparc=SparcConfig(L=256, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard"),
        ldpc=LdpcConfig(kind="qc", path="wifi_n648_r12", engine="qc",
                        schedule="layered", bp_iters=32),
        f_prot=0.28, feedback_iters=8),
    "concat_r56_small": ConcatConfig(
        sparc=SparcConfig(L=256, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard"),
        ldpc=LdpcConfig(kind="qc", path="qc_n648_r56", engine="qc",
                        schedule="layered", bp_iters=32),
        f_prot=0.28, feedback_iters=8),
    "concat_full": PRESETS["concat"],
}

# Copies of scripts/ber_parity.py:100, :141, :168 and :478 (the tests hold
# them equal to the script's).
GRIDS = {
    "plain_small": [2.0, 3.0, 4.0],
    "pa_l1024": [1.5, 2.25, 3.0],
    "concat_small": [2.5, 3.0, 3.5],
    "concat_wifi_small": [2.5, 3.0, 3.5],
    "concat_r56_small": [2.5, 3.0, 3.5],
    "concat_full": [3.0],
    "fast_l4096": [5.0, 5.5, 6.0, 6.5, 7.0],
}
ORACLE_TRIALS_FLOOR = {
    "plain_small": 10_000,
    "pa_l1024": 4_000,
    "concat_small": 5_000,
    "concat_wifi_small": 5_000,
    "concat_r56_small": 5_000,
    "concat_full": 1_000,
    "fast_l4096": 300,
}
REL_FLOOR = {"concat_small": 0.15, "concat_wifi_small": 0.15,
             "concat_r56_small": 0.15, "concat_full": 0.15}
NOISEK_PRESETS = ("plain_small", "pa_l1024")

KINDS = ("torch", "torch_noisek", "torch_control_f32")
MIN_TRIALS = 10240       # a point's trials on the GPU (the script's :626)
SEED_BASE = 0            # block b of point p: block_generator(0, p, b)
WARMUP_BASE = 10 ** 6    # the warm-up block: block_generator(10**6, p, 0)
FAST_BATCH = 256         # fast_l4096's largest batch (the script's :373)
SAME_PRECISION_FLOOR = 0.02   # torch vs tpu, control vs torch (:519-535)
RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "..", "results"))


def get_cfg(preset: str):
    return CONCAT_PRESETS.get(preset) or PRESETS[preset]


def leg_kinds(preset: str) -> List[str]:
    """The kinds of leg a preset has."""
    kinds = ["torch"]
    if preset in NOISEK_PRESETS:
        kinds.append("torch_noisek")
    if preset in REL_FLOOR:
        kinds.append("torch_control_f32")
    return kinds


def leg_config(preset: str, kind: str):
    """The preset with the reference script's overrides for this kind:
    `run_tpu` (torch, torch_noisek), `run_tpu_concat` (torch on the
    concat presets), concat_f32_control.py (torch_control_f32)."""
    if kind not in leg_kinds(preset):
        raise ValueError(f"{preset} has no {kind!r} leg")
    cfg = get_cfg(preset)
    if kind == "torch_control_f32":
        return replace(cfg, sparc=replace(
            cfg.sparc, amp_kernel="xla", amp_tol=0.0,
            transform_precision="highest"),
            ldpc=replace(cfg.ldpc, engine="qc_xla"))
    if preset in CONCAT_PRESETS:
        return replace(cfg, sparc=replace(
            cfg.sparc, amp_kernel="fused_split", amp_tol=0.0,
            transform_precision="bf16", amp_noise_in_kernel=True))
    if preset == "fast_l4096":
        return cfg
    return replace(cfg, amp_kernel="fused_split", amp_tol=0.0,
                   transform_precision="bf16",
                   amp_noise_in_kernel=kind == "torch_noisek")


def leg_batch(preset: str, batch: int) -> int:
    return min(batch, FAST_BATCH) if preset == "fast_l4096" else batch


def out_path(out_dir: str, preset: str) -> str:
    return os.path.join(out_dir, f"ber_parity_torch_{preset}.jsonl")


def ref_path(ref_dir: str, preset: str) -> str:
    """The reference's legs of a preset (oracle, tpu, ...)."""
    return os.path.join(ref_dir, f"ber_parity_{preset}.jsonl")


def load_records(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def last_leg(recs: Sequence[dict], kind: str, ebno: float
             ) -> Optional[dict]:
    """The last record of `kind` at `ebno`, or None."""
    hits = [r for r in recs if r.get("kind") == kind
            and abs(r["ebno_db"] - ebno) < 1e-9]
    return hits[-1] if hits else None


def card_line() -> Optional[str]:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def source_digest() -> str:
    """sha1 of the port's source files (every .py, .cu, .cuh and .qc file
    under the package, by path and content): the code a record ran, also
    where the tree is not a checkout."""
    import hashlib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha1()
    for d, dirs, files in sorted(os.walk(root)):
        dirs[:] = sorted(x for x in dirs if x not in ("build", "__pycache__"))
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".cuh", ".qc")):
                path = os.path.join(d, f)
                h.update(os.path.relpath(path, root).encode() + b"\0")
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()[:12]


def tf32_off() -> bool:
    """Turn TF32 off for matmuls and cuDNN; whether any is still on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def _launch_counts() -> Dict[str, int]:
    from ..ops.amp_kernel import amp_fused
    from ..ops.bp_qc_kernel import bp_decode_qc_kernel
    from ..ops.denoiser import denoise_kernel
    from ..ops.fwht_kernel import fwht2

    return dict(amp_split=amp_fused.launches,
                amp_split_noise=amp_fused.noise_launches,
                amp_mono=amp_fused.mono_launches,
                amp_slab=amp_fused.slab_launches,
                bp_qc_layered=bp_decode_qc_kernel.launches,
                fwht2=fwht2.launches, denoise=denoise_kernel.launches)


def run_leg(preset: str, kind: str, point: int, trials: int, batch: int,
            device) -> dict:
    """Decode `trials` (rounded up to whole blocks of `batch`) at point
    index `point` of GRIDS[preset] with this kind's config.  The record
    (counters, rates, route, launches), without provenance."""
    from ..models.concat import ConcatModel
    from ..models.sparc import SparcModel
    from ..utils.rng import block_generator

    device = torch.device(device)
    cfg = leg_config(preset, kind)
    ebno = GRIDS[preset][point]
    batch = leg_batch(preset, batch)
    n_blocks = -(-trials // batch)
    allow_tf32 = tf32_off() if device.type == "cuda" else False
    if kind == "torch_control_f32" and allow_tf32:
        raise RuntimeError("the float32 control needs TF32 off")
    concat = isinstance(cfg, ConcatConfig)
    if concat:
        model = ConcatModel.build(cfg, ebno, device)
        sp, k_bits = model.sparc, model.k_user
    else:
        model = SparcModel.build(cfg, ebno, device)
        sp, k_bits = model, cfg.k_bits

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    model.run_block(block_generator(WARMUP_BASE, point, 0, device), batch)
    sync()
    warmup_s = time.perf_counter() - t0
    before = _launch_counts()
    outs = []
    t0 = time.perf_counter()
    for b in range(n_blocks):
        outs.append(model.run_block(
            block_generator(SEED_BASE, point, b, device), batch))
    sync()
    wall = time.perf_counter() - t0
    after = _launch_counts()

    def total(key, dtype=torch.int64):
        return torch.stack([o[key].to(dtype) for o in outs]).sum().item()

    tr = n_blocks * batch
    rec = dict(
        kind=kind, ebno_db=ebno, trials=tr, batch=batch,
        bit_errors=total("bit_errors"),
        bit_errors_sq=total("bit_errors_sq", torch.float64),
        frame_errors=total("frame_errors"), k_bits=k_bits, L=sp.cfg.L,
        wall_s=wall, warmup_s=warmup_s, bits_per_s=tr * k_bits / wall,
        kernel=sp.cfg.amp_kernel, noise_in_kernel=sp.noise_in_kernel,
        amp_iters=sp.cfg.amp_iters,
        mean_amp_iters=total("iters_sum") / tr,
        precision=sp.cfg.transform_precision, seed_base=SEED_BASE,
        allow_tf32=allow_tf32,
        launches={k: after[k] - before[k] for k in after
                  if after[k] != before[k]})
    rec["ber"] = rec["bit_errors"] / (tr * k_bits)
    rec["fer"] = rec["frame_errors"] / tr
    if concat:
        rec["bp_ok"] = total("bp_ok")
        rec["bp_engine"] = cfg.ldpc.engine
    else:
        rec["section_errors"] = total("section_errors")
        rec["ser"] = rec["section_errors"] / (tr * cfg.L)
    return rec


def run_legs(presets: Sequence[str], kinds: Optional[Sequence[str]],
             trials: int, batch: int, device, out_dir: str,
             ebnos: Optional[Sequence[float]] = None, force: bool = False,
             commit: Optional[str] = None) -> List[dict]:
    """Each (preset, point, kind) leg not yet on file at this commit:
    run_leg, then its record with provenance appended to
    out_path(out_dir, preset).  The records written."""
    from ..utils.provenance import artifact_meta

    device = torch.device(device)
    card = card_line() if device.type == "cuda" else None
    digest = source_digest()
    written = []
    for preset in presets:
        path = out_path(out_dir, preset)
        for kind in kinds or leg_kinds(preset):
            if kind not in leg_kinds(preset):
                continue
            meta = artifact_meta(preset, leg_config(preset, kind), device)
            if commit is not None:
                meta["commit"] = commit
            for point, ebno in enumerate(GRIDS[preset]):
                if ebnos and not any(abs(ebno - e) < 1e-9 for e in ebnos):
                    continue
                done = [r for r in load_records(path)
                        if r.get("kind") == kind
                        and abs(r["ebno_db"] - ebno) < 1e-9
                        and r.get("commit") == meta["commit"]]
                if done and not force:
                    print(f"{kind} {preset} @ {ebno}: already done at "
                          f"{meta['commit']}", flush=True)
                    continue
                rec = dict(run_leg(preset, kind, point, trials, batch,
                                   device), **meta, card=card,
                           source_sha1=digest, ts=time.time())
                os.makedirs(out_dir, exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                print(json.dumps(rec, sort_keys=True), flush=True)
                written.append(rec)
    return written


# ------------------------------------------------------------------ check

def ci(k, n):
    """95% binomial CI half-width (normal approx, floored at the 0-count
    Clopper-Pearson upper bound 3/n); the script's :450."""
    p = k / n
    return max(1.96 * math.sqrt(max(p * (1 - p), 0.0) / n), 3.0 / n)


def ci_ber(rec):
    """95% CI half-width on BER with frame-level clustering, from the
    per-frame second moment (the script's :456)."""
    tr, k = rec["trials"], rec["k_bits"]
    if "bit_errors_sq" not in rec:
        return ci(rec["bit_errors"], tr * k)
    mean_be = rec["bit_errors"] / tr
    var_be = max(rec["bit_errors_sq"] / tr - mean_be ** 2, 0.0)
    half = 1.96 * math.sqrt(var_be / tr) / k
    return max(half, 3.0 / (tr * k))


def compare(a: dict, b: dict, rel: float) -> dict:
    """|gap| of two legs' BER against the joint 95 % bound floored at
    `rel` of the larger BER."""
    gap = abs(a["ber"] - b["ber"])
    bound = max(math.hypot(ci_ber(a), ci_ber(b)),
                rel * max(a["ber"], b["ber"]))
    return dict(gap=gap, bound=bound, ok=gap <= bound)


def point_pairs(preset: str, ebno: float, mine: Sequence[dict],
                ref: Sequence[dict]):
    """The legs at one point (the reference's oracle and tpu, the port's
    kinds; None where missing) and the pairs `check` holds there,
    [(a, b, compare(legs[a], legs[b], floor))]: torch and torch_noisek
    against the oracle at REL_FLOOR, torch against tpu and
    torch_control_f32 against torch at 2 %.  The pairs are None when a
    leg is missing."""
    legs = dict(oracle=last_leg(ref, "oracle", ebno),
                tpu=last_leg(ref, "tpu", ebno),
                **{k: last_leg(mine, k, ebno) for k in leg_kinds(preset)})
    if any(r is None for r in legs.values()):
        return legs, None
    rel = REL_FLOOR.get(preset, 0.01)
    rules = [("torch", "oracle", rel), ("torch", "tpu", SAME_PRECISION_FLOOR),
             ("torch_noisek", "oracle", rel),
             ("torch_control_f32", "torch", SAME_PRECISION_FLOOR)]
    return legs, [(a, b, compare(legs[a], legs[b], floor))
                  for a, b, floor in rules if a in legs]


MARKDOWN_LEGS = ("oracle", "tpu", "torch", "torch_noisek",
                 "torch_control_f32")
MARKDOWN_PAIRS = (("torch", "oracle"), ("torch", "tpu"),
                  ("torch_noisek", "oracle"), ("torch_control_f32", "torch"))


def markdown_row(preset: str, ebno: float, legs: dict, pairs) -> str:
    """A point's legs (BER ± its 95 % CI half-width), verdicts and the
    torch leg's wall_s and Mbit/s as a markdown row."""
    verdict = {(a, b): "OK" if c["ok"] else "**APART**" for a, b, c in pairs}
    cells = [preset, str(ebno)]
    cells += [f"{legs[k]['ber']:.4e} ± {ci_ber(legs[k]):.1e}"
              if legs.get(k) else "—" for k in MARKDOWN_LEGS]
    cells += [verdict.get(p, "—") for p in MARKDOWN_PAIRS]
    t = legs["torch"]
    cells.append(f"{t['wall_s']:.2f}, {t['bits_per_s'] / 1e6:.1f}")
    return "| " + " | ".join(cells) + " |"


def check(presets: Sequence[str], out_dir: str = RESULTS,
          ref_dir: str = RESULTS, markdown: bool = False) -> bool:
    """Print the port's legs against the reference's legs on disk, a line
    a pair (or, with `markdown`, a table row a point); True when every
    required leg is there and every pair is within its bound."""
    ok = True
    if markdown:
        print("| preset | dB | oracle (float64) | JAX `tpu` | torch | "
              "torch_noisek | torch_control_f32 | torch vs oracle | "
              "torch vs `tpu` | noisek vs oracle | control vs torch | "
              "torch wall_s, Mbit/s |")
        print("|" + " --- |" * 12)
    for preset in presets:
        mine = load_records(out_path(out_dir, preset))
        ref = load_records(ref_path(ref_dir, preset))
        for ebno in GRIDS[preset]:
            legs, pairs = point_pairs(preset, ebno, mine, ref)
            if pairs is None:
                missing = ", ".join(k for k, r in legs.items() if r is None)
                print(f"| {preset} | {ebno} | missing: {missing} |"
                      if markdown else
                      f"{preset} @ {ebno}: MISSING {missing}")
                ok = False
                continue
            ok &= all(c["ok"] for _, _, c in pairs)
            if markdown:
                print(markdown_row(preset, ebno, legs, pairs))
                continue
            for a, b, c in pairs:
                print(f"{preset} @ {ebno}: {a} vs {b}: "
                      f"{legs[a]['ber']:.3e} vs {legs[b]['ber']:.3e} |gap| "
                      f"{c['gap']:.2e} joint95 {c['bound']:.2e} -> "
                      f"{'OK' if c['ok'] else 'APART'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparc_ldpc_tpu_torch.tools.ber_legs",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cmd", choices=["legs", "check"])
    ap.add_argument("--preset", action="append", choices=list(GRIDS),
                    default=None)
    ap.add_argument("--kind", action="append", choices=KINDS, default=None)
    ap.add_argument("--ebno", type=float, action="append", default=None,
                    help="only these points of the preset's grid")
    ap.add_argument("--trials", type=int, default=MIN_TRIALS)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--out-dir", default=RESULTS)
    ap.add_argument("--ref-dir", default=RESULTS,
                    help="where the reference's ber_parity_<preset>.jsonl "
                         "are (check)")
    ap.add_argument("--markdown", action="store_true",
                    help="check: print a markdown table, a row a point")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--force", action="store_true",
                    help="run a leg again although its record exists at "
                         "this commit (appends; check reads the last)")
    ap.add_argument("--commit", default=None,
                    help="the commit to record where the tree is not a git "
                         "checkout")
    args = ap.parse_args(argv)
    presets = args.preset or list(GRIDS)
    if args.cmd == "check":
        ok = check(presets, args.out_dir, args.ref_dir, args.markdown)
        return 0 if ok else 1
    if args.device == "cuda":
        from .. import default_device

        device = default_device()              # raises without a GPU
        trials = max(args.trials, MIN_TRIALS)
    else:
        device, trials = torch.device("cpu"), args.trials
    run_legs(presets, args.kind, trials, args.batch, device, args.out_dir,
             ebnos=args.ebno, force=args.force, commit=args.commit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
