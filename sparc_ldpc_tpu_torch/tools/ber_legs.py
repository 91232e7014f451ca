#!/usr/bin/env python3
"""BER/FER legs of the port, for the float64 oracle legs on disk (port of
the leg-running half of scripts/ber_parity.py, `run_tpu` and
`run_tpu_concat`, and of scripts/concat_f32_control.py).

    python -m sparc_ldpc_tpu_torch.tools.ber_legs legs [--preset P ...]
        [--kind K ...] [--ebno DB ...] [--seed-base 0|2] [--trials 10240]
        [--batch 512] [--out-dir results] [--device cuda|cpu] [--force]
        [--commit C]
    python -m sparc_ldpc_tpu_torch.tools.ber_legs check [--preset P ...]
        [--markdown]

`legs` decodes each point of GRIDS on the port and appends one JSON line
a leg to `<out-dir>/ber_parity_torch_<preset>.jsonl`.  Eight kinds, each
with the reference script's overrides of the preset (`leg_config`):

  torch              plain_small, pa_l1024: fused_split, amp_tol=0, bf16,
                     the noise drawn outside (K1); fast_l4096: the preset
                     verbatim at batch <= 256 (K1 at L=4096, its noise in
                     the kernel); the concat presets: fused_split,
                     amp_tol=0, bf16, the noise in the kernel (K1 twice a
                     block, then K2);
  torch_noisek       NOISEK_PRESETS: as torch, the noise drawn in K1
                     (its Philox stream);
  torch_control_f32  the REL_FLOOR presets and plain_small: the scan route
                     in float32 (amp_kernel="xla", amp_tol=0, "highest")
                     and, in a concat chain, the plain layered BP engine
                     (engine="qc_xla"): no hand-written kernel, TF32 off;
  torch_f64          plain_small: the control's draws and received words,
                     decoded by the scan route in float64 (state,
                     transforms, denoiser), and by the control's float32
                     route beside it.  The record counts the float64
                     decode and carries the paired statistic of the same
                     frames, `paired`: the float32 decode's counters and
                     the per-frame difference d = bit errors (float32) -
                     bit errors (float64), as its sum and sum of squares.

and four route kinds, each the torch leg's config (amp_tol, precision,
leg_batch) with only what names the route changed, the noise drawn
outside the kernel (ROUTE_PRESETS):

  torch_mono         amp_kernel="fused": the mono form, K6 (plain_small,
                     pa_l1024; concat_small, both AMP passes, then K2);
  torch_slab         amp_kernel="fused_slab": the slab form, K7 (the same
                     presets and fast_l4096);
  torch_sharded      the torch config on a virtual (1 x 2) mesh of the
                     device (S = 2): the section-sharded loop, K3 +
                     hypercube + K4;
  torch_pallas       amp_kernel="xla" with use_pallas, as `campaign
                     --pallas` runs it: the scan route on K5 and K4.

Where PAIRED_PRESETS has the preset, a route leg is paired: each block's
draws (SparcModel.run_block's, the noise outside) are decoded by the
kind's route and by its partner's (`partner_config`: K1 on the torch
config for mono, slab and sharded; the same config without use_pallas
for pallas), each as its own run_block decodes them.  The record counts
the kind's decode; `paired` holds the partner's counters and d = bit
errors (kind) - bit errors (partner) a frame, as its sum and sum of
squares.  On the GPU a route leg fails unless its kernels launched
(ROUTE_LAUNCHES): it never decodes on a plain version instead.

Block b of point p (p its index in GRIDS[preset]) draws from
`utils.rng.block_generator(seed_base, p, b)` on the model's device, with
`seed_base` 0 or 2 (SEED_BASES; base 1 was spent on diagnostics); a
warm-up block on `block_generator(WARMUP_BASE, p, 0)`, outside that
space, is left out of the counts and of `wall_s`.  On the GPU a point's
trials are max(--trials, MIN_TRIALS) rounded up to whole blocks; with
`--device cpu` (a rehearsal at a small size: such a record never stands
for the card) they are --trials rounded up.  TF32 is off for every leg
(`allow_tf32` in each record).  A record carries the reference's `tpu`
fields, `seed_base`, the launches of each hand-written kernel, the port's
`artifact_meta` (its `commit` from git, or --commit where the tree is not
a checkout), `source_sha1` (`source_digest`: the port's code as run) and
the card's `nvidia-smi` name and power limit.  A point whose record of
that kind and seed base exists at the same commit is skipped; --force
appends a new one.

`check` prints, point by point, the rules of the reference's `run_check`
for the port's legs beside the reference's `results/ber_parity_<preset>
.jsonl` (read only), each pair on both seed bases (`point_pairs`):
torch against the oracle (joint 95 % CI floored at REL_FLOOR, default
1 %), torch against the reference's own `tpu` leg and torch_control_f32
against torch (2 % floor), torch_noisek against the oracle,
torch_control_f32 against the reference's `control_f32xla` leg where it
has one (2 %), torch_f64 against the oracle (REL_FLOOR), each route kind
against the oracle (REL_FLOOR) and, where paired, against its partner on
the same frames (`paired_compare`: a base is outside when the whole 95 %
CI of the mean d lies beyond +- SAME_PRECISION_FLOOR of the partner's
mean bit errors a frame).  A pair is APART
only when its legs on both seed bases are outside the bound on the same
side (`replicated`).  For plain_small's float32 legs (torch,
torch_noisek) against the oracle the floor is max(REL_FLOOR, u), u the
upper end of the 95 % CI of the float32 shift that torch_f64 measured at
that point and base (`f32_shift`), where `c3_floor_holds`: torch_f64
inside the oracle rule and torch_control_f32 within 2 % of torch at every
plain_small point on both bases (the third condition of that rule,
tests/test_torch_c3_same_words.py, is a test of its own).  `check` exits
1 if a pair is APART or a required leg is missing.  With --markdown it
prints the same verdicts as a markdown table, a row a point, each leg's
BER with its 95 % CI half-width on each seed base, and the route kinds'
in a second table, a row a kind and point, with the mean d and its 95 %
CI half-width.

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

import numpy as np
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

# the route kinds: the presets each has a leg of, and those whose leg is
# paired with its partner's decode of the same draws
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
ROUTE_KINDS = tuple(ROUTE_PRESETS)
# the amp_kernel that names each route (torch_sharded keeps torch's)
ROUTE_KERNEL = {"torch_mono": "fused", "torch_slab": "fused_slab",
                "torch_pallas": "xla"}
# the launch counters each route leg must move on the GPU
ROUTE_LAUNCHES = {"torch_mono": ("amp_mono",), "torch_slab": ("amp_slab",),
                  "torch_sharded": ("fwht_tile", "denoise"),
                  "torch_pallas": ("fwht2", "denoise")}
SHARDS = 2               # torch_sharded's section shards
KINDS = ("torch", "torch_noisek", "torch_control_f32",
         "torch_f64") + ROUTE_KINDS
# plain_small's float32 shift at its waterfall (ROADMAP Queue C, C3): its
# float32 control and float64 legs
C3_PRESETS = ("plain_small",)
MIN_TRIALS = 10240       # a point's trials on the GPU (the script's :626)
SEED_BASE = 0            # block b of point p: block_generator(0, p, b)
SEED_BASES = (0, 2)      # the bases legs draw from; 1 is spent
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
    if preset in REL_FLOOR or preset in C3_PRESETS:
        kinds.append("torch_control_f32")
    if preset in C3_PRESETS:
        kinds.append("torch_f64")
    kinds += [k for k in ROUTE_KINDS if preset in ROUTE_PRESETS[k]]
    return kinds


def leg_config(preset: str, kind: str):
    """The preset with the reference script's overrides for this kind:
    `run_tpu` (torch, torch_noisek), `run_tpu_concat` (torch on the
    concat presets), concat_f32_control.py (torch_control_f32, on a
    SparcConfig the same SPARC overrides; torch_f64 decodes with the
    control's config, in float64).  A route kind: the torch config with
    ROUTE_KERNEL's amp_kernel (torch_sharded: the torch config)."""
    if kind not in leg_kinds(preset):
        raise ValueError(f"{preset} has no {kind!r} leg")
    if kind in ROUTE_KINDS:
        cfg = leg_config(preset, "torch")
        if kind not in ROUTE_KERNEL:
            return cfg
        if isinstance(cfg, SparcConfig):
            return replace(cfg, amp_kernel=ROUTE_KERNEL[kind])
        return replace(cfg, sparc=replace(cfg.sparc,
                                          amp_kernel=ROUTE_KERNEL[kind]))
    cfg = get_cfg(preset)
    if kind in ("torch_control_f32", "torch_f64"):
        f32 = dict(amp_kernel="xla", amp_tol=0.0,
                   transform_precision="highest")
        if isinstance(cfg, SparcConfig):
            return replace(cfg, **f32)
        return replace(cfg, sparc=replace(cfg.sparc, **f32),
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


def partner_config(preset: str, kind: str) -> SparcConfig:
    """The config of a paired route kind's partner: the torch leg's (K1)
    for mono, slab and sharded; torch_pallas's own, decoded without
    use_pallas."""
    return leg_config(preset, "torch_pallas" if kind == "torch_pallas"
                      else "torch")


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


def last_leg(recs: Sequence[dict], kind: str, ebno: float,
             seed_base: Optional[int] = None) -> Optional[dict]:
    """The last record of `kind` at `ebno` (drawn from `seed_base`, when
    given), or None."""
    hits = [r for r in recs if r.get("kind") == kind
            and abs(r["ebno_db"] - ebno) < 1e-9
            and (seed_base is None or r.get("seed_base") == seed_base)]
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
    from ..ops.amp_kernel import amp_fused, fwht_tile
    from ..ops.bp_qc_kernel import bp_decode_qc_kernel
    from ..ops.denoiser import denoise_kernel
    from ..ops.fwht_kernel import fwht2

    return dict(amp_split=amp_fused.launches,
                amp_split_noise=amp_fused.noise_launches,
                amp_mono=amp_fused.mono_launches,
                amp_slab=amp_fused.slab_launches,
                bp_qc_layered=bp_decode_qc_kernel.launches,
                fwht2=fwht2.launches, denoise=denoise_kernel.launches,
                fwht_tile=fwht_tile.launches)


def paired_block(model, gen: torch.Generator, batch: int, decodes
                 ) -> Dict[str, torch.Tensor]:
    """One paired block: `model`'s run_block draws from gen with the noise
    outside the kernel (bits, then float32 standard normals), decoded by
    each of `decodes`, two (prefix, decode) pairs with decode(bits, noise)
    -> per-frame bit_errors, section_errors and iters
    (SparcModel.frame_counts).  Each decode's counters under run_block's
    keys with its prefix; the per-frame d = bit errors (first) - bit
    errors (second) as `diff_sum` and `diff_sq`."""
    cfg, dev = model.cfg, model.device
    bits = torch.randint(0, 2, (batch, cfg.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    noise = torch.randn((batch, cfg.n), generator=gen, dtype=torch.float32,
                        device=dev)
    out = {}
    per_frame = []
    for tag, decode in decodes:
        f = decode(bits, noise)
        be = f["bit_errors"]
        per_frame.append(be)
        out.update({
            tag + "bit_errors": be.sum(),
            tag + "bit_errors_sq": (be.double() ** 2).sum(),
            tag + "frame_errors": (be > 0).sum(),
            tag + "section_errors": f["section_errors"].sum(),
            tag + "iters_sum": f["iters"].sum()})
    d = (per_frame[0] - per_frame[1]).double()
    out.update(diff_sum=d.sum(), diff_sq=(d * d).sum())
    return out


def f64_block(model, gen: torch.Generator, batch: int
              ) -> Dict[str, torch.Tensor]:
    """One torch_f64 block on `model` (the control's SparcModel): the
    control's draws from gen and its received words y, decoded by the
    model's float32 route and by the scan route in float64 from y cast up
    (paired_block).  The float64 decode's counters under run_block's keys;
    the float32 decode's as `f32_*`; the per-frame d = bit errors
    (float32) - bit errors (float64) as `diff_sum` and `diff_sq`."""
    from ..models.amp import amp_decode, hard_indices
    from ..utils.bits import bits_to_indices, indices_to_bits

    cfg, dev = model.cfg, model.device
    sq64 = torch.as_tensor(np.sqrt(cfg.n * model.p_alloc),
                           dtype=torch.float64, device=dev)
    sched = (None if model.tau2_schedule is None
             else model.tau2_schedule.double())

    def f64(bits, noise):
        y = model.encode(bits) + noise * math.sqrt(model.sigma2)
        res = amp_decode(y.double(), model.op, sq64, cfg.P, cfg.n,
                         T=cfg.amp_iters, tol=cfg.amp_tol,
                         tau2_schedule=sched,
                         residual_space=cfg.amp_residual_space)
        hat = hard_indices(res.beta)
        return dict(
            bit_errors=(bits != indices_to_bits(hat, cfg.logM)).sum(-1),
            section_errors=(bits_to_indices(bits, cfg.logM) != hat).sum(-1),
            iters=res.iters)

    return paired_block(model, gen, batch,
                        (("f32_", model.frame_counts), ("", f64)))


def route_models(preset: str, kind: str, ebno: float, device):
    """A route kind's SparcModel (torch_pallas with use_pallas,
    torch_sharded on a virtual (1 x SHARDS) mesh of `device`) and its
    partner's (None where the leg is not paired)."""
    from ..models.sparc import SparcModel
    from ..parallel.mesh import ShardingPolicy, make_mesh

    cfg = leg_config(preset, kind)
    policy = (ShardingPolicy(make_mesh(SHARDS, [device] * SHARDS))
              if kind == "torch_sharded" else None)
    model = SparcModel.build(cfg, ebno, device,
                             use_pallas=kind == "torch_pallas", policy=policy)
    partner = None
    if preset in PAIRED_PRESETS[kind]:
        partner = SparcModel.build(partner_config(preset, kind), ebno, device)
    return model, partner


def run_leg(preset: str, kind: str, point: int, trials: int, batch: int,
            device, seed_base: int = SEED_BASE) -> dict:
    """Decode `trials` (rounded up to whole blocks of `batch`) at point
    index `point` of GRIDS[preset] with this kind's config, block b drawn
    from block_generator(seed_base, point, b).  The record (counters,
    rates, route, launches), without provenance."""
    from ..models.concat import ConcatModel
    from ..models.sparc import SparcModel
    from ..utils.rng import block_generator

    if seed_base not in SEED_BASES:
        raise ValueError(f"seed base {seed_base} is not one of {SEED_BASES}")
    device = torch.device(device)
    cfg = leg_config(preset, kind)
    ebno = GRIDS[preset][point]
    batch = leg_batch(preset, batch)
    n_blocks = -(-trials // batch)
    allow_tf32 = tf32_off() if device.type == "cuda" else False
    if kind in ("torch_control_f32", "torch_f64") and allow_tf32:
        raise RuntimeError("the float32 control needs TF32 off")
    concat = isinstance(cfg, ConcatConfig)
    partner = None
    if concat:
        model = ConcatModel.build(cfg, ebno, device)
        sp, k_bits = model.sparc, model.k_user
    elif kind in ROUTE_KINDS:
        model, partner = route_models(preset, kind, ebno, device)
        sp, k_bits = model, cfg.k_bits
    else:
        model = SparcModel.build(cfg, ebno, device)
        sp, k_bits = model, cfg.k_bits
    if kind == "torch_f64":
        def block(gen, b):
            return f64_block(model, gen, b)
    elif partner is not None:
        def block(gen, b):
            return paired_block(model, gen, b,
                                (("", model.frame_counts),
                                 ("partner_", partner.frame_counts)))
    else:
        block = model.run_block

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    block(block_generator(WARMUP_BASE, point, 0, device), batch)
    sync()
    warmup_s = time.perf_counter() - t0
    before = _launch_counts()
    outs = []
    t0 = time.perf_counter()
    for b in range(n_blocks):
        outs.append(block(block_generator(seed_base, point, b, device),
                          batch))
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
        precision=sp.cfg.transform_precision, seed_base=seed_base,
        allow_tf32=allow_tf32, use_pallas=sp.use_pallas,
        section_shards=(1 if sp.policy is None
                        else sp.policy.section_shards),
        launches={k: after[k] - before[k] for k in after
                  if after[k] != before[k]})
    if device.type == "cuda" and kind in ROUTE_KINDS:
        idle = [k for k in ROUTE_LAUNCHES[kind]
                if not rec["launches"].get(k)]
        if idle:
            raise RuntimeError(f"the {kind} leg of {preset} @ {ebno} dB "
                               f"launched no {idle}: {rec['launches']}")
    rec["ber"] = rec["bit_errors"] / (tr * k_bits)
    rec["fer"] = rec["frame_errors"] / tr
    if concat:
        rec["bp_ok"] = total("bp_ok")
        rec["bp_engine"] = cfg.ldpc.engine
    else:
        rec["section_errors"] = total("section_errors")
        rec["ser"] = rec["section_errors"] / (tr * cfg.L)
    if kind == "torch_f64":
        rec["dtype"] = "float64"
        rec["paired"] = dict(
            f32_bit_errors=total("f32_bit_errors"),
            f32_bit_errors_sq=total("f32_bit_errors_sq", torch.float64),
            f32_frame_errors=total("f32_frame_errors"),
            f32_section_errors=total("f32_section_errors"),
            f32_mean_amp_iters=total("f32_iters_sum") / tr,
            diff_sum=total("diff_sum", torch.float64),
            diff_sq=total("diff_sq", torch.float64))
    if partner is not None:
        rec["paired"] = dict(
            partner_kernel=partner.cfg.amp_kernel,
            partner_use_pallas=partner.use_pallas,
            partner_bit_errors=total("partner_bit_errors"),
            partner_bit_errors_sq=total("partner_bit_errors_sq",
                                        torch.float64),
            partner_frame_errors=total("partner_frame_errors"),
            partner_section_errors=total("partner_section_errors"),
            partner_mean_amp_iters=total("partner_iters_sum") / tr,
            diff_sum=total("diff_sum", torch.float64),
            diff_sq=total("diff_sq", torch.float64))
    return rec


def run_legs(presets: Sequence[str], kinds: Optional[Sequence[str]],
             trials: int, batch: int, device, out_dir: str,
             ebnos: Optional[Sequence[float]] = None, force: bool = False,
             commit: Optional[str] = None,
             seed_base: int = SEED_BASE) -> List[dict]:
    """Each (preset, point, kind) leg of `seed_base` not yet on file at
    this commit: run_leg, then its record with provenance appended to
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
                        and r.get("seed_base") == seed_base
                        and r.get("commit") == meta["commit"]]
                if done and not force:
                    print(f"{kind} {preset} @ {ebno} (seed base "
                          f"{seed_base}): already done at "
                          f"{meta['commit']}", flush=True)
                    continue
                rec = dict(run_leg(preset, kind, point, trials, batch,
                                   device, seed_base), **meta, card=card,
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
    """a's BER minus b's (`diff`), its size (`gap`) against the joint 95 %
    bound floored at `rel` of the larger BER."""
    diff = a["ber"] - b["ber"]
    bound = max(math.hypot(ci_ber(a), ci_ber(b)),
                rel * max(a["ber"], b["ber"]))
    return dict(diff=diff, gap=abs(diff), bound=bound, ok=abs(diff) <= bound)


def replicated(cmps: Sequence[dict]) -> bool:
    """The replication rule: a pair is APART (False) only when its
    comparison on every seed base is outside the bound, all on the same
    side; OK (True) otherwise."""
    outside = [c for c in cmps if not c["ok"]]
    if len(outside) < len(cmps):
        return True
    return not (all(c["diff"] > 0 for c in outside)
                or all(c["diff"] < 0 for c in outside))


def f32_shift(f64: dict) -> Optional[dict]:
    """The float32 shift a torch_f64 record measured on its frames,
    relative to the float64 decode's bit errors: `rel` = sum(d) /
    bit_errors, d = bit errors (float32) - bit errors (float64) a frame,
    with the 95 % CI half-width of the paired mean (`half`) and its ends
    `lo`, `hi`.  None without float64 bit errors."""
    p, tr, be = f64["paired"], f64["trials"], f64["bit_errors"]
    if be <= 0:
        return None
    mean = p["diff_sum"] / tr
    var = max(p["diff_sq"] / tr - mean * mean, 0.0)
    rel = p["diff_sum"] / be
    half = 1.96 * math.sqrt(var / tr) * tr / be
    return dict(rel=rel, half=half, lo=rel - half, hi=rel + half)


def paired_compare(rec: dict) -> dict:
    """A paired route leg against its partner on the same frames: the mean
    per-frame d = bit errors (kind) - bit errors (partner) (`diff`) with
    its 95 % CI half-width (`half`) from the leg's sum and sum of squares;
    the bound is SAME_PRECISION_FLOOR of the partner's mean bit errors a
    frame, and the base is outside (ok False) when the whole CI lies
    beyond +- the bound."""
    p, tr = rec["paired"], rec["trials"]
    mean = p["diff_sum"] / tr
    half = 1.96 * math.sqrt(max(p["diff_sq"] / tr - mean * mean, 0.0) / tr)
    bound = SAME_PRECISION_FLOOR * p["partner_bit_errors"] / tr
    outside = mean - half > bound or mean + half < -bound
    return dict(diff=mean, half=half, gap=abs(mean), bound=bound,
                ok=not outside)


REF_KINDS = ("oracle", "tpu", "control_f32xla")
# (port kind, the leg it is held to): rule_floor gives each its floor;
# "paired" is a route kind's partner on the same frames (paired_compare)
PAIRS = (("torch", "oracle"), ("torch", "tpu"), ("torch_noisek", "oracle"),
         ("torch_control_f32", "torch"),
         ("torch_control_f32", "control_f32xla"), ("torch_f64", "oracle")
         ) + tuple((k, b) for k in ROUTE_KINDS for b in ("oracle", "paired"))


def port_legs(recs: Sequence[dict], preset: str, ebno: float) -> dict:
    """{(kind, seed_base): the last record or None} for every kind of the
    preset and every seed base."""
    return {(k, base): last_leg(recs, k, ebno, base)
            for k in leg_kinds(preset) for base in SEED_BASES}


def ref_legs(recs: Sequence[dict], preset: str, ebno: float) -> dict:
    """{kind: the reference's last record or None}: oracle, tpu and, for
    the concat presets, control_f32xla."""
    kinds = REF_KINDS if preset in CONCAT_PRESETS else REF_KINDS[:2]
    return {k: last_leg(recs, k, ebno) for k in kinds}


def c3_floor_holds(preset: str, mine: Sequence[dict],
                   ref: Sequence[dict]) -> bool:
    """Whether plain_small's float32 legs take the measured float32 shift
    as their oracle floor: at every point of the preset on every seed base,
    torch_f64 inside the oracle rule at REL_FLOOR (default 1 %) and
    torch_control_f32 within SAME_PRECISION_FLOOR of torch.  (The rule's
    third condition is tests/test_torch_c3_same_words.py.)"""
    if preset not in C3_PRESETS:
        return False
    rel = REL_FLOOR.get(preset, 0.01)
    for ebno in GRIDS[preset]:
        oracle = last_leg(ref, "oracle", ebno)
        for base in SEED_BASES:
            f64 = last_leg(mine, "torch_f64", ebno, base)
            ctl = last_leg(mine, "torch_control_f32", ebno, base)
            t = last_leg(mine, "torch", ebno, base)
            if None in (oracle, f64, ctl, t):
                return False
            if not (compare(f64, oracle, rel)["ok"]
                    and compare(ctl, t, SAME_PRECISION_FLOOR)["ok"]):
                return False
    return True


def rule_floor(preset: str, a: str, b: str, f64: Optional[dict],
               c3: bool) -> float:
    """The relative floor of pair (a, b): REL_FLOOR (default 1 %) against
    the oracle, SAME_PRECISION_FLOOR otherwise; for plain_small's float32
    legs against the oracle, where `c3` (c3_floor_holds), max(REL_FLOOR,
    the upper end of the float32 shift f64 measured)."""
    if b != "oracle":
        return SAME_PRECISION_FLOOR
    rel = REL_FLOOR.get(preset, 0.01)
    if c3 and a in ("torch", "torch_noisek") and f64 is not None:
        shift = f32_shift(f64)
        if shift is not None:
            rel = max(rel, shift["hi"])
    return rel


def point_pairs(preset: str, ebno: float, mine: Sequence[dict],
                ref: Sequence[dict], c3: Optional[bool] = None):
    """The legs at one point ({kind: record} of the reference,
    {(kind, seed_base): record} of the port, None where missing) and the
    pairs `check` holds there, [(a, b, {seed_base: compare}, ok)], ok by
    the replication rule; the floors are rule_floor's (c3 defaults to
    c3_floor_holds).  The pairs are None when a leg is missing."""
    legs = {**ref_legs(ref, preset, ebno), **port_legs(mine, preset, ebno)}
    if any(r is None for r in legs.values()):
        return legs, None
    if c3 is None:
        c3 = c3_floor_holds(preset, mine, ref)
    pairs = []
    for a, b in PAIRS:
        if a not in leg_kinds(preset):
            continue
        if b == "paired":
            if preset in PAIRED_PRESETS[a]:
                cmps = {base: dict(paired_compare(legs[(a, base)]),
                                   floor=SAME_PRECISION_FLOOR)
                        for base in SEED_BASES}
                pairs.append((a, b, cmps, replicated(list(cmps.values()))))
            continue
        if b not in leg_kinds(preset) and b not in legs:
            continue
        cmps = {}
        for base in SEED_BASES:
            leg_b = legs[b] if b in legs else legs[(b, base)]
            floor = rule_floor(preset, a, b, legs.get(("torch_f64", base)),
                               c3)
            cmps[base] = dict(compare(legs[(a, base)], leg_b, floor),
                              floor=floor)
        pairs.append((a, b, cmps, replicated(list(cmps.values()))))
    return legs, pairs


MARKDOWN_PORT = ("torch", "torch_noisek", "torch_control_f32", "torch_f64")
MARKDOWN_PAIRS = tuple(p for p in PAIRS if p[0] not in ROUTE_KINDS)


def _cell(rec: Optional[dict]) -> str:
    return f"{rec['ber']:.4e} ± {ci_ber(rec):.1e}" if rec else "—"


def markdown_header() -> List[str]:
    cols = (["preset", "dB", "oracle (float64)", "JAX `tpu`",
             "JAX `control_f32xla`"]
            + [f"{k} {base}" for k in MARKDOWN_PORT for base in SEED_BASES]
            + ["float32 shift vs float64 (base 0; 2)"]
            + [f"{a} vs {b}" for a, b in MARKDOWN_PAIRS]
            + ["torch wall_s, Mbit/s (base 0; 2)"])
    return ["| " + " | ".join(cols) + " |", "|" + " --- |" * len(cols)]


def markdown_row(preset: str, ebno: float, legs: dict, pairs) -> str:
    """A point's legs (BER ± its 95 % CI half-width, each seed base), the
    float32 shift torch_f64 measured (relative, ± its 95 % CI), the
    verdicts (with each base's in/out of its bound) and the torch legs'
    wall_s and Mbit/s as a markdown row."""
    cells = [preset, str(ebno)] + [_cell(legs.get(k)) for k in REF_KINDS]
    cells += [_cell(legs.get((k, base))) for k in MARKDOWN_PORT
              for base in SEED_BASES]
    shifts = [f32_shift(legs[("torch_f64", base)])
              if legs.get(("torch_f64", base)) else None
              for base in SEED_BASES]
    cells.append("; ".join(f"{s['rel']:+.1e} ± {s['half']:.1e}" if s
                           else "—" for s in shifts)
                 if any(shifts) else "—")
    verdict = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    cells += [_verdict(*verdict[p]) if p in verdict else "—"
              for p in MARKDOWN_PAIRS]
    cells.append("; ".join(
        f"{t['wall_s']:.2f}, {t['bits_per_s'] / 1e6:.1f}"
        for t in (legs[("torch", base)] for base in SEED_BASES)))
    return "| " + " | ".join(cells) + " |"


def _verdict(cmps: dict, ok: bool) -> str:
    sides = "/".join("in" if c["ok"] else "out" for c in cmps.values())
    return f"{'OK' if ok else '**APART**'} ({sides})"


def route_header() -> List[str]:
    cols = (["preset", "dB", "kind", "oracle (float64)"]
            + [f"kind {base}" for base in SEED_BASES]
            + [f"partner {base}" for base in SEED_BASES]
            + ["mean d a frame (base 0; 2)", "vs oracle", "vs partner",
               "wall_s (base 0; 2)"])
    return ["| " + " | ".join(cols) + " |", "|" + " --- |" * len(cols)]


def route_rows(preset: str, ebno: float, legs: dict, pairs) -> List[str]:
    """The route kinds' legs at one point, a markdown row a kind: BER ±
    its 95 % CI half-width on each seed base, the partner's BER on the
    same frames, the mean d ± its 95 % CI half-width, the verdicts (each
    base's in/out) and the legs' wall_s."""
    verdict = {(a, b): (cmps, ok) for a, b, cmps, ok in pairs}
    rows = []
    for kind in (k for k in ROUTE_KINDS if k in leg_kinds(preset)):
        recs = [legs[(kind, base)] for base in SEED_BASES]
        paired = (kind, "paired") in verdict
        cells = [preset, str(ebno), kind, _cell(legs["oracle"])]
        cells += [_cell(r) for r in recs]
        cells += [_cell(dict(trials=r["trials"], k_bits=r["k_bits"],
                             bit_errors=r["paired"]["partner_bit_errors"],
                             bit_errors_sq=r["paired"][
                                 "partner_bit_errors_sq"],
                             ber=r["paired"]["partner_bit_errors"]
                             / (r["trials"] * r["k_bits"])))
                  if paired else "—" for r in recs]
        cells.append("; ".join(
            f"{c['diff']:+.3f} ± {c['half']:.3f}"
            for c in verdict[(kind, "paired")][0].values())
            if paired else "—")
        cells.append(_verdict(*verdict[(kind, "oracle")]))
        cells.append(_verdict(*verdict[(kind, "paired")]) if paired
                     else "—")
        cells.append("; ".join(f"{r['wall_s']:.2f}" for r in recs))
        rows.append("| " + " | ".join(cells) + " |")
    return rows


def check(presets: Sequence[str], out_dir: str = RESULTS,
          ref_dir: str = RESULTS, markdown: bool = False) -> bool:
    """Print the port's legs against the reference's legs on disk, a line
    a pair and seed base (or, with `markdown`, a table row a point); True
    when every required leg is there and no pair is APART."""
    ok = True
    routes = []
    if markdown:
        print("\n".join(markdown_header()))
    for preset in presets:
        mine = load_records(out_path(out_dir, preset))
        ref = load_records(ref_path(ref_dir, preset))
        c3 = c3_floor_holds(preset, mine, ref)
        if preset in C3_PRESETS and not markdown:
            print(f"{preset}: the float32 legs' oracle floor is "
                  f"{'the measured float32 shift' if c3 else 'REL_FLOOR'}"
                  f" (c3_floor_holds: {c3})")
        for ebno in GRIDS[preset]:
            legs, pairs = point_pairs(preset, ebno, mine, ref, c3)
            if pairs is None:
                missing = ", ".join(
                    k if isinstance(k, str) else f"{k[0]} (seed base {k[1]})"
                    for k, r in legs.items() if r is None)
                print(f"| {preset} | {ebno} | missing: {missing} |"
                      if markdown else
                      f"{preset} @ {ebno}: MISSING {missing}")
                ok = False
                continue
            ok &= all(p_ok for _, _, _, p_ok in pairs)
            if markdown:
                print(markdown_row(preset, ebno, legs, pairs))
                routes += route_rows(preset, ebno, legs, pairs)
                continue
            for a, b, cmps, p_ok in pairs:
                for base, c in cmps.items():
                    if b == "paired":
                        print(f"{preset} @ {ebno}: {a} vs its partner on "
                              f"the same frames (seed base {base}): mean d "
                              f"{c['diff']:+.3e} ± {c['half']:.2e} a frame, "
                              f"bound ±{c['bound']:.3e} (2 % of the "
                              f"partner's) -> {'in' if c['ok'] else 'out'}")
                        continue
                    leg_b = legs[b] if b in legs else legs[(b, base)]
                    print(f"{preset} @ {ebno}: {a} vs {b} (seed base "
                          f"{base}): {legs[(a, base)]['ber']:.3e} vs "
                          f"{leg_b['ber']:.3e} |gap| {c['gap']:.2e} joint95 "
                          f"{c['bound']:.2e} (floor {c['floor']:.4f}) -> "
                          f"{'in' if c['ok'] else 'out'}")
                print(f"{preset} @ {ebno}: {a} vs {b} -> "
                      f"{'OK' if p_ok else 'APART'}")
    if routes:
        print("\n" + "\n".join(route_header() + routes))
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
    ap.add_argument("--seed-base", type=int, choices=SEED_BASES,
                    default=SEED_BASE,
                    help="block b of point p draws from "
                         "block_generator(seed_base, p, b)")
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
             ebnos=args.ebno, force=args.force, commit=args.commit,
             seed_base=args.seed_base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
