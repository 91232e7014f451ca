#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:

    python3 chip_smoke.py

It drives the port's paths through the hand-written CUDA kernels: the
headline SPARC decode (SparcModel.run_block on the L=1024, M=512, R=1.0
configuration at 2.0 dB, B=2048, with the shipped in-kernel channel
noise), the concatenated SPARC + LDPC decode (ConcatModel.run_block on
PRESETS["concat"] as shipped, 3.0 dB, B=2048 frames), and the campaign
CLI (`cli.main`) on the --pallas scan route of PRESETS["pa_l1024"] and on
the concat preset.  Each phase prints one line with its seconds:

  1. device: the GPU's name and `nvidia-smi` name and power limit;
  2. build: compiles sparc_ldpc_tpu_torch/csrc/*.cu with nvcc, one
     compiler per source, all started together;
  3. the AMP kernel against its plain PyTorch version at full width (B=8,
     L=1024, M=512, T=22, same inputs).  In float32: margin-aware
     decisions (no flip where both sides' top-2 margin exceeds 2 %, at
     most 1 % flips), tau2 trace to rtol 1e-4, beta to 1e-3.  With the
     main path's bf16 operand rounding: tau2 trace to rtol 2e-2, at most
     1 % flips.  The transform stage alone, in float32, to 1e-5 of the
     output scale;
  4. main path: run_block at B=2048 through the kernel with the noise
     drawn in the kernel (launch counts > 0), mean final tau2 within 3 %
     of the state-evolution fixed point, the same seed twice gives
     identical counters;
  5. timing: median ms per block over 3 blocks (fresh generator and a
     scalar readback each) as bits/s, and the kernel's (noise as input,
     and drawn in the kernel) and the plain version's ms per decode call;
  6. the AMP kernel's early stop, pinning and SE schedule against the
     plain version at full width (B=32, the concat configuration, T=32):
     in float32 each codeword's iteration count within 4, with bf16
     rounding the mean counts within 2; pinned rows exactly
     sq * one_hot; with an SE schedule designed at 1.1 sigma2, the trace
     equal to the schedule;
  7. the layered BP kernel against the plain layered engine, bitwise
     (hard, ok, iters, posterior), on the LLRs of a real concat block and
     on seeded noisy LLRs of wifi_n648_r12, qc_n648_r56 and
     wifi_n1944_r12, min-sum and offset min-sum;
  8. concat main path: run_block at B=2048 through both kernels, noise in
     the kernel; FER within 0.03 of the float64 oracle's 0.909, bp_ok
     within 0.01 of 0.995, BER within 0.5x-2x of 1.62e-3
     (results/ber_parity_concat_full.jsonl), the early stop engaged, the
     same seed twice gives identical counters;
  9. timing: median ms per concat block over 3 blocks as user bits/s, the
     block's stages (main AMP, LLR fold, BP, feedback AMP) by CUDA events,
     and the BP kernel's and the plain engine's ms per call;
 10. the in-kernel noise (K1 (e)): (a) the noise launch alone at B=64
     against its plain version: uniforms equal, normals within 1e-5,
     exact zeros off the row support, mean within 4 sigma / sqrt(count)
     and variance within 1 % over the B n draws; (b) the headline decode
     with the noise drawn in the kernel against the torch.randn route on
     the same bits, B=2048: section error rates within 4 joint standard
     errors (per frame); phase 4's tau2 and repeatability; (c) phase 8's
     block against a torch.randn-route block, both printed, phase 8's
     windows asserted;
 11. the FWHT kernel (K5, fwht2) against its plain version at (B=64,
     N=2^19) and (B=64, N=2^17) to 1e-5 of the output scale, and ms per
     call of both at B=64 and at the campaign's B=512;
 12. the denoiser kernel (K4) against its plain version at (B=64,
     L=1024, M=512) with tau2 from 1e-3 to 2 across the batch: finite,
     beta to rtol 1e-5 / atol 1e-6 max sq, post to atol 1e-7; ms per call
     of both at B=64 and B=512;
 13. the CLI in process: (a) `campaign --preset pa_l1024 --pallas` at
     3.0 dB, batch 512, 2048 trials: fwht2 and denoise launched, the AMP
     kernel not; BER within 0.8x-1.25x of the float64 oracle's 3.921e-3,
     FER >= 0.99 (results/ber_parity_pa_l1024.jsonl, kind oracle);
     bits_per_s not null; the record self-identifying; with the
     journal's last block removed, a rerun (under --profile, which
     gives the per-iteration stage times) reproduces bit_errors,
     frame_errors and trials; (b) `campaign --preset concat` as shipped,
     batch 2048, 4096 trials: phase 8's windows, and its bits_per_s
     printed beside phase 9's.

Counts of kernel launches are set to 0 before each path (phases 4, 8,
13a, 13b) and read after it.  Then a JSON line with the kernels' records,
the card's `nvidia-smi` line, and last `{"ok": true, "device": {...}}`.
Any failure raises (exit code 1); without a GPU it exits with code 1
before printing any result.  The port imports no JAX, nor does this
script.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

EBNO_DB = 2.0
BATCH = 2048          # codewords per block on the main path
CHECK_BATCH = 8       # codewords in the kernel-vs-plain comparison
SEED = 0
REPS = 3
HEADLINE = dict(L=1024, M=512, R=1.0, power_alloc="iterative",
                op_kind="hadamard", amp_kernel="fused_split",
                transform_precision="bf16", amp_iters=32, amp_tol=0.0,
                amp_iters_auto=True, amp_noise_in_kernel=True)
METRIC = "amp_decoded_bits_per_s_per_chip_L1024_R1"
CONCAT_EBNO_DB = 3.0
CONCAT_METRIC = "concat_decoded_bits_per_s_per_chip_L1024"
# the float64 oracle's statistics at the concat point, 1000 frames
# (results/ber_parity_concat_full.jsonl); bp_ok from the reference's
# accelerator leg there (183 414 of 184 320 codewords)
ORACLE_FER, ORACLE_BER, REF_BP_OK = 0.909, 1.62e-3, 0.995
# the float64 oracle at pa_l1024, 3.0 dB, 4000 frames
# (results/ber_parity_pa_l1024.jsonl, kind "oracle")
PA_EBNO_DB, PA_ORACLE_BER, PA_FER_MIN = 3.0, 3.921e-3, 0.99
BP_CODES = (("wifi_n648_r12", 0.75), ("qc_n648_r56", 0.5),
            ("wifi_n1944_r12", 0.75))      # (code, noise sigma)
BP_BATCH = 4096       # codewords of each of BP_CODES in phase 7
OPTION_BATCH = 32     # codewords in phase 6
SCHED_MARGIN = 1.1    # phase 6's SE schedule is designed at 1.1 sigma2
KERNEL_BATCH = 64     # rows of phases 10 (a), 11 and 12
CLI_BATCH = 512       # the --pallas campaign's batch


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Clock:
    """Seconds since the previous lap."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


def call_ms(fn, reps: int, inner: int = 1) -> float:
    """Median device ms of fn() by CUDA events (one warm-up call; each of
    the reps times `inner` calls back to back)."""
    import torch

    fn()
    ms = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / inner)
    return statistics.median(ms)


def reset_counts() -> None:
    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
    from sparc_ldpc_tpu_torch.ops.denoiser import denoise_kernel
    from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2

    for fn in (amp_fused, bp_decode_qc_kernel, denoise_kernel, fwht2):
        fn.launches = 0
    amp_fused.noise_launches = 0


def read_counts() -> dict:
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
    from sparc_ldpc_tpu_torch.ops.denoiser import denoise_kernel
    from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2

    torch.cuda.synchronize()
    return dict(amp_split=amp_fused.launches,
                amp_split_noise=amp_fused.noise_launches,
                bp_qc_layered=bp_decode_qc_kernel.launches,
                fwht2=fwht2.launches, denoise=denoise_kernel.launches)


def per_frame_z(err_a, err_b) -> float:
    """|mean_a - mean_b| over their joint standard error, per frame."""
    a, b = err_a.double(), err_b.double()
    se = math.sqrt(float(a.var()) / a.numel() + float(b.var()) / b.numel())
    return abs(float(a.mean()) - float(b.mean())) / max(se, 1e-300)


def sparc_path(dev, card: str, clock: Clock) -> dict:
    """Phases 3-5 on the headline model; returns what phases 10 and the
    JSON line need."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu.design.se import se_trajectory
    from sparc_ldpc_tpu_torch.models.amp import decision_flips
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference, fwht_tile, fwht_tile_reference)
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    cfg = slt.SparcConfig(**HEADLINE)
    model = SparcModel.build(cfg, EBNO_DB, dev)
    c = model.cfg
    T, L, M, n = c.amp_iters, c.L, c.M, c.n
    sigma = float(np.sqrt(model.sigma2))
    mask2d = model.op.mask.reshape(L, M)
    print(f"[model] L={L} M={M} n={n} N={model.op.N} T={T} (SE-derived, cap "
          f"{cfg.amp_iters}) sigma2={model.sigma2:.6f}; noise in kernel "
          f"{model.noise_in_kernel} ({clock.lap():.1f} s)", flush=True)
    require(model.noise_in_kernel, "the headline model must draw its noise "
            "in the kernel")

    def draw(batch, block):
        gen = block_generator(SEED, 1, block, dev)
        bits = torch.randint(0, 2, (batch, c.k_bits), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn((batch, n), generator=gen, device=dev)
        y_n = model.op.embed_y(noise * sigma).reshape(batch, L, M)
        return y_n, bits_to_indices(bits, c.logM)

    # 3. kernel against its plain version at full width.  In float32 the
    # two differ only in summation order.  With the main path's bf16
    # operand rounding, a value that lands on the other side of a rounding
    # boundary at a near-tie section is amplified over T iterations near
    # the AMP threshold, so there decisions are compared in count (and
    # section error rate), not one by one.
    y_n, idx = draw(CHECK_BATCH, 0)
    truth = idx.cpu().numpy()
    args = (y_n, mask2d, model.sq_npl, c.P, n, T)
    res = {}
    for prec in ("highest", "bf16"):
        bk, tk, _ = amp_fused(*args, encode_idx=idx, precision=prec)
        bp, tp, _ = amp_fused_reference(*args, encode_idx=idx,
                                        precision=prec)
        bk, bp, tk, tp = (v.cpu().numpy() for v in (bk, bp, tk, tp))
        require(np.isfinite(bk).all() and np.isfinite(tk).all(),
                f"{prec}: kernel output is not finite")
        flips, decisive = decision_flips(bk, bp)
        res[prec] = dict(
            flips=flips, decisive=decisive,
            tau2_rel_err=float(np.max(np.abs(tk - tp) / tp)),
            beta_abs_err=float(np.abs(bk - bp).max()),
            ser_kernel=float(np.mean(bk.argmax(-1) != truth)),
            ser_plain=float(np.mean(bp.argmax(-1) != truth)))
    x = torch.randn((CHECK_BATCH, L, M), generator=block_generator(
        SEED, 2, 0, dev), device=dev)
    fw = {}
    for prec in ("highest", "bf16"):
        ref = fwht_tile_reference(x, prec)
        fw[prec] = float((fwht_tile(x, prec) - ref).abs().max()
                         / ref.abs().max())
    print(f"[3 kernel vs plain] B={CHECK_BATCH} L={L} M={M} T={T} of "
          f"{CHECK_BATCH * L} sections: f32 {res['highest']}; bf16 "
          f"{res['bf16']}; transform alone, max err / max |out|: f32 "
          f"{fw['highest']:.3e}, bf16 {fw['bf16']:.3e} "
          f"({clock.lap():.1f} s)", flush=True)
    f32, b16 = res["highest"], res["bf16"]
    require(f32["decisive"] == 0, f"f32: {f32['decisive']} decisive flips")
    require(f32["flips"] <= 0.01 * CHECK_BATCH * L, "f32: flips > 1%")
    require(f32["tau2_rel_err"] <= 1e-4, "f32: tau2 rel err > 1e-4")
    require(f32["beta_abs_err"] <= 1e-3, "f32: beta abs err > 1e-3")
    require(b16["tau2_rel_err"] <= 2e-2, "bf16: tau2 rel err > 2e-2")
    require(b16["flips"] <= 0.01 * CHECK_BATCH * L, "bf16: flips > 1%")
    require(fw["highest"] <= 1e-5, f"f32 transform err {fw['highest']}")
    max_abs_err = f32["beta_abs_err"]
    del y_n, x

    # 4. main path, noise drawn in the kernel
    se_fp = float(se_trajectory(model.p_alloc, n, M, model.sigma2, T=T)[-1])
    reset_counts()
    out = model.run_block(block_generator(SEED, 0, 0, dev), BATCH)
    launches = read_counts()
    cnt = {k: v.item() for k, v in out.items()}
    out2 = model.run_block(block_generator(SEED, 0, 0, dev), BATCH)
    cnt2 = {k: v.item() for k, v in out2.items()}
    tau_gap = cnt["tau2_final"] / se_fp - 1.0
    print(f"[4 main path] run_block B={BATCH}: launches {launches}; "
          f"counters {cnt}; tau2_final vs SE fixed point {se_fp:.4f}: "
          f"{100 * tau_gap:+.2f} %; same seed again: "
          f"{'identical' if cnt2 == cnt else cnt2} ({clock.lap():.1f} s)",
          flush=True)
    require(launches["amp_split"] > 0, "the main path did not launch the "
            "kernel")
    require(launches["amp_split_noise"] == launches["amp_split"],
            "the main path did not draw its noise in the kernel")
    require(cnt["trials"] == BATCH and cnt["iters_sum"] == BATCH * T,
            "trial or iteration count wrong")
    require(0 <= cnt["section_errors"] <= BATCH * L
            and 0 <= cnt["bit_errors"] <= BATCH * c.k_bits,
            "counters out of range")
    require(abs(tau_gap) <= 0.03, f"tau2_final off SE by {tau_gap:+.3%}")
    require(cnt2 == cnt, "same seed gave different counters")

    # 5. timing
    times = []
    for r in range(REPS):
        gen = block_generator(SEED, 0, 1 + r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = int(model.run_block(gen, BATCH)["bit_errors"])
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    bits_per_s = BATCH * c.k_bits / dt

    y_n, idx = draw(BATCH, 1)
    args = (y_n, mask2d, model.sq_npl, c.P, n, T)
    seeds = model.draw_seeds(block_generator(SEED, 1, 2, dev), BATCH)
    kernel_ms = call_ms(lambda: amp_fused(*args, encode_idx=idx), REPS)
    noise_ms = call_ms(lambda: amp_fused(
        None, *args[1:], encode_idx=idx, noise_seed=seeds,
        noise_sigma=sigma), REPS)
    plain_ms = call_ms(lambda: amp_fused_reference(*args, encode_idx=idx),
                       REPS)
    print(f"[5 timing] {METRIC} = {bits_per_s:.1f} bits/s "
          f"({1e3 * dt:.2f} ms per block of {BATCH}, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) on {card}; decode "
          f"call at B={BATCH}: kernel {kernel_ms:.2f} ms with the noise as "
          f"input, {noise_ms:.2f} ms drawing it; plain {plain_ms:.2f} ms "
          f"({clock.lap():.1f} s)", flush=True)
    return dict(model=model, launches=launches, cnt=cnt, tau_gap=tau_gap,
                max_abs_err=max_abs_err, kernel_ms=kernel_ms,
                plain_ms=plain_ms, noise_ms=noise_ms)


def concat_path(dev, card: str, clock: Clock) -> dict:
    """Phases 6-9: the concatenated SPARC + LDPC path, as shipped."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu.design.ldpc_codes import build_code, qc_structure
    from sparc_ldpc_tpu.design.se import se_trajectory
    from sparc_ldpc_tpu_torch.models.amp import decision_flips
    from sparc_ldpc_tpu_torch.models.concat import ConcatModel
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference)
    from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    cfg = slt.PRESETS["concat"]
    cm = ConcatModel.build(cfg, CONCAT_EBNO_DB, dev)
    sm, lm = cm.sparc, cm.ldpc
    c = sm.cfg
    T, L, M, n = c.amp_iters, c.L, c.M, c.n
    sigma = float(np.sqrt(sm.sigma2))
    mask2d = sm.op.mask.reshape(L, M)
    print(f"[concat model] L={L} M={M} T={T} tol={c.amp_tol} feedback "
          f"{cfg.feedback_iters}; LDPC n={lm.n} k={lm.k} Z="
          f"{lm.qc_tables.Z}; Lu={cm.Lu} Lp={cm.Lp} num_cw={cm.num_cw} "
          f"k_user={cm.k_user}; noise in kernel {sm.noise_in_kernel} "
          f"({clock.lap():.1f} s)", flush=True)
    require(sm.noise_in_kernel, "the concat preset must draw its noise in "
            "the kernel")

    def draw(batch, block):
        """Channel noise on the row support and the true indices."""
        gen = block_generator(SEED, 3, block, dev)
        bits = torch.randint(0, 2, (batch, cm.k_user), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn((batch, n), generator=gen, device=dev)
        return (noise * sigma, sm.op.embed_y(noise * sigma).reshape(
            batch, L, M), cm._true_indices(bits))

    # 6. early stop, pinning and schedule against the plain version
    B6 = OPTION_BATCH
    _, y_n, idx = draw(B6, 0)
    args = (y_n, mask2d, sm.sq_npl, c.P, n, T)
    gen = block_generator(SEED, 5, 0, dev)
    # 40 % of the rows pinned to their true index, as decision feedback
    # pins verified sections
    rows = torch.rand((B6, L), generator=gen, device=dev) < 0.4
    pin = torch.where(rows, idx, -1).to(torch.int32)
    tr = se_trajectory(sm.p_alloc, n, M, SCHED_MARGIN * sm.sigma2, T=T)
    sched = torch.as_tensor(np.pad(tr[1:], (0, max(0, T - len(tr) + 1)),
                                   mode="edge")[:T], dtype=torch.float32,
                            device=dev)
    sqo_true = (sm.sq_npl * float(np.sqrt(n))) * (1.0 / float(np.sqrt(n)))
    want_pin = torch.where(torch.arange(M, device=dev) == pin[..., None],
                           sqo_true[None, :, None], 0.0)
    res6 = {}
    errs = []
    for label, opt in (("tol", dict(tol=1e-4)),
                       ("tol+pin", dict(tol=1e-4, pin_idx=pin)),
                       ("schedule", dict(tau2_schedule=sched))):
        for prec in ("highest", "bf16"):
            kw = dict(encode_idx=idx, precision=prec, **opt)
            bk, tk, ik = amp_fused(*args, **kw)
            bp, tp, ip = amp_fused_reference(*args, **kw)
            require(bool(torch.isfinite(bk).all() & torch.isfinite(tk).all()),
                    f"{label} {prec}: kernel output is not finite")
            t_min = int(min(ik.min(), ip.min()))
            same = ik == ip
            flips, decisive = decision_flips(bk, bp)
            r = dict(iters_kernel=ik.tolist(), iters_plain=ip.tolist(),
                     flips=flips, decisive=decisive,
                     ser_kernel=float((bk.argmax(-1) != idx).float().mean()),
                     ser_plain=float((bp.argmax(-1) != idx).float().mean()),
                     tau2_rel_err=float(((tk - tp).abs() / tp)[:t_min].max()),
                     beta_abs_err=float((bk - bp).abs()[same].max())
                     if bool(same.any()) else 0.0)
            if "pin_idx" in opt:
                r["pinned_rows_exact"] = bool(
                    torch.equal(bk[rows], want_pin[rows])
                    and torch.equal(bp[rows], want_pin[rows]))
            if "tau2_schedule" in opt:
                r["trace_is_schedule"] = bool(
                    torch.equal(tk, sched[:, None].expand(T, B6))
                    and torch.equal(tp, sched[:, None].expand(T, B6)))
            res6[f"{label} {prec}"] = r
    print(f"[6 amp options vs plain] B={B6} L={L} M={M} T={T}: {res6} "
          f"({clock.lap():.1f} s)", flush=True)
    for key, r in res6.items():
        f32 = key.endswith("highest")
        di = np.subtract(r["iters_kernel"], r["iters_plain"])
        if f32:
            require(int(np.abs(di).max()) <= 4,
                    f"{key}: iteration counts differ by more than 4")
        else:
            require(abs(float(di.mean())) <= 2,
                    f"{key}: mean iteration counts differ by more than 2")
        require(r["tau2_rel_err"] <= (1e-4 if f32 else 2e-2),
                f"{key}: tau2 rel err {r['tau2_rel_err']}")
        require(r["flips"] <= 0.01 * B6 * L, f"{key}: flips > 1%")
        if f32:
            require(r["decisive"] == 0, f"{key}: decisive flips")
            require(r["beta_abs_err"] <= 1e-3,
                    f"{key}: beta abs err {r['beta_abs_err']}")
            errs.append(r["beta_abs_err"])
        if key.startswith("tol"):
            require(min(r["iters_kernel"]) < T, f"{key}: no early stop")
        require(r.get("pinned_rows_exact", True),
                f"{key}: pinned rows are not sq * one_hot")
        require(r.get("trace_is_schedule", True),
                f"{key}: trace is not the schedule")
    del y_n, args

    # 7. the layered BP kernel against the plain layered engine, bitwise
    def bitwise(rk, rp):
        return all(torch.equal(getattr(rk, f), getattr(rp, f))
                   for f in ("hard", "ok", "iters", "posterior"))

    y, _, idx = draw(BATCH, 1)
    beta = sm.decode(y, encode_idx=idx).beta
    llr = cm._protected_llrs_from_beta(beta).reshape(BATCH * cm.num_cw, lm.n)
    del beta
    bp_kw = dict(iters=lm.cfg.bp_iters, method=lm.cfg.decoder,
                 alpha=lm.cfg.alpha, beta=lm.cfg.beta, clip=lm.cfg.llr_clip)
    rk = bp_decode_qc_kernel(llr, lm.qc_shifts, lm.qc_tables.Z, **bp_kw)
    rp = bp_decode_qc(llr, lm.qc_tables, schedule="layered", **bp_kw)
    res7 = {"concat block": dict(
        codewords=llr.shape[0], bitwise=bitwise(rk, rp),
        ok=int(rk.ok.sum()), iters_mean=float(rk.iters.float().mean()),
        max_abs_err=float((rk.posterior - rp.posterior).abs().max()))}
    for code, noise_sigma in BP_CODES:
        lcfg = slt.LdpcConfig(kind="qc", path=code)
        code_obj = build_code(lcfg)
        shifts, Z = qc_structure(lcfg)
        rng = np.random.default_rng(SEED)
        cw = code_obj.encode(rng.integers(0, 2, (BP_BATCH, code_obj.k)))
        yb = (1.0 - 2.0 * cw) + noise_sigma * rng.standard_normal(cw.shape)
        llr_c = torch.tensor(2.0 * yb / noise_sigma ** 2, dtype=torch.float32,
                             device=dev)
        sh = tuple(tuple(int(s) for s in row) for row in shifts)
        tables = QcBpTables.build(shifts, Z, device=dev)
        for method in ("minsum", "oms"):
            a = bp_decode_qc_kernel(llr_c, sh, Z, iters=32, method=method)
            b = bp_decode_qc(llr_c, tables, iters=32, method=method,
                             schedule="layered")
            res7[f"{code} {method}"] = dict(
                Z=Z, bitwise=bitwise(a, b), ok=int(a.ok.sum()),
                iters_mean=float(a.iters.float().mean()))
    print(f"[7 bp kernel vs plain] {res7} ({clock.lap():.1f} s)", flush=True)
    for k, r in res7.items():
        require(r["bitwise"], f"{k}: kernel and plain engine differ")

    # 8. concat main path, as shipped (noise drawn in the kernel)
    reset_counts()
    out = cm.run_block(block_generator(SEED, 4, 0, dev), BATCH)
    launches = read_counts()
    cnt = {k: v.item() for k, v in out.items()}
    cnt2 = {k: v.item() for k, v in cm.run_block(
        block_generator(SEED, 4, 0, dev), BATCH).items()}
    fer = cnt["frame_errors"] / BATCH
    ber = cnt["bit_errors"] / (BATCH * cm.k_user)
    bp_ok = cnt["bp_ok"] / (BATCH * cm.num_cw)
    print(f"[8 concat main path] run_block B={BATCH}: launches {launches}; "
          f"counters {cnt}; FER {fer:.4f} (oracle {ORACLE_FER}), BER "
          f"{ber:.4e} (oracle {ORACLE_BER}), bp_ok {bp_ok:.4f} "
          f"(reference {REF_BP_OK}), mean AMP iterations "
          f"{cnt['iters_sum'] / BATCH:.2f} of {T}; same seed again: "
          f"{'identical' if cnt2 == cnt else cnt2} ({clock.lap():.1f} s)",
          flush=True)
    require(launches["amp_split"] > 0 and launches["bp_qc_layered"] > 0,
            "the concat path did not launch both kernels")
    require(launches["amp_split_noise"] == launches["amp_split"] == 2,
            "both AMP passes must draw the noise in the kernel")
    require(cnt["trials"] == BATCH, "trial count wrong")
    require(concat_windows(fer, ber, bp_ok) == [],
            f"concat quality off: {concat_windows(fer, ber, bp_ok)}")
    require(cnt["iters_sum"] < BATCH * T, "the early stop did not engage")
    require(cnt2 == cnt, "same seed gave different counters")

    # 9. timing
    times = []
    for r in range(REPS):
        gen = block_generator(SEED, 4, 1 + r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = int(cm.run_block(gen, BATCH)["bit_errors"])
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    gen = block_generator(SEED, 3, 2, dev)
    bits = torch.randint(0, 2, (BATCH, cm.k_user), generator=gen,
                         dtype=torch.int32, device=dev)
    idx = cm._true_indices(bits)
    nkw = dict(noise_seed=sm.draw_seeds(gen, BATCH), noise_sigma=sigma)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    res = sm.decode(None, encode_idx=idx, **nkw)
    ev[1].record()
    llr_b = cm._protected_llrs_from_beta(res.beta)
    ev[2].record()
    cw_hat, ok, _ = cm._bp_from_llr(llr_b)
    ev[3].record()
    cm._feedback_user_bits(None, cw_hat, ok, enc_idx=idx, noise_kw=nkw)
    ev[4].record()
    torch.cuda.synchronize()
    stages = {k: round(ev[i].elapsed_time(ev[i + 1]), 3) for i, k in
              enumerate(("amp_main", "llr_fold", "bp", "feedback_amp"))}
    del res, llr_b, y
    kernel_ms = call_ms(lambda: bp_decode_qc_kernel(
        llr, lm.qc_shifts, lm.qc_tables.Z, **bp_kw), REPS)
    plain_ms = call_ms(lambda: bp_decode_qc(
        llr, lm.qc_tables, schedule="layered", **bp_kw), REPS)
    bits_per_s = BATCH * cm.k_user / dt
    print(f"[9 timing] {CONCAT_METRIC} = {bits_per_s:.1f} "
          f"bits/s ({1e3 * dt:.2f} ms per block of {BATCH}, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) on {card}; one block's "
          f"stages, ms: {stages}; layered BP on the {llr.shape[0]} "
          f"codewords of phase 7: kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms ({clock.lap():.1f} s)", flush=True)
    return dict(model=cm, launches=launches, cnt=cnt, fer=fer, ber=ber,
                bp_ok=bp_ok, max_abs_err=max(errs), bits_per_s=bits_per_s,
                bp_record={
                    "name": "bp_qc_layered", "route": "cuda",
                    "source": "sparc_ldpc_tpu_torch/csrc/bp_qc_layered.cu",
                    "replaces": "sparc_ldpc_tpu/ops/bp_qc_pallas.py:70",
                    "max_abs_err": res7["concat block"]["max_abs_err"],
                    "ms": kernel_ms, "plain_ms": plain_ms})


def concat_windows(fer: float, ber: float, bp_ok: float) -> list:
    """The concat quality windows that a block misses."""
    bad = []
    if abs(fer - ORACLE_FER) > 0.03:
        bad.append(f"FER {fer}")
    if not 0.5 * ORACLE_BER <= ber <= 2.0 * ORACLE_BER:
        bad.append(f"BER {ber}")
    if abs(bp_ok - REF_BP_OK) > 0.01:
        bad.append(f"bp_ok {bp_ok}")
    return bad


def noise_phase(dev, sp: dict, cp: dict, clock: Clock) -> float:
    """Phase 10: the in-kernel noise against its plain version and against
    the torch.randn route.  Returns the largest normal error."""
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        channel_noise, channel_noise_reference, noise_uniforms,
        noise_uniforms_reference)
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    model = sp["model"]
    c = model.cfg
    L, M, n = c.L, c.M, c.n
    mask2d = model.op.mask.reshape(L, M)

    # (a) the noise launch alone
    seeds = model.draw_seeds(block_generator(SEED, 6, 0, dev), KERNEL_BATCH)
    u1k, thk = noise_uniforms(seeds, L, M)
    u1p, thp = noise_uniforms_reference(seeds, L, M)
    uniforms_equal = bool(torch.equal(u1k, u1p) and torch.equal(thk, thp))
    del u1k, thk, u1p, thp
    zk = channel_noise(seeds, mask2d, 1.0)
    zp = channel_noise_reference(seeds, mask2d, 1.0)
    normal_err = float((zk - zp).abs().max())
    off_zero = bool((zk[:, mask2d == 0] == 0).all())
    on = zk[:, mask2d > 0].double()
    count = on.numel()
    mean, var = float(on.mean()), float(on.var())
    del zk, zp, on
    print(f"[10a noise vs plain] B={KERNEL_BATCH} L={L} M={M}: uniforms "
          f"equal {uniforms_equal}; normals max err {normal_err:.3e}; zero "
          f"off the row support {off_zero}; {count} draws: mean {mean:.3e} "
          f"(limit {4 / math.sqrt(count):.3e}), variance {var:.5f} "
          f"({clock.lap():.1f} s)", flush=True)
    require(uniforms_equal, "kernel and plain uniforms differ")
    require(normal_err <= 1e-5, f"normals differ by {normal_err}")
    require(off_zero, "noise off the row support")
    require(count == KERNEL_BATCH * n, "draw count is not B n")
    require(abs(mean) <= 4 / math.sqrt(count), f"noise mean {mean}")
    require(abs(var - 1.0) <= 0.01, f"noise variance {var}")

    # (b) the headline decode: noise drawn in the kernel vs torch.randn
    gen = block_generator(SEED, 7, 0, dev)
    bits = torch.randint(0, 2, (BATCH, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    idx = bits_to_indices(bits, c.logM)
    seeds = model.draw_seeds(gen, BATCH)
    noise = torch.randn((BATCH, n), generator=gen, device=dev)
    sigma = math.sqrt(model.sigma2)
    rk = model.decode(None, encode_idx=idx, noise_seed=seeds,
                      noise_sigma=sigma)
    ser_k = (rk.beta.argmax(-1) != idx).double().mean(-1)
    tau_k = float(rk.tau2_trace[-1].mean())
    del rk
    rr = model.decode(noise * sigma, encode_idx=idx)
    ser_r = (rr.beta.argmax(-1) != idx).double().mean(-1)
    tau_r = float(rr.tau2_trace[-1].mean())
    del rr
    z = per_frame_z(ser_k, ser_r)
    print(f"[10b noise route vs torch.randn route] B={BATCH}: section "
          f"error rate {float(ser_k.mean()):.5e} vs {float(ser_r.mean()):.5e}"
          f" ({z:.2f} joint standard errors); mean final tau2 {tau_k:.5f} vs"
          f" {tau_r:.5f}; phase 4: tau2 {100 * sp['tau_gap']:+.2f} % off SE,"
          f" identical counters per seed ({clock.lap():.1f} s)", flush=True)
    require(z <= 4, f"section error rates differ by {z:.2f} standard errors")

    # (c) the concat block: phase 8 (noise in the kernel) vs torch.randn
    cm = cp["model"]
    gen = block_generator(SEED, 8, 0, dev)
    bits = torch.randint(0, 2, (BATCH, cm.k_user), generator=gen,
                         dtype=torch.int32, device=dev)
    noise = torch.randn((BATCH, n), generator=gen, device=dev)
    cr = {k: v.item() for k, v in cm._block(bits, noise).items()}
    fer_r = cr["frame_errors"] / BATCH
    ber_r = cr["bit_errors"] / (BATCH * cm.k_user)
    bp_r = cr["bp_ok"] / (BATCH * cm.num_cw)
    print(f"[10c concat noise route vs torch.randn route] B={BATCH}: FER "
          f"{cp['fer']:.4f} vs {fer_r:.4f}, BER {cp['ber']:.4e} vs "
          f"{ber_r:.4e}, bp_ok {cp['bp_ok']:.4f} vs {bp_r:.4f} "
          f"({clock.lap():.1f} s)", flush=True)
    require(concat_windows(cp["fer"], cp["ber"], cp["bp_ok"]) == [],
            "the noise route's concat block is off the oracle windows")
    return normal_err


def fwht_phase(dev, card: str, clock: Clock) -> dict:
    """Phase 11: K5 (fwht2) against its plain version."""
    import torch

    from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2, fwht2_reference
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    gen = block_generator(SEED, 9, 0, dev)
    res = {}
    err_abs = 0.0
    for logn in (19, 17):
        x = torch.randn((KERNEL_BATCH, 1 << logn), generator=gen, device=dev)
        ref = fwht2_reference(x)
        err = float((fwht2(x) - ref).abs().max())
        res[f"2^{logn}"] = err / float(ref.abs().max())
        err_abs = max(err_abs, err)
    ms = {}
    for B in (KERNEL_BATCH, CLI_BATCH):
        x = torch.randn((B, 1 << 19), generator=gen, device=dev)
        ms[B] = (call_ms(lambda: fwht2(x), REPS, inner=10),
                 call_ms(lambda: fwht2_reference(x), REPS, inner=2))
    del x, ref
    print(f"[11 fwht2 vs plain] max err / max |out| at B={KERNEL_BATCH}: "
          f"{res}; ms per call at N=2^19 (kernel, plain): {ms} on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    for k, v in res.items():
        require(v <= 1e-5, f"fwht2 at N={k}: error {v}")
    return {"name": "fwht2", "route": "cuda",
            "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
            "replaces": "sparc_ldpc_tpu/ops/fwht.py:271",
            "max_abs_err": err_abs, "ms": ms[CLI_BATCH][0],
            "plain_ms": ms[CLI_BATCH][1]}


def denoise_phase(dev, sq_npl, card: str, clock: Clock) -> dict:
    """Phase 12: K4 (denoise_kernel) against its plain version."""
    import torch

    from sparc_ldpc_tpu_torch.ops.denoiser import denoise, denoise_kernel
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    L, M = HEADLINE["L"], HEADLINE["M"]
    gen = block_generator(SEED, 10, 0, dev)
    s = torch.randn((KERNEL_BATCH, L, M), generator=gen, device=dev)
    tau2 = torch.logspace(-3, math.log10(2.0), KERNEL_BATCH, device=dev)
    bk, pk = denoise_kernel(s, tau2, sq_npl)
    bp, pp = denoise(s, tau2, sq_npl)
    finite = bool(torch.isfinite(bk).all() & torch.isfinite(pk).all())
    atol_b = 1e-6 * float(sq_npl.max())
    ok_b = bool(torch.allclose(bk, bp, rtol=1e-5, atol=atol_b))
    ok_p = bool(torch.allclose(pk, pp, rtol=1e-5, atol=1e-7))
    err_b = float((bk - bp).abs().max())
    err_p = float((pk - pp).abs().max())
    del bk, pk, bp, pp
    ms = {}
    for B in (KERNEL_BATCH, CLI_BATCH):
        x = (s if B == KERNEL_BATCH else torch.randn(
            (B, L, M), generator=gen, device=dev))
        t2 = torch.logspace(-3, math.log10(2.0), B, device=dev)
        ms[B] = (call_ms(lambda: denoise_kernel(x, t2, sq_npl), REPS,
                         inner=10),
                 call_ms(lambda: denoise(x, t2, sq_npl), REPS, inner=2))
    del s, x
    print(f"[12 denoise vs plain] B={KERNEL_BATCH} L={L} M={M}, tau2 1e-3 "
          f"to 2: finite {finite}; beta max err {err_b:.3e} (atol "
          f"{atol_b:.3e}, rtol 1e-5: {ok_b}), post max err {err_p:.3e} "
          f"(atol 1e-7, rtol 1e-5: {ok_p}); ms per call (kernel, plain): "
          f"{ms} on {card} ({clock.lap():.1f} s)", flush=True)
    require(finite, "the denoiser kernel gave inf or nan")
    require(ok_b and ok_p, "the denoiser kernel disagrees with its plain "
            "version")
    return {"name": "denoise", "route": "cuda",
            "source": "sparc_ldpc_tpu_torch/csrc/denoise.cu",
            "replaces": "sparc_ldpc_tpu/ops/denoiser.py:40",
            "max_abs_err": err_b, "ms": ms[CLI_BATCH][0],
            "plain_ms": ms[CLI_BATCH][1]}


def last_record(path: str) -> dict:
    with open(path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def trace_stages(path: str, T: int) -> dict:
    """Device ms per AMP iteration by kernel family, from a torch.profiler
    Chrome trace of one block."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    fam = {}
    total = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name, us = e.get("name", ""), float(e.get("dur", 0.0))
        key = ("fwht2 rows" if "fwht_rows_kernel" in name else
               "fwht2 cols" if "fwht_cols_kernel" in name else
               "denoise" if "denoise_kernel" in name else
               "gather/scatter" if ("index" in name or "scatter" in name
                                    or "gather" in name) else
               "other torch ops")
        fam[key] = fam.get(key, 0.0) + us
        total += us
    out = {k: round(v / 1e3 / T, 4) for k, v in sorted(fam.items())}
    out["all kernels, ms per block"] = round(total / 1e3, 3)
    return out


def cli_phase(dev, card: str, cp: dict, clock: Clock) -> dict:
    """Phase 13: the campaign CLI in process."""
    from sparc_ldpc_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # (a) pa_l1024 on the --pallas scan route
        out = os.path.join(tmp, "pa.jsonl")
        argv = ["campaign", "--preset", "pa_l1024", "--pallas", "--ebno",
                str(PA_EBNO_DB), "--batch", str(CLI_BATCH), "--max-trials",
                "2048", "--min-frame-errors", "1000000", "--out", out]
        reset_counts()
        require(cli.main(argv) == 0, "the pa_l1024 campaign failed")
        la = read_counts()
        rec = last_record(out)
        journal = out + ".journal"
        with open(journal) as f:
            lines = f.read().strip().splitlines()
        with open(journal, "w") as f:
            f.write("\n".join(lines[:-1]) + "\n")
        prof = os.path.join(tmp, "prof")
        require(cli.main(argv + ["--profile", prof]) == 0,
                "the resumed pa_l1024 campaign failed")
        rec2 = last_record(out)
        stages = trace_stages(os.path.join(prof, "trace.json"), 32)
        same = all(rec[k] == rec2[k]
                   for k in ("bit_errors", "frame_errors", "trials"))
        print(f"[13a cli pa_l1024 --pallas] launches {la}; record {rec}; "
              f"resumed after dropping the last of {len(lines)} journaled "
              f"blocks: {rec2['exec_blocks']} block executed, counters "
              f"{'identical' if same else rec2}; one resumed block under "
              f"torch.profiler, device ms per AMP iteration: {stages} on "
              f"{card} ({clock.lap():.1f} s)", flush=True)
        require(la["fwht2"] > 0 and la["denoise"] > 0,
                "the --pallas route did not launch fwht2 and denoise")
        require(la["amp_split"] == 0, "the --pallas route launched the "
                "fused AMP kernel")
        require(0.8 * PA_ORACLE_BER <= rec["ber"] <= 1.25 * PA_ORACLE_BER,
                f"pa_l1024 BER {rec['ber']} off the oracle's "
                f"{PA_ORACLE_BER}")
        require(rec["fer"] >= PA_FER_MIN, f"pa_l1024 FER {rec['fer']}")
        require(rec["bits_per_s"] is not None, "no steady bits/s")
        for k in ("preset", "config_hash", "commit", "backend", "device"):
            require(k in rec, f"the record has no {k}")
        require(rec["backend"] == "torch-cuda", "backend is not torch-cuda")
        require(same, "the resumed campaign's counters differ")

        # (b) the concat preset as shipped
        out = os.path.join(tmp, "concat.jsonl")
        argv = ["campaign", "--preset", "concat", "--ebno",
                str(CONCAT_EBNO_DB), "--batch", str(BATCH), "--max-trials",
                "4096", "--out", out]
        reset_counts()
        require(cli.main(argv) == 0, "the concat campaign failed")
        lb = read_counts()
        rec = last_record(out)
        with open(out + ".journal") as f:
            bp_ok_sum = sum(json.loads(x)["bp_ok"] for x in f if x.strip())
        cm = cp["model"]
        bp_ok = bp_ok_sum / (rec["trials"] * cm.num_cw)
        print(f"[13b cli concat] launches {lb}; FER {rec['fer']:.4f}, BER "
              f"{rec['ber']:.4e}, bp_ok {bp_ok:.4f}, trials {rec['trials']}"
              f" in {rec['blocks']} blocks; bits_per_s {rec['bits_per_s']} "
              f"(pipelined campaign) vs {cp['bits_per_s']:.1f} (phase 9, "
              f"one block at a time) on {card} ({clock.lap():.1f} s)",
              flush=True)
        require(lb["amp_split_noise"] > 0 and lb["bp_qc_layered"] > 0,
                "the concat campaign did not launch both kernels")
        require(concat_windows(rec["fer"], rec["ber"], bp_ok) == [],
                f"concat campaign off: "
                f"{concat_windows(rec['fer'], rec['ber'], bp_ok)}")
        return dict(cli_pallas=la, cli_concat=lb)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        sys.exit(1)

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = slt.default_device()
    clock = Clock()
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1 device] {name} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32} ({clock.lap():.1f} s)",
          flush=True)

    # 2. build
    nvcc_s = _build.build()
    for nm in _build.LIBRARIES:
        _build.load_library(nm)
    print(f"[2 build] {[_build.library_path(nm).name for nm in _build.LIBRARIES]}: "
          f"nvcc {nvcc_s:.1f} s (parallel) ({clock.lap():.1f} s)", flush=True)

    sp = sparc_path(dev, card, clock)
    cp = concat_path(dev, card, clock)
    noise_err = noise_phase(dev, sp, cp, clock)
    fw_rec = fwht_phase(dev, card, clock)
    dn_rec = denoise_phase(dev, sp["model"].sq_npl, card, clock)
    cl = cli_phase(dev, card, cp, clock)

    require("jax" not in sys.modules, "jax was imported")
    paths = dict(sparc=sp["launches"], concat=cp["launches"], **cl)

    def by_path(key):
        return {p: c[key] for p, c in paths.items() if c[key]}

    def total(key):
        return sum(c[key] for c in paths.values())

    for rec, key in ((fw_rec, "fwht2"), (dn_rec, "denoise")):
        rec["launches"] = total(key)
        rec["launches_by_path"] = by_path(key)
        require(rec["launches"] > 0, f"{key} was never launched")
    bp_rec = cp["bp_record"]
    bp_rec["launches"] = total("bp_qc_layered")
    bp_rec["launches_by_path"] = by_path("bp_qc_layered")
    amp_paths = by_path("amp_split")
    amp_paths["noise"] = total("amp_split_noise")
    amp_rec = {
        "name": "amp_split", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
        "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:366",
        "launches": total("amp_split"), "launches_by_path": amp_paths,
        "max_abs_err": max(sp["max_abs_err"], cp["max_abs_err"], noise_err),
        "ms": sp["kernel_ms"], "plain_ms": sp["plain_ms"],
        "noise_ms": sp["noise_ms"]}
    for rec in (amp_rec, bp_rec):
        require(rec["launches"] > 0, f"{rec['name']} was never launched")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [amp_rec, bp_rec, fw_rec, dn_rec]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
