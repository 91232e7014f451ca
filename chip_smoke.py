#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:

    python3 chip_smoke.py

It drives the port's two decode paths through the hand-written CUDA
kernels: the headline SPARC decode (SparcModel.run_block on the L=1024,
M=512, R=1.0 configuration at 2.0 dB, B=2048) and the concatenated
SPARC + LDPC decode (ConcatModel.run_block on PRESETS["concat"] at
3.0 dB, B=2048 frames), in phases that each print one line:

  1. device: the GPU's name and `nvidia-smi` name and power limit;
  2. build: compiles sparc_ldpc_tpu_torch/csrc/*.cu with nvcc, one
     compiler per source, all started together;
  3. kernel against its plain PyTorch version at full width (B=8,
     L=1024, M=512, T=22, same inputs).  In float32: margin-aware
     decisions (no flip where both sides' top-2 margin exceeds 2 %, at
     most 1 % flips), tau2 trace to rtol 1e-4, beta to 1e-3.  With the
     main path's bf16 operand rounding: tau2 trace to rtol 2e-2, at most
     1 % flips.  The transform stage alone, in float32, to 1e-5 of the
     output scale;
  4. main path: run_block at B=2048 through the kernel (launch count > 0),
     mean final tau2 within 3 % of the state-evolution fixed point, and
     the same seed twice gives identical counters;
  5. timing: median ms per block over 3 blocks (fresh generator and a
     scalar readback each) as bits/s, and the kernel's and the plain
     version's ms per decode call at B=2048;
  6. the AMP kernel's early stop, pinning and SE schedule against the
     plain version at full width (B=32, the concat configuration, T=32),
     with the phase-3 tolerances (the traces up to the first stop, beta
     on the codewords that stopped together).  With tol=1e-4, in float32
     each codeword's iteration count within 4 of the plain version's
     (the reference's rule); with bf16 rounding the stop is set by
     rounding noise on the plateau, so the mean counts within 2.  With
     40 % of the rows pinned to their true index, pinned rows exactly
     sq * one_hot.  With an SE schedule (designed with a 10 % noise
     margin: at exactly the operating point the SE trajectory ends below
     the tau2 an L=1024 decoder reaches, and the over-confident decoder
     is chaotic in either implementation), the trace equal to the
     schedule;
  7. the layered BP kernel against the plain layered engine, bitwise
     (hard, ok, iters, posterior): on the LLRs of a real concat block
     (12 288 codewords of the array code) and on seeded noisy LLRs of
     wifi_n648_r12, qc_n648_r56 and wifi_n1944_r12, min-sum and offset
     min-sum;
  8. concat main path: run_block at B=2048 through both kernels (both
     launch counts > 0), FER within 0.03 of the float64 oracle's 0.909,
     bp_ok within 0.01 of 0.995 of the codewords, BER within 0.5x-2x of
     1.62e-3 (results/ber_parity_concat_full.jsonl), the early stop
     engaged, and the same seed twice gives identical counters;
  9. timing: median ms per concat block over 3 blocks as user bits/s,
     the block's stages (main AMP, LLR fold, BP, feedback AMP) by CUDA
     events, and the BP kernel's and the plain engine's ms per call on
     the phase-7 LLRs.

Then a JSON line with the kernels' records, the card's `nvidia-smi` line,
and last `{"ok": true, "device": {...}}`.  Any failure raises (exit code
1); without a GPU it exits with code 1 before printing any result.
The port imports no JAX, and neither does this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
                amp_iters_auto=True, amp_noise_in_kernel=False)
METRIC = "amp_decoded_bits_per_s_per_chip_L1024_R1"
CONCAT_EBNO_DB = 3.0
CONCAT_METRIC = "concat_decoded_bits_per_s_per_chip_L1024"
# the float64 oracle's statistics at the concat point, 1000 frames
# (results/ber_parity_concat_full.jsonl); bp_ok from the reference's
# accelerator leg there (183 414 of 184 320 codewords)
ORACLE_FER, ORACLE_BER, REF_BP_OK = 0.909, 1.62e-3, 0.995
BP_CODES = (("wifi_n648_r12", 0.75), ("qc_n648_r56", 0.5),
            ("wifi_n1944_r12", 0.75))      # (code, noise sigma)
BP_BATCH = 4096       # codewords of each of BP_CODES in phase 7
OPTION_BATCH = 32     # codewords in phase 6
SCHED_MARGIN = 1.1    # phase 6's SE schedule is designed at 1.1 sigma2


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int) -> float:
    """Median device ms of fn() by CUDA events."""
    import torch

    ms = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


def concat_path(dev, card: str) -> tuple:
    """Phases 6-9: the concatenated SPARC + LDPC path.  Returns the main
    path's launch counts, the largest float32 beta error of phase 6 and
    the BP kernel's record for the JSON line."""
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

    preset = slt.PRESETS["concat"]
    cfg = preset.replace(sparc=preset.sparc.replace(amp_noise_in_kernel=False))
    t0 = time.perf_counter()
    cm = ConcatModel.build(cfg, CONCAT_EBNO_DB, dev)
    sm, lm = cm.sparc, cm.ldpc
    c = sm.cfg
    T, L, M, n = c.amp_iters, c.L, c.M, c.n
    sigma = float(np.sqrt(sm.sigma2))
    mask2d = sm.op.mask.reshape(L, M)
    print(f"[concat model] L={L} M={M} T={T} tol={c.amp_tol} feedback "
          f"{cfg.feedback_iters}; LDPC n={lm.n} k={lm.k} Z="
          f"{lm.qc_tables.Z}; Lu={cm.Lu} Lp={cm.Lp} num_cw={cm.num_cw} "
          f"k_user={cm.k_user}; build {time.perf_counter() - t0:.1f} s",
          flush=True)

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
    print(f"[6 amp options vs plain] B={B6} L={L} M={M} T={T}: {res6}",
          flush=True)
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
    print(f"[7 bp kernel vs plain] {res7}", flush=True)
    for k, r in res7.items():
        require(r["bitwise"], f"{k}: kernel and plain engine differ")

    # 8. concat main path
    amp_fused.launches = 0
    bp_decode_qc_kernel.launches = 0
    out = cm.run_block(block_generator(SEED, 4, 0, dev), BATCH)
    torch.cuda.synchronize()
    launches = dict(amp_split=amp_fused.launches,
                    bp_qc_layered=bp_decode_qc_kernel.launches)
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
          f"{'identical' if cnt2 == cnt else cnt2}", flush=True)
    require(launches["amp_split"] > 0 and launches["bp_qc_layered"] > 0,
            "the concat path did not launch both kernels")
    require(cnt["trials"] == BATCH, "trial count wrong")
    require(abs(fer - ORACLE_FER) <= 0.03, f"FER {fer} off the oracle")
    require(abs(bp_ok - REF_BP_OK) <= 0.01, f"bp_ok {bp_ok} off")
    require(0.5 * ORACLE_BER <= ber <= 2.0 * ORACLE_BER, f"BER {ber} off")
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
    y, _, idx = draw(BATCH, 2)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    res = sm.decode(y, encode_idx=idx)
    ev[1].record()
    llr_b = cm._protected_llrs_from_beta(res.beta)
    ev[2].record()
    cw_hat, ok, _ = cm._bp_from_llr(llr_b)
    ev[3].record()
    cm._feedback_user_bits(y, cw_hat, ok, enc_idx=idx)
    ev[4].record()
    torch.cuda.synchronize()
    stages = {k: round(ev[i].elapsed_time(ev[i + 1]), 3) for i, k in
              enumerate(("amp_main", "llr_fold", "bp", "feedback_amp"))}
    del res, llr_b, y
    kernel_ms = call_ms(lambda: bp_decode_qc_kernel(
        llr, lm.qc_shifts, lm.qc_tables.Z, **bp_kw), REPS)
    plain_ms = call_ms(lambda: bp_decode_qc(
        llr, lm.qc_tables, schedule="layered", **bp_kw), REPS)
    print(f"[9 timing] {CONCAT_METRIC} = {BATCH * cm.k_user / dt:.1f} "
          f"bits/s ({1e3 * dt:.2f} ms per block of {BATCH}, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) on {card}; one block's "
          f"stages, ms: {stages}; layered BP on the {llr.shape[0]} "
          f"codewords of phase 7: kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    return launches, max(errs), [{
        "name": "bp_qc_layered", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/bp_qc_layered.cu",
        "replaces": "sparc_ldpc_tpu/ops/bp_qc_pallas.py:70",
        "launches": launches["bp_qc_layered"],
        "max_abs_err": res7["concat block"]["max_abs_err"],
        "ms": kernel_ms, "plain_ms": plain_ms}]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        sys.exit(1)

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu.design.se import se_trajectory
    from sparc_ldpc_tpu_torch.models.amp import decision_flips
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.ops import _build
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference, fwht_tile, fwht_tile_reference)
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = slt.default_device()

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1 device] {name} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    for nm in _build.LIBRARIES:
        _build.load_library(nm)
    print(f"[2 build] {[_build.library_path(nm).name for nm in _build.LIBRARIES]}: "
          f"nvcc {nvcc_s:.1f} s (parallel), build+load "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = slt.SparcConfig(**HEADLINE)
    t0 = time.perf_counter()
    model = SparcModel.build(cfg, EBNO_DB, dev)
    c = model.cfg
    T, L, M, n = c.amp_iters, c.L, c.M, c.n
    sigma = float(np.sqrt(model.sigma2))
    mask2d = model.op.mask.reshape(L, M)
    print(f"[model] L={L} M={M} n={n} N={model.op.N} T={T} (SE-derived, cap "
          f"{cfg.amp_iters}) sigma2={model.sigma2:.6f}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
          f"{fw['highest']:.3e}, bf16 {fw['bf16']:.3e}", flush=True)
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

    # 4. main path
    se_fp = float(se_trajectory(model.p_alloc, n, M, model.sigma2, T=T)[-1])
    amp_fused.launches = 0
    out = model.run_block(block_generator(SEED, 0, 0, dev), BATCH)
    torch.cuda.synchronize()
    launches = amp_fused.launches
    cnt = {k: v.item() for k, v in out.items()}
    out2 = model.run_block(block_generator(SEED, 0, 0, dev), BATCH)
    cnt2 = {k: v.item() for k, v in out2.items()}
    tau_gap = cnt["tau2_final"] / se_fp - 1.0
    print(f"[4 main path] run_block B={BATCH}: amp_fused launches "
          f"{launches}; counters {cnt}; tau2_final vs SE fixed point "
          f"{se_fp:.4f}: {100 * tau_gap:+.2f} %; same seed again: "
          f"{'identical' if cnt2 == cnt else cnt2}", flush=True)
    require(launches > 0, "the main path did not launch the kernel")
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
    kernel_ms = call_ms(lambda: amp_fused(*args, encode_idx=idx), REPS)
    plain_ms = call_ms(lambda: amp_fused_reference(*args, encode_idx=idx),
                       REPS)
    print(f"[5 timing] {METRIC} = {bits_per_s:.1f} bits/s "
          f"({1e3 * dt:.2f} ms per block of {BATCH}, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) on {card}; decode "
          f"call at B={BATCH}: kernel {kernel_ms:.2f} ms, plain "
          f"{plain_ms:.2f} ms", flush=True)

    del y_n, idx, args
    concat_launches, concat_err, records = concat_path(dev, card)

    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "amp_split", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
        "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:366",
        "launches": concat_launches["amp_split"],
        "launches_by_path": {"sparc": launches,
                             "concat": concat_launches["amp_split"]},
        "max_abs_err": max(max_abs_err, concat_err),
        "ms": kernel_ms, "plain_ms": plain_ms}] + records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
