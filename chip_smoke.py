#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:

    python3 chip_smoke.py

It drives the port's headline decode (SparcModel.run_block on the
L=1024, M=512, R=1.0 configuration at 2.0 dB, B=2048) through the
hand-written CUDA kernel, in phases that each print one line:

  1. device: the GPU's name and `nvidia-smi` name and power limit;
  2. build: compiles sparc_ldpc_tpu_torch/csrc/*.cu with nvcc;
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
     version's ms per decode call at B=2048.

Then a JSON line with the kernel's record, the card's `nvidia-smi` line,
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


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
    _build.load_library()
    print(f"[2 build] {_build.library_path().name} from "
          f"{[p.name for p in sorted(_build.CSRC_DIR.glob('*.cu'))]}: nvcc "
          f"{nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s",
          flush=True)

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
        bk, tk = amp_fused(*args, encode_idx=idx, precision=prec)
        bp, tp = amp_fused_reference(*args, encode_idx=idx, precision=prec)
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

    def call_ms(fn, reps):
        ms = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

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

    require("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "amp_split", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
        "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:366",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
