#!/usr/bin/env python3
"""Time the AMP kernels' calls of two or more source trees on one GPU,
interleaved, to tell a code change from drift of the card.

    python3 sparc_ldpc_tpu_torch/tools/amp_ab.py TREE ... \
        [--l4096 | --form mono | --form slab | --k3 | --k5 | --k2 |
         --dense-strip] [--compare] [--out results.json]

Each TREE is a directory that holds a `sparc_ldpc_tpu_torch/` package (the
repository root, or an unpacked `git archive` of another commit); list the
trees in the order to run them, e.g. `old new new old`.  Each runs in a
process of its own, which builds that tree's kernels and times the split
form's (K1's) decode call: at the headline shape L=1024, M=512, T=22
fixed, B=2048 (with --l4096: fast_l4096's L=4096, M=512, n=24576, B=512,
T=32 fixed), bf16, with the in-kernel encode, once with the noise as an
input and once drawn in the kernel (median of 5 calls each, CUDA events),
and the device ms of the encode and per iteration of the column and row
stages from one torch.profiler trace.  The inputs are synthetic (a random
row support of n of the L M positions, flat power, sigma2 of 2.0 dB at
R = 1): at fixed T the kernel's work does not depend on the data; a tree
whose `amp_fused` takes the support tables gets them built once, outside
the timing.

--form mono times the mono form's (K6's) headline call instead (the same
shape and inputs, T=22 fixed, B=2048, the noise as an input: the mono form
draws none), with the device ms of each launch kind (the names of either
design).

--form slab times the slab form's (K7's) headline call the same way
(T=22 fixed, B=2048, y given), with the device ms of each launch kind (C1,
R2C2, R3, or the earlier design's C1, R2, C2, R3; a name of either).

--k3 times K3 (`fwht_tile`, bf16, scale 1/sqrt(9216)) at (B, l, M) =
(512, 1024, 512), (1024, 512, 512), (1024, 256, 512) and (512, 2048, 512)
(median of 5 runs of 5 calls each), with a digest of each result, and the
section-sharded decode of phase 20 of chip_smoke.py at S = 2 (the headline
model, B=1024 draws from one generator, a virtual (1 x 2) mesh of the
card; median of 3 decodes).

--k5 times K5 (`fwht2`, float32) at (B, N) = (512, 2^19), (512, 2^17) and
(64, 2^20) (median of 5 runs of 5 calls each), with a digest of each
result and of the bf16-input result at (512, 2^19).

--k2 times K2 (`bp_decode_qc_kernel`, the layered QC-LDPC BP) at three
points, every tree on the same LLRs (the first run makes them, on the
card, and saves them for the others): (1) the concat block, the 12 288
codewords of chip_smoke.py phase 7 (PRESETS["concat"], 3.0 dB, B=2048,
the preset's BP settings); (2) K2_CODES (chip_smoke.py's BP_CODES), 4096
codewords each at its sigma, 32 iterations, min-sum and offset min-sum;
(3) the same codes at sigma K2_MAX_SIGMA, where all but a few codewords
fail their syndrome and run all 32 iterations (the per-iteration rate;
a few of qc_n648_r56's min-sum decodes converge to a codeword at any
sigma);
and, for the launch's tail, the concat code's straggler batch (K2_BATCH
noise-free codewords that stop after iteration 1, one of pure noise that
runs all 32) and that codeword alone.
Each point gives the call's ms (median of 5 runs of 5 calls, CUDA
events), the kernel's own device ms (one call, torch.profiler), the
mean iterations, the launches, and a
sha256 digest of the posterior, iteration counts and ok flags, which must
be the same in every tree (K2 is bitwise its plain version); the first
run also times the plain layered engine (median of 3 calls).  The report
adds each point's bound (BP_EDGE_OPS operations an edge and iteration as
run at 67 TFLOP/s against the LLR and result bytes at 3.35 TB/s) and the
design floor of `ops/bp_qc_kernel.py design_traffic` (device bytes at
3.35 TB/s plus on-chip bytes, shared memory and L1, at SMs x 128 B a
clock x `nvidia-smi`'s clocks.max.sm).  Only `bp_qc_layered` is built in
the trees after the first.

With --compare each run also decodes one headline block of the real
headline model (SparcModel.build of L=1024, M=512, R=1.0, iterative
power, 2.0 dB, B=2048, generator seed 0; on the split form with the noise
drawn in the kernel, with --form mono on amp_kernel="fused" and with
--form slab on amp_kernel="fused_slab", both with the noise from the
generator, and then that block's run_block timed, median of 3), and every
run is held to the first: the sections whose decision differs, those of
them decisive (both top-2 margins above 2 %, `decision_flips`' rule), the
iteration counts' and mean final tau2's differences, and whether beta,
the trace and the iteration counts are equal bit for bit.  With --form
slab --compare a witness follows: the block's first WITNESS_B codewords
decoded by the plain version (`amp_fused_reference`, this process's
tree, on the card) in float32 and in float64, and every pair of those and
of the trees' decodes held to each other the same way (how many
decisions summation order alone moves at this point).
Prints one JSON line per run, the card's `nvidia-smi` name and power
limit, and writes all of it to --out.

With --dense-strip no call is timed: each tree's split kernel decodes the
dense-strip mask (`dense_strip_mask`) at B = 3, T = 8 in float32 and in
bf16 (the inputs of the CUDA test of K1's hand-made masks), and the plain
version `amp_fused_reference` decodes the same inputs in float32 and in
float64; every pair of the four decodes is held to the other by
`decision_flips` (sections flipped, and decisively flipped: both top-2
margins above 2 %), with the flipped sections' margins, decisions and
true indices.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPS = 5
SHAPES = {"headline": dict(L=1024, M=512, T=22, B=2048, n=9216),
          "l4096": dict(L=4096, M=512, T=32, B=512, n=24576),
          "mono": dict(L=1024, M=512, T=22, B=2048, n=9216),
          "slab": dict(L=1024, M=512, T=22, B=2048, n=9216)}
# each stage's kernel names: the dense design's, then the support design's
STAGES = {"encode": ("amp_encode_kernel", "k1_encode_kernel"),
          "col": ("amp_col_kernel", "k1_col_kernel"),
          "row": ("amp_row_kernel", "k1_row_kernel")}
# K6's launches: the earlier design's C1, R2, C2, R3 and the new C1, R2C2
# (R3 keeps its kernel); a name is matched as a substring
MONO_STAGES = {"encode": ("amp_encode_kernel", "k1_encode_kernel"),
               "c1_dense": ("amp_col_kernel",), "r2": ("mono_hm_kernel",),
               "c2": ("fwht_cols_kernel",), "c1": ("mono_col_kernel",),
               "r2c2": ("mono_adj_kernel",), "r3": ("mono_row_kernel",)}
# K7's launches: the earlier design's C1 and C2 (one kernel, RESID true
# and false), R2, and the new C1, R2C2; R3 keeps its kernel
SLAB_STAGES = {"encode": ("amp_encode_kernel", "k1_encode_kernel"),
               "c1_dense": ("slab_col_kernel<128, 8, 1, true>",),
               "r2": ("slab_hm_kernel",),
               "c2": ("slab_col_kernel<128, 8, 1, false>",),
               "c1": ("slab_c1_kernel",), "r2c2": ("slab_adj_kernel",),
               "r3": ("slab_row_kernel",)}
K5_SHAPES = ((512, 1 << 19), (512, 1 << 17), (64, 1 << 20))
WITNESS_B = 512      # codewords of the slab block the plain witness decodes
K3_SHAPES = ((512, 1024, 512), (1024, 512, 512), (1024, 256, 512),
             (512, 2048, 512))
K3_N = 9216          # the headline n: K3's scale is 1/sqrt(n)
SHARD_BATCH = 1024   # chip_smoke.py phase 20's codewords
# --k2: chip_smoke.py's BP_CODES (code, noise sigma) and BP_BATCH, the
# sigma at which none of them decodes, the concat block's draw (phase 7)
K2_CODES = (("wifi_n648_r12", 0.75), ("qc_n648_r56", 0.5),
            ("wifi_n1944_r12", 0.75))
K2_BATCH = 4096
K2_MAX_SIGMA = 2.0
K2_CONCAT = dict(ebno_db=3.0, batch=2048, seed=0)
BP_EDGE_OPS = 8      # per edge and layered min-sum iteration (chip_smoke)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def dense_strip_mask(L: int = 1024, M: int = 64):
    """The dense-strip mask of the CUDA test of K1's hand-made masks, as its
    first version is recorded ("a strip filled densely"): the hand-made
    mask (sparse random rows at density 0.02, an empty column 5, column 9
    on rows 64-95 only, a full column 33) with the whole 32-column strip 1
    (columns 32-63) on the support.  That strip holds
    every one of its L * 32 positions, more entries than K1's column-stage
    block stages in shared memory (2048), so K1 reads them from device
    memory.  Returns an (L, M) float32 0/1 tensor."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    mask = rng.random((L, M)) < 0.02
    mask[:, 5] = False
    mask[:, 9] = False
    mask[64:96, 9] = True
    mask[:, 33] = True
    mask[:, 32:64] = True
    return torch.tensor(mask, dtype=torch.float32)


def dense_strip_inputs(B: int = 3, sigma: float = 0.1, seed: int = 0):
    """(y_n, mask, sq_npl, P, n) and the true indices for the dense-strip
    decode, on the CPU, made as the CUDA test makes them: noise sigma on
    the support, flat power sqrt(n / L), P = 1."""
    import numpy as np
    import torch

    mask = dense_strip_mask()
    L, M = mask.shape
    n = int(mask.sum())
    rng = np.random.default_rng(seed)
    y_n = torch.tensor(rng.standard_normal((B, L, M)) * sigma,
                       dtype=torch.float32) * mask
    idx = torch.tensor(rng.integers(0, M, (B, L)), dtype=torch.int32)
    sq = torch.full((L,), math.sqrt(n / L))
    return (y_n, mask, sq, 1.0, n), idx


DENSE_STRIP_T = 8
DENSE_STRIP_PRECISIONS = ("highest", "bf16")


def _dense_strip_worker(ak, dev, out_dir: str) -> dict:
    """Decode the dense-strip inputs with this tree's split kernel."""
    import numpy as np

    args, idx = dense_strip_inputs()
    args = tuple(a.to(dev) if hasattr(a, "to") else a for a in args)
    out = {}
    for prec in DENSE_STRIP_PRECISIONS:
        beta, trace, iters = ak.amp_fused(*args, DENSE_STRIP_T,
                                          encode_idx=idx.to(dev),
                                          precision=prec, split=True)
        path = os.path.join(out_dir, f"strip_{prec}_{os.getpid()}.npz")
        np.savez(path, beta=beta.cpu().numpy(), trace=trace.cpu().numpy(),
                 iters=iters.cpu().numpy())
        out[prec] = path
    return out


def dense_strip_report(decodes: dict, idx) -> dict:
    """Every pair of the decodes {name: {precision: (beta, trace)}} held to
    each other: sections flipped and decisively flipped, the trace's
    largest relative difference, and for each decisive flip of a pair its
    (codeword, row), both decisions, both margins and the true index."""
    import torch

    from sparc_ldpc_tpu_torch.models.amp import decision_flips

    def margin(x):
        top2 = x.topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]) / top2[..., 0].clamp(min=1e-30)

    names = list(decodes)
    rep = {}
    for prec in DENSE_STRIP_PRECISIONS:
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                (ba, ta), (bb, tb) = decodes[a][prec], decodes[b][prec]
                ba, bb = ba.double(), bb.double()
                flips, decisive = decision_flips(ba, bb)
                da, db = ba.argmax(-1), bb.argmax(-1)
                ma, mb = margin(ba), margin(bb)
                hard = (da != db) & (ma > 2e-2) & (mb > 2e-2)
                where = torch.nonzero(hard).tolist()[:8]
                rep[f"{prec}: {a} vs {b}"] = dict(
                    flips=flips, decisive=decisive,
                    trace_rel=float(((ta.double() - tb.double()).abs()
                                     / tb.double().abs()).max()),
                    decisive_sections=[dict(
                        codeword=c, row=r, dec=[int(da[c, r]), int(db[c, r])],
                        margin=[float(ma[c, r]), float(mb[c, r])],
                        true=int(idx[c, r])) for c, r in where])
    return rep


def _events_ms(fn) -> float:
    import torch

    fn()
    ms = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


def _stage_ms(fn, stages=STAGES) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    us = dict.fromkeys(stages, 0.0)
    for e in events:
        if e.get("cat") == "kernel":
            for k, names in stages.items():
                if any(nm in e.get("name", "") for nm in names):
                    us[k] += float(e.get("dur", 0.0))
    return {k: us[k] / 1e3 for k in stages}


# the amp_kernel choice of each form's headline model
FORM_KERNELS = {"split": "fused_split", "mono": "fused", "slab": "fused_slab"}


def _headline_model(dev, form: str = "split"):
    """The headline model (bench.py's configuration) on the split form with
    the noise drawn in the kernel, or on the mono form (amp_kernel="fused"
    at L = 1024) or the slab form (amp_kernel="fused_slab") with the noise
    drawn outside."""
    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel

    cfg = slt.SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel=FORM_KERNELS[form],
                          transform_precision="bf16", amp_iters=32,
                          amp_tol=0.0, amp_iters_auto=True,
                          amp_noise_in_kernel=form == "split")
    return SparcModel.build(cfg, 2.0, dev)


def _headline_block(torch, dev, out_dir: str, form: str = "split") -> dict:
    """Decode one headline block of the real model; save its decisions and
    each section's top-2 margin.  On the mono and slab forms also time its
    run_block (median of 3)."""
    import numpy as np

    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices

    mono = form != "split"
    model = _headline_model(dev, form)
    c = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    B = 2048
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    idx = bits_to_indices(bits, c.logM)
    block_ms = None
    if mono:
        noise = torch.randn((B, c.n), generator=gen, device=dev)
        res = model.decode(noise * math.sqrt(model.sigma2), encode_idx=idx)
        times = []
        for r in range(3):
            g = torch.Generator(device=dev).manual_seed(1 + r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _ = int(model.run_block(g, B)["bit_errors"])
            times.append(1e3 * (time.perf_counter() - t0))
        block_ms = statistics.median(times)
    else:
        seeds = model.draw_seeds(gen, B)
        res = model.decode(None, encode_idx=idx, noise_seed=seeds,
                           noise_sigma=math.sqrt(model.sigma2))
    dec = res.beta.argmax(-1).to(torch.int16).cpu().numpy()
    path = os.path.join(out_dir, f"dec_{os.getpid()}.npy")
    np.save(path, dec)
    np.save(path[:-4] + "_margin.npy", _margin(res.beta))
    digest = {k: hashlib.sha256(v.contiguous().cpu().numpy().tobytes())
              .hexdigest() for k, v in (("beta", res.beta),
                                        ("trace", res.tau2_trace),
                                        ("iters", res.iters))}
    return dict(T=c.amp_iters, decisions=path, digest=digest,
                section_errors=int((res.beta.argmax(-1) != idx).sum()),
                tau2_final=float(res.tau2_trace[-1].mean()),
                iters_mean=float(res.iters.float().mean()),
                block_ms=block_ms)


def _k3_worker(torch, ak, dev) -> dict:
    """K3's calls at K3_SHAPES and phase 20's S = 2 sharded decode."""
    import dataclasses

    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices

    gen = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(K3_N)
    out = {}
    for B, l, M in K3_SHAPES:
        x = torch.randn((B, l, M), generator=gen, device=dev)
        ms = _events_ms(lambda: [ak.fwht_tile(x, "bf16", scale)
                                 for _ in range(5)]) / 5
        y = ak.fwht_tile(x, "bf16", scale)
        out[f"{B}x{l}x{M}"] = dict(ms=ms, digest=hashlib.sha256(
            y.cpu().numpy().tobytes()).hexdigest())
        del x, y
        torch.cuda.empty_cache()
    model = _headline_model(dev)
    c = model.cfg
    B = SHARD_BATCH
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    noise = torch.randn((B, c.n), generator=gen, device=dev) * math.sqrt(
        model.sigma2)
    y = model.encode(bits) + noise
    sharded = dataclasses.replace(
        model, policy=ShardingPolicy(make_mesh(2, [dev] * 2)))
    got = sharded.decode(y)
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        sharded.decode(y)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    idx = bits_to_indices(bits, c.logM)
    out["sharded_s2"] = dict(
        ms=statistics.median(times),
        tau2_final=float(got.tau2_trace[-1].mean()),
        section_errors=int((got.beta.argmax(-1) != idx).sum()),
        fwht_tile_device_ms=_stage_ms(lambda: sharded.decode(y), {
            "k3": ("fwht_rows_kernel", "fwht_cols_kernel", "k3_row_kernel",
                   "k3_col_kernel", "k3_cluster_kernel")})["k3"])
    return out


def _k5_worker(torch, dev) -> dict:
    """K5's calls at K5_SHAPES, with result digests."""
    from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B, N in K5_SHAPES:
        x = torch.randn((B, N), generator=gen, device=dev)
        ms = _events_ms(lambda: [fwht2(x) for _ in range(5)]) / 5
        rec = dict(ms=ms, digest=hashlib.sha256(
            fwht2(x).cpu().numpy().tobytes()).hexdigest())
        if N == 1 << 19:
            rec["digest_bf16"] = hashlib.sha256(
                fwht2(x, True).cpu().numpy().tobytes()).hexdigest()
        out[f"{B}x2^{N.bit_length() - 1}"] = rec
        del x
        torch.cuda.empty_cache()
    return out


def _k2_make_points(torch, dev, path: str) -> None:
    """The LLRs of every --k2 point, saved to `path` (CPU tensors)."""
    import numpy as np

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.design.ldpc_codes import (build_code,
                                                        qc_structure)
    from sparc_ldpc_tpu_torch.models.concat import ConcatModel
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    def shifts_of(sh):
        return tuple(tuple(int(v) for v in row) for row in sh)

    cm = ConcatModel.build(slt.PRESETS["concat"], K2_CONCAT["ebno_db"], dev)
    sm, lm = cm.sparc, cm.ldpc
    B = K2_CONCAT["batch"]
    gen = block_generator(K2_CONCAT["seed"], 3, 1, dev)
    bits = torch.randint(0, 2, (B, cm.k_user), generator=gen,
                         dtype=torch.int32, device=dev)
    noise = torch.randn((B, sm.cfg.n), generator=gen, device=dev)
    beta = sm.decode(noise * math.sqrt(sm.sigma2),
                     encode_idx=cm._true_indices(bits)).beta
    llr = cm._protected_llrs_from_beta(beta).reshape(B * cm.num_cw, lm.n)
    c = lm.cfg
    kw = dict(iters=c.bp_iters, method=c.decoder, alpha=c.alpha,
              beta=c.beta, clip=c.llr_clip)
    sh = shifts_of(lm.qc_shifts)
    points = {"concat": dict(llr=llr.cpu(), shifts=sh, Z=lm.qc_tables.Z,
                             kw=kw)}
    # the launch's tail: K2_BATCH noise-free codewords of the concat code
    # (they stop after iteration 1) with one of pure noise (it runs every
    # iteration), and that codeword alone
    code_obj = build_code(c)
    rng = np.random.default_rng(2)
    cw = code_obj.encode(rng.integers(0, 2, (K2_BATCH, code_obj.k)))
    x = 8.0 * (1.0 - 2.0 * cw)
    x[K2_BATCH // 3] = (2.0 / K2_MAX_SIGMA ** 2) * (
        x[K2_BATCH // 3] / 8.0
        + K2_MAX_SIGMA * rng.standard_normal(code_obj.n))
    x = torch.tensor(x, dtype=torch.float32)
    points["concat straggler"] = dict(llr=x, shifts=sh, Z=lm.qc_tables.Z,
                                      kw=kw)
    points["concat lone"] = dict(llr=x[K2_BATCH // 3:K2_BATCH // 3 + 1],
                                 shifts=sh, Z=lm.qc_tables.Z, kw=kw)
    for code, sigma in K2_CODES:
        cfg = slt.LdpcConfig(kind="qc", path=code)
        code_obj = build_code(cfg)
        sh, Z = qc_structure(cfg)
        for label, sg, seed in (("sigma", sigma, 0),
                                ("max_iters", K2_MAX_SIGMA, 1)):
            rng = np.random.default_rng(seed)
            cw = code_obj.encode(rng.integers(0, 2, (K2_BATCH, code_obj.k)))
            y = (1.0 - 2.0 * cw) + sg * rng.standard_normal(cw.shape)
            llr = torch.tensor(2.0 * y / sg ** 2, dtype=torch.float32)
            for method in ("minsum", "oms"):
                points[f"{code} {label} {method}"] = dict(
                    llr=llr, shifts=shifts_of(sh), Z=Z,
                    kw=dict(iters=32, method=method))
    torch.save(points, path)


def _k2_worker(torch, dev, points: dict, made: bool) -> dict:
    """K2's calls at every --k2 point, with digests; the plain layered
    engine's ms too in the run that made the points."""
    import numpy as np

    from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel

    out = {}
    for name, pt in points.items():
        llr = pt["llr"].to(dev)
        sh, Z, kw = pt["shifts"], pt["Z"], pt["kw"]
        launches = bp_decode_qc_kernel.launches
        r = bp_decode_qc_kernel(llr, sh, Z, **kw)
        torch.cuda.synchronize()
        one = bp_decode_qc_kernel.launches - launches
        ms = _events_ms(lambda: [bp_decode_qc_kernel(llr, sh, Z, **kw)
                                 for _ in range(5)]) / 5
        # the kernel's own device time (profiler)
        kernel_ms = _stage_ms(lambda: bp_decode_qc_kernel(llr, sh, Z, **kw),
                              {"k2": ("bp_qc_layered_kernel",)})["k2"]
        h = hashlib.sha256()
        for t in (r.posterior, r.iters, r.ok):
            h.update(t.cpu().numpy().tobytes())
        rec = dict(ms=ms, kernel_ms=kernel_ms,
                   codewords=llr.shape[0], n=llr.shape[1],
                   launches_per_call=one,
                   iters_sum=int(r.iters.sum()),
                   iters_mean=float(r.iters.float().mean()),
                   ok=int(r.ok.sum()), digest=h.hexdigest())
        if made:
            tables = QcBpTables.build(np.asarray(sh), Z, device=dev)
            ms_p = []
            for _ in range(4):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                bp_decode_qc(llr, tables, schedule="layered", **kw)
                b.record()
                torch.cuda.synchronize()
                ms_p.append(a.elapsed_time(b))
            rec["plain_ms"] = statistics.median(ms_p[1:])
        out[name] = rec
        del llr, r
        torch.cuda.empty_cache()
    return out


def _k2_report(runs, sms: int, sm_mhz: float) -> dict:
    """Every --k2 point: the trees' ms in run order, whether their digests
    agree, and the bound and design floor on the first run's iterations."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import design_traffic

    smem_rate = sms * 128 * sm_mhz * 1e6
    first = runs[0]["k2"]
    rep = dict(smem_bytes_per_s=smem_rate, sms=sms, sm_mhz=sm_mhz)
    for name, pt in runs[0]["k2_points"].items():
        r0 = first[name]
        B, n = r0["codewords"], r0["n"]
        sh, Z = pt["shifts"], pt["Z"]
        edges = Z * sum(v >= 0 for row in sh for v in row)
        nbytes = B * (4 * n + n + 4 * n + 4 + 1)   # llr, hard, post, it, ok
        ops = BP_EDGE_OPS * edges * r0["iters_sum"]
        bound = {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
                 "operations": 1e3 * ops / FP32_OPS_PER_S}
        by = max(bound, key=bound.get)
        tr = design_traffic(sh, Z, B, r0["iters_sum"])
        floor = 1e3 * (tr["device_bytes"] / HBM_BYTES_PER_S
                       + tr["chip_bytes"] / smem_rate)
        rep[name] = dict(
            ms=[r["k2"][name]["ms"] for r in runs],
            kernel_ms=[r["k2"][name]["kernel_ms"] for r in runs],
            trees=[r["tree_arg"] for r in runs],
            digests_equal=len({r["k2"][name]["digest"] for r in runs}) == 1,
            iters_mean=r0["iters_mean"], ok=r0["ok"], codewords=B,
            launches_per_call=sorted({r["k2"][name]["launches_per_call"]
                                      for r in runs}),
            plain_ms=r0.get("plain_ms"), bound_ms=bound[by], bound_by=by,
            design_device_bytes=tr["device_bytes"],
            design_chip_bytes=tr["chip_bytes"], design_floor_ms=floor)
    return rep


def worker(tree: str, shape: str, compare_dir: str) -> dict:
    """Time one tree's calls of `shape` (a SHAPES key, "k3", "k5", "k2"
    or "dense_strip") in this process."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import inspect

    import torch

    from sparc_ldpc_tpu_torch.ops import _build
    from sparc_ldpc_tpu_torch.ops import amp_kernel as ak

    if not os.path.abspath(ak.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ak.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    if shape == "k2":
        # the first run builds every kernel and makes the points (the AMP
        # decode of the concat block); the others build K2 alone
        path = os.path.join(compare_dir, "k2_points.pt")
        made = not os.path.exists(path)
        if not made:
            _build.LIBRARIES = ("bp_qc_layered",)
        nvcc_s = _build.build()
        if made:
            _k2_make_points(torch, dev, path)
        points = torch.load(path)
        return dict(tree=root, nvcc_s=nvcc_s,
                    k2=_k2_worker(torch, dev, points, made),
                    k2_points={k: dict(shifts=p["shifts"], Z=p["Z"],
                                       kw=p["kw"])
                               for k, p in points.items()})
    nvcc_s = _build.build()
    if shape == "dense_strip":
        return dict(tree=root, nvcc_s=nvcc_s,
                    dense_strip=_dense_strip_worker(ak, dev, compare_dir))
    if shape == "k3":
        return dict(tree=root, nvcc_s=nvcc_s, k3=_k3_worker(torch, ak, dev))
    if shape == "k5":
        return dict(tree=root, nvcc_s=nvcc_s, k5=_k5_worker(torch, dev))
    form = shape if shape in ("mono", "slab") else "split"
    mono = form != "split"
    sh = SHAPES[shape]
    L, M, T, B, n = sh["L"], sh["M"], sh["T"], sh["B"], sh["n"]
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = torch.zeros(L * M, device=dev)
    mask[torch.randperm(L * M, generator=gen, device=dev)[:n]] = 1.0
    mask = mask.reshape(L, M)
    P = 1.0
    sigma = math.sqrt(P / (2.0 * 10 ** 0.2))
    sq = torch.full((L,), math.sqrt(n * P / L), device=dev)
    y_n = torch.randn((B, L, M), generator=gen, device=dev) * sigma * mask
    idx = torch.randint(0, M, (B, L), generator=gen, device=dev,
                        dtype=torch.int32)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), generator=gen,
                          device=dev, dtype=torch.int32)
    params = inspect.signature(ak.amp_fused).parameters
    # the split form at L = 1024: the default before the mono form existed
    kw = {"split": True} if "split" in params else {}
    if mono:
        kw = {"form": form}
    if "support" in params:
        from sparc_ldpc_tpu_torch.ops.split_support import (
            split_support_from_mask)
        kw["support"] = split_support_from_mask(mask)

    def call(noise: bool):
        if noise:
            return ak.amp_fused(None, mask, sq, P, n, T, encode_idx=idx,
                                noise_seed=seeds, noise_sigma=sigma, **kw)
        return ak.amp_fused(y_n, mask, sq, P, n, T, encode_idx=idx, **kw)

    out = dict(tree=root, shape=shape, nvcc_s=nvcc_s,
               ms=_events_ms(lambda: call(False)))
    if mono:
        st = _stage_ms(lambda: call(False),
                       SLAB_STAGES if form == "slab" else MONO_STAGES)
        out.update(encode_ms=st.pop("encode"),
                   ms_per_iter={k: v / T for k, v in st.items() if v > 0})
    else:
        out["noise_ms"] = _events_ms(lambda: call(True))
        st = _stage_ms(lambda: call(False))
        out.update(encode_ms=st["encode"], col_ms_per_iter=st["col"] / T,
                   row_ms_per_iter=st["row"] / T)
    if compare_dir:
        del y_n
        out["headline_block"] = _headline_block(torch, dev, compare_dir,
                                                form)
    return out


def _compare(runs) -> None:
    """Hold every run's headline block to the first run's."""
    import numpy as np

    first = runs[0]["headline_block"]
    d0 = np.load(first["decisions"])
    m0 = np.load(first["decisions"][:-4] + "_margin.npy")
    for r in runs:
        hb = r["headline_block"]
        d = np.load(hb["decisions"])
        m = np.load(hb["decisions"][:-4] + "_margin.npy")
        hb["decisions_differing"] = int((d != d0).sum())
        hb["decisive_differing"] = int(
            ((d != d0) & (m > 2e-2) & (m0 > 2e-2)).sum())
        hb["iters_mean_diff"] = hb["iters_mean"] - first["iters_mean"]
        hb["tau2_final_diff"] = hb["tau2_final"] - first["tau2_final"]
        hb["sections"] = int(d.size)
        hb["bitwise_equal_to_first"] = {
            k: hb["digest"][k] == first["digest"][k] for k in hb["digest"]}


def _margin(beta):
    """Each section's top-2 relative margin (decision_flips' rule)."""
    top2 = beta.topk(2, dim=-1).values.double()
    return ((top2[..., 0] - top2[..., 1])
            / top2[..., 0].clamp(min=1e-30)).float().cpu().numpy()


def _plain_witness(runs) -> dict:
    """The slab headline block's first WITNESS_B codewords (the draws of
    _headline_block) decoded by the plain version in float32 and float64,
    beside each run's decisions of them: for every pair, the sections
    whose decision differs and those of them decisive (both top-2 margins
    above 2 %), and each decode's section errors."""
    import itertools

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused_reference
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices

    dev = torch.device("cuda", 0)
    model = _headline_model(dev, "slab")
    c = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    bits = torch.randint(0, 2, (2048, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    idx = bits_to_indices(bits, c.logM)[:WITNESS_B].contiguous()
    noise = torch.randn((2048, c.n), generator=gen, device=dev)[:WITNESS_B]
    y_n = model.op.embed_y(noise * math.sqrt(model.sigma2)).reshape(
        WITNESS_B, c.L, c.M)
    args = (y_n, model.op.mask.reshape(c.L, c.M), model.sq_npl, c.P, c.n,
            c.amp_iters)
    truth = idx.cpu().numpy()
    dec = {}
    for dt in (torch.float32, torch.float64):
        a = tuple(t.to(dt) if torch.is_tensor(t) and t.is_floating_point()
                  else t for t in args)
        beta = amp_fused_reference(*a, encode_idx=idx, form="slab")[0]
        dec[f"plain {str(dt)[6:]}"] = (beta.argmax(-1).cpu().numpy(),
                                       _margin(beta))
        del beta
    for i, r in enumerate(runs):
        path = r["headline_block"]["decisions"]
        dec[f"kernel[{i}] {r['tree_arg']}"] = (
            np.load(path)[:WITNESS_B],
            np.load(path[:-4] + "_margin.npy")[:WITNESS_B])
    rep = {"section_errors": {k: int((d != truth).sum())
                              for k, (d, _) in dec.items()},
           "sections": int(truth.size)}
    for a, b in itertools.combinations(dec, 2):
        (da, ma), (db, mb) = dec[a], dec[b]
        diff = da != db
        rep[f"{a} vs {b}"] = dict(
            differ=int(diff.sum()),
            decisive=int((diff & (ma > 2e-2) & (mb > 2e-2)).sum()))
    return rep


def _dense_strip_all(runs) -> dict:
    """The trees' dense-strip decodes beside the plain version's in float32
    and float64 (on the CPU), every pair held to the other."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused_reference

    args, idx = dense_strip_inputs()
    decodes = {}
    for i, r in enumerate(runs):
        decodes[f"kernel[{i}] {r['tree_arg']}"] = {
            prec: tuple(torch.from_numpy(np.load(path)[k])
                        for k in ("beta", "trace"))
            for prec, path in r["dense_strip"].items()}
    for dt in (torch.float32, torch.float64):
        a = tuple(t.to(dt) if torch.is_tensor(t) and t.is_floating_point()
                  else t for t in args)
        decodes[f"plain {str(dt)[6:]}"] = {
            prec: amp_fused_reference(*a, DENSE_STRIP_T, encode_idx=idx,
                                      precision=prec, split=True)[:2]
            for prec in DENSE_STRIP_PRECISIONS}
    return dense_strip_report(decodes, idx)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--compare-dir", help=argparse.SUPPRESS)
    ap.add_argument("--l4096", action="store_true")
    ap.add_argument("--form", choices=("split", "mono", "slab"),
                    default="split")
    ap.add_argument("--k3", action="store_true")
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--dense-strip", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    modes = [m for m, on in (("l4096", a.l4096),
                             (a.form, a.form in ("mono", "slab")),
                             ("k3", a.k3), ("k5", a.k5), ("k2", a.k2),
                             ("dense_strip", a.dense_strip))
             if on]
    if len(modes) > 1:
        ap.error("--l4096, --form mono|slab, --k3, --k5, --k2 and "
                 "--dense-strip exclude each other")
    if a.compare and modes and modes[0] in ("k3", "k5", "k2",
                                            "dense_strip"):
        ap.error("--compare decodes a headline block: the split form's or, "
                 "with --form mono|slab, that form's")
    shape = modes[0] if modes else "headline"
    if a.worker:
        print(json.dumps(worker(a.worker, shape, a.compare_dir)),
              flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("amp_ab: no CUDA device is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for tree in a.trees:
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   tree, "--form", a.form]
            cmd += [f"--{m.replace('_', '-')}" for m in modes
                    if m not in ("mono", "slab")]
            if a.compare or a.dense_strip or a.k2:
                cmd += ["--compare-dir", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"amp_ab: {tree} failed:\n{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec["tree_arg"] = tree
            print(json.dumps(rec), flush=True)
            runs.append(rec)
        witness = None
        if a.compare:
            _compare(runs)
            for r in runs:
                print(json.dumps({"tree_arg": r["tree_arg"],
                                  **r["headline_block"]}), flush=True)
            if shape == "slab":
                witness = _plain_witness(runs)
                print(json.dumps({"plain_witness": witness}), flush=True)
        report = _dense_strip_all(runs) if a.dense_strip else None
    if a.k2:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[0])
        report = _k2_report(
            runs, torch.cuda.get_device_properties(0).multi_processor_count,
            mhz)
    if report is not None:
        print(json.dumps(report, indent=1), flush=True)
    print(card)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(card=card, mode=shape,
                           shape=SHAPES.get(shape), runs=runs,
                           dense_strip=report if a.dense_strip else None,
                           k2=report if a.k2 else None,
                           plain_witness=witness), f,
                      indent=1)


if __name__ == "__main__":
    main()
