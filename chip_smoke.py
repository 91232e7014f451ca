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
     wifi_n1944_r12, min-sum and offset min-sum, at their sigmas and at
     BP_MAX_SIGMA (the max-iteration point: at least 99.9 % of the
     codewords run all 32 iterations; at any sigma a few of qc_n648_r56's
     min-sum decodes still converge to a codeword), and on a straggler
     batch of the concat code (4095 noise-free codewords that stop after
     iteration 1, one of pure noise that runs all 32);
  8. concat main path: run_block at B=2048 through both kernels, noise in
     the kernel; FER within 0.03 of the float64 oracle's 0.909, bp_ok
     within 0.01 of 0.995, BER within 0.5x-2x of 1.62e-3
     (results/ber_parity_concat_full.jsonl), the early stop engaged, the
     same seed twice gives identical counters;
  9. timing: median ms per concat block over 3 blocks as user bits/s, the
     block's stages (main AMP, LLR fold, BP, feedback AMP) by CUDA events,
     and the BP kernel's and the plain engine's ms per call, the kernel's
     bound and its design floor (`ops/bp_qc_kernel.py design_traffic`:
     device bytes at 3.35 TB/s plus on-chip bytes, shared memory and L1,
     at SMs x 128 B a clock x nvidia-smi's clocks.max.sm);
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
     N=2^19) and (B=64, N=2^17) to 1e-5 of the output scale, its design
     (a row and a column launch, 16 bytes an element) and those bytes
     over 3.35 TB/s at the campaign's shape, and ms per
     call of both at B=64 and at the campaign's B=512, beside the library
     calls (`library_fwht2` with dense bf16 Hadamard factors: one
     torch.einsum, and two torch.matmul; each held to the plain version
     within LIBRARY_TOL of the output scale, the faster one's ms the
     record's library_ms);
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
     batch 2048, 4096 trials: phase 8's windows, and its bits_per_s (each
     block timed by its completion on the device clock) within 2 % of
     phase 9's;
 14. the monolithic AMP kernel (K6, csrc/amp_mono.cu) against its plain
     version at full width (B=32, L=1024, M=512): its adjoint launch from
     a compact z on the operator's support, to 1e-5 of the output scale
     (integer z bit for bit); the decode at fixed
     T, and at T=32 with
     tol 1e-4, with tol and 40 % of the rows pinned, and with an SE
     schedule: tau2 to rtol 2e-2, at most 1 % flipped decisions, mean
     iteration counts within 2, pinned rows exactly sq * one_hot, the
     trace equal to the schedule;
 15. the mono main path: run_block on the headline configuration with
     amp_kernel="fused" (mono at L <= 1024; the noise from torch.randn, as
     the reference's gate has it), B=2048: K6 launched and K1 not, mean
     final tau2 within 3 % of SE, identical counters per seed; ms per
     block and bits/s beside phase 5's, and K6's and the plain version's
     ms per decode call, whose results are held to phase 14's rules; each
     launch's device ms (the encode, C1, R2C2 and R3 of every iteration)
     beside the bytes K6's design moves in it (`mono_design_bytes`: 24 N +
     20 ns a codeword and iteration), and the call's over 3.35 TB/s;
 16. K1 at L=4096 (PRESETS["fast_l4096"] at 6.5 dB, a cluster of four
     column-stage blocks per strip) against its plain version: B=4, T=8,
     fixed T and tol 1e-4, in float32 and bf16 with phase 3's and phase
     6's tolerances; the transform alone to 1e-5; the noise uniforms
     bit-equal and normals within 1e-5 at L=4096; K1's and the plain
     version's ms per decode call at the campaign's B=512, whose results
     are held to phase 6's bf16 rules;
 17. the CLI in process: `campaign --preset fast_l4096` as shipped at
     6.5 dB, batch 512, 2048 trials: K1 with its noise launched, K6 not;
     FER within [0.47, 0.64] and BER within 0.7x-1.4x of the float64
     oracle's 1.102e-4 (results/ber_parity_fast_l4096.jsonl, kind
     oracle, 300 trials: FER 0.553 +- 2.5 joint standard errors);
 18. K3 (`fwht_tile`, the local transform of section-sharded AMP, with
     its 1/sqrt(n) scale) against its plain version at (B, l, M) = (64,
     512, 512), (64, 2048, 512) and the main paths' shapes (1024, 512,
     512), (1024, 256, 512) (phase 20) and (512, 1024, 512) (phase 21):
     float32 to 1e-5 of the output scale; bf16 on integer inputs bit for
     bit (every sum exact) and on normals to 1e-4 (where the two sum in
     other orders a bf16 rounding of the intermediate may fall the other
     way); ms per call of both at (512, 1024, 512) and (512, 2048, 512)
     with their bounds, the timed calls' results held to the bf16 limit,
     each launch's device ms beside its design bytes (K3_DESIGN_BYTES), and
     the library calls at (512, 1024, 512) (`library_tile`, einsum and
     matmul, held and reported as phase 11's);
 19. data parallel on a virtual (4 x 1) mesh of the card: phase 4's block
     (the headline configuration as shipped, B=2048, the same generator)
     with each quarter on K1: counters and tau2_final bit for bit, K1
     launched 4 times with its noise; ms per block beside phase 5's;
 20. section-sharded AMP on virtual (1 x 2) and (1 x 4) meshes: the
     headline model at B=1024, draws from one generator (bits, torch.randn
     noise) through the single-device K1 decode (noise outside) and
     through the sharded loop (K3, hypercube, K4): at most 1 % flipped
     decisions, mean final tau2 within 2e-2 of each other and both within
     3 % of SE, K3 launched 2 T S times a decode; ms per decode of each;
 21. campaigns under a policy, in process: `fast_l4096` at 6.5 dB, B=512,
     2048 trials on a virtual (1 x 4) mesh (l = 1024 a shard): FER and BER
     inside phase 17's windows, bits/s; `concat` as phase 13b runs it on a
     virtual (2 x 1) mesh: counters equal to phase 13b's record;
 22. `--distributed`: `python -m torch.distributed.run --nproc_per_node 2
     -m sparc_ldpc_tpu_torch.cli campaign --distributed --preset concat`
     as phase 13b, two processes on the card, each a (1 x 1) mesh, gloo
     for the counters: one record, written by rank 0 alone, with phase
     13b's counters;
 23. only where two cards or more are visible: phase 4's block on a real
     (n x 1) mesh of all n cards, equal to one card's, and the phase-20
     decode on real (n/2 x 2) and (1 x n) meshes, bit for bit the same
     meshes made virtual on cuda:0; host ms of each.  There the CLI
     phases run on the mesh of every card that the CLI builds;
 24. the slab AMP kernel (K7, csrc/amp_slab.cu) against its plain version.
     It computes in bf16 only (its 128-wide Hadamard factors run on the
     bf16 tensor cores, and the reference's slab kernel has no float32
     mode either), so every comparison takes the bf16 rules: tau2 to rtol
     2e-2, at most 1 % flipped decisions, mean iteration counts within 2.
     At the headline shape (B=8, T=22, fixed T); on the concat
     configuration at B=32, T=32: tol 1e-4, tol with 40 % of the rows
     pinned (pinned rows exactly sq * one_hot), an SE schedule designed at
     1.1 sigma2 (the trace equal to it); at the fast_l4096 shape (B=4,
     T=8, a cluster of four column blocks), fixed T and tol; at L = M = 64
     (f_a = m_a = 1).  Its transform alone: integer inputs bit-equal to
     the plain version (every sum exact, so within 1e-5 of the output
     scale in float32), normals within one bf16 ulp of the largest H_M
     value (the two sum in other orders); its adjoint launch alone (R2C2,
     from a compact z on the headline support): integers bit-equal,
     normals within 1e-5 of the output scale;
 25. the slab main path: run_block on the headline configuration with
     amp_kernel="fused_slab" (torch.randn noise, encode in the kernel),
     B=2048: K7 launched, K1 and K6 not, mean final tau2 within 3 % of
     SE, identical counters per seed; ms per block and bits/s beside
     phases 5 and 15; K7's and the plain version's ms per decode call,
     each launch's device ms (encode, then C1, R2C2, R3 of every
     iteration) beside the bytes K7's design moves in it
     (`slab_design_bytes`: 20 N + 16 ns a codeword and iteration) and the
     call's design bytes over 3.35 TB/s,
     the timed results held to phase 24's rules, and the same draws
     through K1: at most 1 % flipped decisions, mean final tau2 within
     2e-2;
 26. a slab concat block: PRESETS["concat"] with sparc.amp_kernel=
     "fused_slab", 3.0 dB, B=2048: K7 launched twice (main and pinned
     feedback pass) and K2 once, phase 8's windows; ms per block and user
     bits/s beside phase 9's;
 27. the split kernel's stage ablation (S2, csrc/amp_exp.cu on K1's own
     kernels, csrc/amp_k1.cuh, the tool
     `python -m sparc_ldpc_tpu_torch.tools.kernel_ablation`) on the
     headline model's code (L=1024, M=512, 2.0 dB; T=32 fixed, the
     scripts'): each variant against its plain version at B=8 (full in
     bf16 over T=32: at most 1 % flipped sections, tau2 to rtol 2e-2; in
     float32 no decisive flip, tau2 to rtol 1e-4; the ablated variants,
     garbage decodes, over T=2 in float32 within 1e-2 of the output scale
     with NaN where the plain version has NaN, and in bf16 against the
     plain version in K1's form and rounding); then the tool's blocks at
     B=512 (the main path: every variant launched), each variant's decode
     call by CUDA events with its bound and its device ms by launch
     (encode, column, row), K1's own fixed-T call (amp_fused, split, y
     given) beside full's: the same beta and tau2 trace bit for bit and
     the call within 2 %; full's mean final tau2 within 3 % of SE, and
     the stage split full - each ablated variant;
 28. the H_L factorings (S3, `tools.lstage_exp`: K1's encode and row
     stage, a column stage of their own on K1's walker with H_{f_b} on the
     tensor cores): each variant against its plain version at B=8 in bf16
     (phase 27's decode rules), then the tool's blocks and each decode
     call at B=512, T=32 with its column stage's ms a launch beside K1's
     (phase 27's K1 call), the section errors within 1 % of the sections
     of full's;
 29. two codewords per row-stage block (S1, `tools.pair_kernel_exp`: K1's
     encode and column stage, K1's row stage at its paired variant):
     against its plain version (K1's form of full) at B=8 in bf16 and
     float32, then the tool's blocks and the decode call at B=512, T=32
     beside K1's own fixed-T call on the same draws: beta and the trace of
     the first codeword of each pair bit for bit, each one's row stage ms
     a launch, section errors within 1 % of full's;
 30. the slab kernel's stage ablation (S4, csrc/amp_slab_exp.cu: K7's own
     kernels, csrc/amp_k7.cuh, at compile-time variants; the tool `python
     -m sparc_ldpc_tpu_torch.tools.slab_ablation`): make_kernel's variants
     and the factorings fXmY on the headline model's code, each against
     its kernels' plain version (K7's form, order="kernel") at B=8 on
     encoded draws (decoding variants over T=32: at most 1 % flipped
     sections, tau2 to rtol 2e-2; ablated ones over T=2: beta within 1e-2
     of the output scale, no NaN; no_consume, NaN throughout from beta' = 0
     as the script's, also from the state one plain full iteration leaves);
     then the tool's blocks at the script's B=1024, T=32 on its pure-noise
     draws (the main path: every variant launched); each variant's decode
     call at B=1024 by CUDA events with its bound, held to the plain
     version of the same call in the same way; K7's own fixed-T call (amp_fused, slab form, y given) beside
     full's: the same beta and trace bit for bit, the call within 2 %;
     device ms by launch (encode, C1, R2C2, R3) of every variant and of
     K7's call; full's mean final tau2 within 3 % of SE; the split full -
     each variant in ms and % of full's call, and by launch;
 31. S4's compact layouts (compact, compact32) and the pair, in the same
     way, by launch beside full; the pair's kept state and trace bit for
     bit full's;
 32. K1 by launch: the headline call of the main path (B=2048, T=22, the
     noise drawn in the kernel, the operator's support tables) and
     fast_l4096's (B=512, T cap 32, tol 1e-4), each launch's device ms
     (torch.profiler: the encode, then the column and the row stage of
     every iteration) beside the bytes K1's design moves in it
     (`k1_design_bytes`: 16 N + 12 ns a codeword and iteration) and that
     over the time; the call's design bytes over 3.35 TB/s (a model of
     K1's design on this run's iteration counts, printed on this phase's
     line only).  The amp_split and amp_split_l4096 records carry its
     measured `stages_ms`;
 33. the BER/FER leg tool (`tools/ber_legs.py`, `run_legs`) in process:
     a `torch` leg of plain_small at 2.0 dB and of concat_small at 3.0 dB,
     and a `torch_mono` (K6) and a `torch_slab` (K7) leg of plain_small at
     2.0 dB, each paired with K1 on the same frames, 1024 trials each,
     into a temporary directory: each record well formed (the tool's
     fields, integer counters, TF32 off, the card's line) and its BER
     within the joint 95 % bound of the float64 oracle leg on disk
     (results/ber_parity_<preset>.jsonl), floored at REL_FLOOR (default
     1 %) of the larger BER; K1 launched, K2 for concat_small, K6 and K7
     for their legs; the paired legs' mean per-frame difference of bit
     errors not wholly beyond +- 2 % of K1's bit errors a frame
     (`ber_legs.paired_compare`);
 34. the column-signed Hadamard operator (PRESETS["pa_l1024"] with
     col_signs=True, and the same with --pallas: K5) and the DCT operator
     at fast_l4096's geometry (L=4096, M=512, R=1.5, ML=2^21, cuFFT):
     Ax and Ay of 4 seeded inputs on the card against the same operator
     on the CPU within 1e-4 of the output scale, the card's adjointness
     normalized by |Ax| |z| within 1e-6; a block of 64 at 6.0 dB
     (col_signs, both routes on the same draws) and 7.0 dB (dct) decoded
     on the card (`decode`, and `run_block_from` for the counters), and
     its first 16 rows once on the CPU from the same draws (codewords
     decode alone, so those rows stand for the block; the CPU decode of
     all 64 took 178 s while the card idled): on those rows no decisive
     flip, mean final tau2 within 1e-3 of the CPU's, section errors apart
     by at most the flips; the card's block counters agree with its
     decode; the --pallas block launches K5 and K4 and not K1;
 35. the section axis across processes: `python -m torch.distributed.run
     --nproc_per_node 2 -m sparc_ldpc_tpu_torch.cli campaign --distributed
     --section-shards 2 --preset fast_l4096` at 6.5 dB (L=4096, M=512,
     one slab of l=2048 sections a process), three blocks.  On one card
     both processes share it; NCCL refuses two ranks of one GPU, so the
     slabs cross through host memory over gloo (`--dist-backend gloo`):
     2 exchanges an iteration of B x 4 MiB each way, so B=32 (2 GiB a
     stage at the campaign's B=512 would take minutes over loopback).
     With two cards or more, one process a card (cuda:0, cuda:1), NCCL
     at B=512.  The record, written by rank 0 alone, equals counter for
     counter the same campaign in this process on a virtual (1 x 2) mesh
     (phase 21's route); each rank launches K3 and K4 half as often as
     that campaign (one slab each) and prints its exchange's calls,
     bytes and host seconds.  The record's steady bits_per_s (the last two
     blocks, timed from the first block's completion to the last's) as ms
     a block, within 10 % of the point's wall over its blocks; the kernels
     line carries each rank's K3 and K4 launches, the ms a block and the
     exchange's share of the campaign's wall.

Counts of kernel launches are set to 0 before each path (phases 4, 8,
13a, 13b, 15, 17, 19, 20, 21, 25, 26, the tools' blocks of 27-31, each
leg of 33, the --pallas block of 34 and the reference campaign of 35;
the two processes of 35 count their own from 0) and read after it.  Then a JSON line with the kernels'
records (each with its bound: the larger of the bytes its function must
move, inputs read once and outputs written once, over 3.35 TB/s and its
operations over the H100's peak for their type, 67 TFLOP/s float32 and
989 TFLOP/s bf16; K1, K3, K6 and K7 with their launches' measured ms,
K5 with its design's name), the card's `nvidia-smi` line, and last
`{"ok": true, "device": {...}}`.  Any failure raises (exit code 1);
without a GPU it exits with code 1 before printing any result.  The port
imports no JAX and nothing of the reference package, nor does this
script.
"""

from __future__ import annotations

import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

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
BP_MAX_SIGMA = 2.0    # phase 7's max-iteration sigma
# K2's design (csrc/bp_qc_layered.cu)
K2_DESIGN = ("check state (min1, min2, sign and min1 bits), a codeword a "
             "warp group with its own barrier and exit, a work queue, a "
             "layer's edges in registers (two lanes a check above 12 "
             "edges), the reduced zero-block pass")
SMEM_BYTES_PER_CLOCK = 128   # an SM's shared memory and L1, bytes a clock
OPTION_BATCH = 32     # codewords in phase 6
SCHED_MARGIN = 1.1    # phase 6's SE schedule is designed at 1.1 sigma2
KERNEL_BATCH = 64     # rows of phases 10 (a), 11 and 12
CLI_BATCH = 512       # the --pallas campaign's batch
OPTION_T = 32         # phase 14's cap for the early stop, pins, schedule
FAST_EBNO_DB = 6.5
FAST_BATCH = 512      # fast_l4096's campaign batch: about 14 GiB of state
FAST_TRIALS = 2048
L4096_BATCH, L4096_T = 4, 8                # phase 16's comparison
# the float64 oracle at fast_l4096, 6.5 dB, 300 trials: BER 1.102e-4, FER
# 0.553 (results/ber_parity_fast_l4096.jsonl, kind "oracle"); the FER
# window is +-2.5 joint standard errors around it
FAST_ORACLE_BER, FAST_FER_WINDOW = 1.102e-4, (0.47, 0.64)
SHARD_BATCH = 1024    # phase 20's codewords
K1_STAGES = ("k1_encode_kernel", "k1_col_kernel", "k1_row_kernel")
# K6's launches (encode, C1, R2C2, R3) and K3's (rows, columns)
MONO_STAGES = ("k1_encode_kernel", "mono_col_kernel", "mono_adj_kernel",
               "mono_row_kernel")
# K5's design (ops/fwht_kernel.py) and the device-memory bytes an element
# it moves
K5_DESIGN = "row launch into the output, column launch in place"
K5_DESIGN_BYTES = 16
# K7's launches (encode, C1, R2C2, R3)
SLAB_STAGES_K7 = ("k1_encode_kernel", "slab_c1_kernel", "slab_adj_kernel",
                  "slab_row_kernel")
K3_STAGES = ("k3_cluster_kernel", "k3_row_kernel", "k3_col_kernel")
# the device-memory bytes an element each of K3's launches moves: the
# cluster kernel reads x and writes out (8); the row launch reads x and
# writes the bf16 intermediate (6), the column launch reads it and writes
# out (6)
K3_DESIGN_BYTES = dict(zip(K3_STAGES, (8, 6, 6)))
SHARD_STAGES = ("k3_cluster_kernel", "k3_row_kernel", "k3_col_kernel",
                "denoise_kernel",
                "elementwise_kernel", "reduce_kernel", "CatArrayBatchedCopy")
DIST_TIMEOUT_S = 300  # phase 22's two processes
# the H100 SXM's published peak rates, for bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12}
AMP_ELEM_OPS = 12     # per element and AMP iteration besides the
                      # transforms: residual, |z|^2, softmax, |beta'|^2
BP_EDGE_OPS = 8       # per edge and layered min-sum iteration


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_max_mhz() -> float:
    """The card's highest SM clock, MHz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


class Clock:
    """Seconds since the previous lap."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


def call_ms(fn, reps: int, inner: int = 1, warm: bool = True) -> float:
    """Median device ms of fn() by CUDA events (one warm-up call unless
    warm is false; each of the reps times `inner` calls back to back)."""
    import torch

    if warm:
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


def timed_result(fn, reps: int, inner: int = 1, warm: bool = True):
    """call_ms(fn, reps, inner, warm) and fn's last result; each call drops
    the one before it first, so at most one is held."""
    box = []

    def run():
        box.clear()
        box.append(fn())

    return call_ms(run, reps, inner, warm), box[0]


def reset_counts() -> None:
    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused, fwht_tile
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
    from sparc_ldpc_tpu_torch.ops.denoiser import denoise_kernel
    from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2

    for fn in (amp_fused, bp_decode_qc_kernel, denoise_kernel, fwht2,
               fwht_tile):
        fn.launches = 0
    amp_fused.noise_launches = 0
    amp_fused.mono_launches = 0
    amp_fused.slab_launches = 0


def read_counts() -> dict:
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused, fwht_tile
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import bp_decode_qc_kernel
    from sparc_ldpc_tpu_torch.ops.denoiser import denoise_kernel
    from sparc_ldpc_tpu_torch.ops.fwht_kernel import fwht2

    torch.cuda.synchronize()
    return dict(amp_split=amp_fused.launches,
                amp_split_noise=amp_fused.noise_launches,
                amp_mono=amp_fused.mono_launches,
                amp_slab=amp_fused.slab_launches,
                bp_qc_layered=bp_decode_qc_kernel.launches,
                fwht2=fwht2.launches, denoise=denoise_kernel.launches,
                fwht_tile=fwht_tile.launches)


# the headline model's SE trajectory (host, about half a minute), by model
_SE_TRACES = {}


def se_final(model, T: int) -> float:
    """SE's tau2 after T iterations at the model's point: one
    se_trajectory a model, run to max(T, EXP_T) iterations (its first
    entries are a shorter run's: the same draws, the same early stop)."""
    from sparc_ldpc_tpu_torch.design.se import se_trajectory

    key = id(model)
    if key not in _SE_TRACES or len(_SE_TRACES[key]) <= min(T, EXP_T):
        c = model.cfg
        _SE_TRACES[key] = se_trajectory(model.p_alloc, c.n, c.M,
                                        model.sigma2, T=max(T, EXP_T))
    tr = _SE_TRACES[key]
    return float(tr[min(T, len(tr) - 1)])


def bound(nbytes: float, ops: dict) -> dict:
    """The least time the card could take: the larger of nbytes over the
    memory rate and, per type, its operations over that type's peak (the
    types may overlap, so the largest of them)."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S}
    times["operations"] = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    by = max(times, key=times.get)
    return {"bound_ms": 1e3 * times[by], "bound_by": by}


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def amp_bound(B: int, L: int, M: int, T: int, iters,
              noise_drawn: bool = False) -> dict:
    """Bound of one whole-trial AMP call on B codewords, iters (B,) the
    iterations each ran, on either form.  Bytes: y_n unless the noise is
    drawn, the mask, sq, the encode indices, and beta, the trace and the
    counts, once each.  Operations: the transforms (two per iteration but
    the first, which has none forward) at log2(L) + log2(M) float32 adds
    per element each, plus AMP_ELEM_OPS per element and iteration, and the
    encode's H_L.  The mono form's dense bf16 H_M is the same function up
    to summation order (products with +-1 are exact, the sums float32), so
    it is held to the butterflies' count too.  The Philox integer work is
    left out."""
    el = L * M
    nbytes = 4 * (B * el * (1 if noise_drawn else 2) + el + L + B * L
                  + T * B + B)
    its = float(iters.sum())
    transforms = (2 * its - B) * el
    return bound(nbytes, {"fp32": transforms * math.log2(L * M)
                          + its * el * AMP_ELEM_OPS
                          + B * el * math.log2(L)})


def library_tile(x, scale: float = 1.0, form: str = "einsum"):
    """PyTorch's own computation of K3's function on x (B, l, M) float32,
    the yardstick of phase 18 (the port never calls it): x in bf16 with
    dense bf16 Hadamard factors, H_l x H_M, times scale.  form "einsum" is
    one torch.einsum of the three (in the order einsum picks, with the
    copies it makes); "matmul" is two batched products, H_l (x H_M), each
    on the tensor cores with no copy.  Their rounding differs from K3's:
    all round x to bf16 and sum in float32, but these round their
    intermediate after the first factor applied, and their result, to
    bf16."""
    import torch

    from sparc_ldpc_tpu_torch.ops.fwht import hadamard_factor

    _, L, M = x.shape
    hl = hadamard_factor(L, x.device, torch.bfloat16)
    hm = hadamard_factor(M, x.device, torch.bfloat16)
    return _library_pair(hl, x.to(torch.bfloat16), hm, form).float() * scale


def library_fwht2(x, f1: int, f2: int, form: str = "einsum"):
    """PyTorch's own computation of K5's function on x (B, f1 f2) float32,
    the yardstick of phase 11: each row viewed as an (f1, f2) tile X,
    H_f1 X H_f2 with dense bf16 factors, in library_tile's two forms.  K5
    in float32 rounds nothing; these round x, their intermediate and
    their result to bf16."""
    import torch

    from sparc_ldpc_tpu_torch.ops.fwht import hadamard_factor

    B = x.shape[0]
    h1 = hadamard_factor(f1, x.device, torch.bfloat16)
    h2 = hadamard_factor(f2, x.device, torch.bfloat16)
    return _library_pair(h1, x.to(torch.bfloat16).reshape(B, f1, f2), h2,
                         form).float().reshape(B, f1 * f2)


def _library_pair(h1, x, h2, form: str):
    """h1 x h2 for each (f1, f2) tile of x (B, f1, f2), one library form."""
    import torch

    if form == "einsum":
        return torch.einsum("ij,bjk,kl->bil", h1, x, h2)
    if form == "matmul":
        return torch.matmul(h1, torch.matmul(x, h2))
    raise ValueError(f"unknown library form {form!r}")


LIBRARY_FORMS = ("einsum", "matmul")


def library_times(fn, ref, reps: int, inner: int):
    """Each library form of fn(form) timed (ms per call) and held to ref:
    ({form: ms}, {form: max err / max |ref|}).  The faster form's time is
    the kernel record's library_ms."""
    ms, err = {}, {}
    top = float(ref.abs().max())
    for form in LIBRARY_FORMS:
        ms[form], out = timed_result(lambda: fn(form), reps, inner=inner)
        err[form] = float((out - ref).abs().max()) / top
        del out
    return ms, err


# the library calls round their results to bf16 (2^-9 of each value) and
# their intermediates at other places than the plain versions: they are
# held to them within this share of the output's largest magnitude
LIBRARY_TOL = 1e-2


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
    res = option_runs((y_n, mask2d, model.sq_npl, c.P, n, T),
                      {p: dict(precision=p, split=True)
                       for p in ("highest", "bf16")}, idx, T)
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
    check_options(res, CHECK_BATCH * L, f32_keys=("highest",))
    require(fw["highest"] <= 1e-5, f"f32 transform err {fw['highest']}")
    max_abs_err = res["highest"]["beta_abs_err"]
    del y_n, x

    # 4. main path, noise drawn in the kernel
    se_fp = se_final(model, T)
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
    # K1's support tables, built once as the main path builds them
    sup = model.op.split_support(L, M, dev)
    kernel_ms = call_ms(lambda: amp_fused(*args, encode_idx=idx,
                                          split=True, support=sup), REPS)
    noise_ms = call_ms(lambda: amp_fused(
        None, *args[1:], encode_idx=idx, noise_seed=seeds,
        noise_sigma=sigma, split=True, support=sup), REPS)
    plain_ms = call_ms(lambda: amp_fused_reference(
        *args, encode_idx=idx, split=True), REPS)
    iters = amp_fused(*args, encode_idx=idx, split=True, support=sup)[2]
    amp_b = amp_bound(BATCH, L, M, T, iters)
    print(f"[5 timing] {METRIC} = {bits_per_s:.1f} bits/s "
          f"({1e3 * dt:.2f} ms per block of {BATCH}, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) on {card}; decode "
          f"call at B={BATCH}: kernel {kernel_ms:.2f} ms with the noise as "
          f"input, {noise_ms:.2f} ms drawing it; plain {plain_ms:.2f} ms; "
          f"bound {amp_b} ({clock.lap():.1f} s)", flush=True)
    return dict(model=model, launches=launches, cnt=cnt, tau_gap=tau_gap,
                se_fp=se_fp, max_abs_err=max_abs_err, kernel_ms=kernel_ms,
                plain_ms=plain_ms, noise_ms=noise_ms, bound=amp_b,
                bits_per_s=bits_per_s, block_ms=1e3 * dt)


def concat_path(dev, card: str, clock: Clock) -> dict:
    """Phases 6-9: the concatenated SPARC + LDPC path, as shipped."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.design.ldpc_codes import build_code, qc_structure
    from sparc_ldpc_tpu_torch.design.se import se_trajectory
    from sparc_ldpc_tpu_torch.models.concat import ConcatModel
    from sparc_ldpc_tpu_torch.ops.bp_qc import QcBpTables, bp_decode_qc
    from sparc_ldpc_tpu_torch.ops.bp_qc_kernel import (bp_decode_qc_kernel,
                                                      design_traffic)
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
    opts = {f"{label} {prec}": dict(precision=prec, split=True, **opt)
            for label, opt in (("tol", dict(tol=1e-4)),
                               ("tol+pin", dict(tol=1e-4, pin_idx=pin)),
                               ("schedule", dict(tau2_schedule=sched)))
            for prec in ("highest", "bf16")}
    res6 = option_runs(args, opts, idx, T)
    print(f"[6 amp options vs plain] B={B6} L={L} M={M} T={T}: {res6} "
          f"({clock.lap():.1f} s)", flush=True)
    f32_keys = tuple(k for k in res6 if k.endswith("highest"))
    check_options(res6, B6 * L, f32_keys)
    for key, r in res6.items():
        if key.startswith("tol"):
            require(r["iters_min"] < T, f"{key}: no early stop")
    errs = [res6[k]["beta_abs_err"] for k in f32_keys]
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
    # the LLRs read and the results written once; BP_EDGE_OPS per edge and
    # iteration each codeword ran
    edges = lm.qc_tables.Z * sum(s >= 0 for row in lm.qc_shifts for s in row)
    bp_b = bound(tensor_bytes(llr, *rk),
                 {"fp32": BP_EDGE_OPS * edges * float(rk.iters.sum())})
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
        # the max-iteration point: (nearly) no codeword passes its syndrome
        rng = np.random.default_rng(SEED + 1)
        yb = (1.0 - 2.0 * cw) + BP_MAX_SIGMA * rng.standard_normal(cw.shape)
        llr_c = torch.tensor(2.0 * yb / BP_MAX_SIGMA ** 2,
                             dtype=torch.float32, device=dev)
        for method in ("minsum", "oms"):
            a = bp_decode_qc_kernel(llr_c, sh, Z, iters=32, method=method)
            b = bp_decode_qc(llr_c, tables, iters=32, method=method,
                             schedule="layered")
            res7[f"{code} max_iters {method}"] = dict(
                Z=Z, bitwise=bitwise(a, b), ok=int(a.ok.sum()),
                iters_mean=float(a.iters.float().mean()))
            require(int((a.iters == 32).sum()) >= 0.999 * BP_BATCH,
                    f"{code} at sigma {BP_MAX_SIGMA}: {int(a.ok.sum())} "
                    f"codewords passed")
    # a straggler among codewords that stop after one iteration
    code_obj = build_code(lm.cfg)
    rng = np.random.default_rng(SEED)
    cw = code_obj.encode(rng.integers(0, 2, (BP_BATCH, code_obj.k)))
    xb = 8.0 * (1.0 - 2.0 * cw)
    xb[BP_BATCH // 3] = (2.0 / BP_MAX_SIGMA ** 2) * (
        xb[BP_BATCH // 3] / 8.0
        + BP_MAX_SIGMA * rng.standard_normal(code_obj.n))
    llr_s = torch.tensor(xb, dtype=torch.float32, device=dev)
    for method in ("minsum", "oms"):
        a = bp_decode_qc_kernel(llr_s, lm.qc_shifts, lm.qc_tables.Z,
                                iters=32, method=method)
        b = bp_decode_qc(llr_s, lm.qc_tables, iters=32, method=method,
                         schedule="layered")
        res7[f"straggler {method}"] = dict(
            bitwise=bitwise(a, b), ok=int(a.ok.sum()),
            iters_max=int(a.iters.max()),
            stopped_at_1=int((a.iters == 1).sum()))
        require(int(a.iters[BP_BATCH // 3]) == 32
                and int((a.iters == 1).sum()) == BP_BATCH - 1,
                f"straggler batch {method}: {res7[f'straggler {method}']}")
    print(f"[7 bp kernel vs plain] {res7} ({clock.lap():.1f} s)", flush=True)
    for k, r in res7.items():
        require(r["bitwise"], f"{k}: kernel and plain engine differ")
    k2_traffic = design_traffic(lm.qc_shifts, lm.qc_tables.Z, llr.shape[0],
                                int(rk.iters.sum()))

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
    # K2's design floor: its device bytes at the memory rate plus its
    # on-chip bytes at every SM's shared-memory rate
    smem_rate = (torch.cuda.get_device_properties(dev).multi_processor_count
                 * SMEM_BYTES_PER_CLOCK * 1e6 * sm_max_mhz())
    k2_floor = 1e3 * (k2_traffic["device_bytes"] / HBM_BYTES_PER_S
                      + k2_traffic["chip_bytes"] / smem_rate)
    print(f"[9 timing] {CONCAT_METRIC} = {bits_per_s:.1f} "
          f"bits/s ({1e3 * dt:.2f} ms per block of {BATCH}, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) on {card}; one block's "
          f"stages, ms: {stages}; layered BP on the {llr.shape[0]} "
          f"codewords of phase 7: kernel {kernel_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bp_b}, design ({K2_DESIGN}) floor "
          f"{k2_floor:.4f} ms ({k2_traffic['device_bytes']} device bytes, "
          f"{k2_traffic['chip_bytes']} on-chip bytes at "
          f"{smem_rate / 1e12:.2f} TB/s) ({clock.lap():.1f} s)",
          flush=True)
    return dict(model=cm, launches=launches, cnt=cnt, fer=fer, ber=ber,
                bp_ok=bp_ok, max_abs_err=max(errs), bits_per_s=bits_per_s,
                bp_record={
                    "name": "bp_qc_layered", "route": "cuda",
                    "source": "sparc_ldpc_tpu_torch/csrc/bp_qc_layered.cu",
                    "replaces": "sparc_ldpc_tpu/ops/bp_qc_pallas.py:70",
                    "max_abs_err": res7["concat block"]["max_abs_err"],
                    "ms": kernel_ms, "plain_ms": plain_ms, **bp_b,
                    "library_ms": None, "design": K2_DESIGN})


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

    from sparc_ldpc_tpu_torch.ops.fwht import factorize_pow2
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
    f1, f2 = factorize_pow2(1 << 19, max_log=10)
    for B in (KERNEL_BATCH, CLI_BATCH):
        x = torch.randn((B, 1 << 19), generator=gen, device=dev)
        ms[B] = (call_ms(lambda: fwht2(x), REPS, inner=10),
                 call_ms(lambda: fwht2_reference(x), REPS, inner=2))
    # the library calls at the campaign's B, held to the plain version
    ref = fwht2_reference(x)
    lib_ms, lib_err = library_times(lambda f: library_fwht2(x, f1, f2, f),
                                    ref, REPS, 10)
    # x read and the result written once; log2(N) adds per element
    fw_b = bound(2 * tensor_bytes(x), {"fp32": math.log2(x.shape[1]) * x.numel()})
    # the design's device-memory bytes: a row launch into the output and a
    # column launch in place, each reading and writing the tile (16 bytes
    # an element; the function's own 8 are its bound)
    floor_ms = 1e3 * K5_DESIGN_BYTES * x.numel() / HBM_BYTES_PER_S
    del x, ref
    print(f"[11 fwht2 vs plain] design: {K5_DESIGN}, {K5_DESIGN_BYTES} bytes "
          f"an element (at B={CLI_BATCH}, N=2^19 a floor of {floor_ms:.3f} "
          f"ms at 3.35 TB/s); max err / max |out| at B="
          f"{KERNEL_BATCH}: {res}; ms per call at N=2^19 (kernel, plain): "
          f"{ms}, bound at B={CLI_BATCH} {fw_b}; library (bf16 factors {f1} "
          f"x {f2}) ms {lib_ms}, max err / max |plain| {lib_err} on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    for k, v in res.items():
        require(v <= 1e-5, f"fwht2 at N={k}: error {v}")
    for form, e in lib_err.items():
        require(e <= LIBRARY_TOL, f"fwht2's library {form}: error {e}")
    return {"name": "fwht2", "route": "cuda",
            "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
            "replaces": "sparc_ldpc_tpu/ops/fwht.py:271",
            "max_abs_err": err_abs, "ms": ms[CLI_BATCH][0],
            "plain_ms": ms[CLI_BATCH][1], **fw_b,
            "library_ms": min(lib_ms.values()),
            "library_ms_by_form": lib_ms, "design": K5_DESIGN}


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
    # the yardstick: one scaled torch.softmax (the posteriors alone)
    scale = sq_npl[None, :, None] / t2[:, None, None]
    library_ms = call_ms(lambda: torch.softmax(x * scale, -1), REPS,
                         inner=10)
    # s, tau2, sq read and beta, post written once; about 6 operations per
    # element (scale, max, subtract, exp, sum, divide)
    dn_b = bound(3 * tensor_bytes(x) + tensor_bytes(t2, sq_npl),
                 {"fp32": 6.0 * x.numel()})
    del s, x
    print(f"[12 denoise vs plain] B={KERNEL_BATCH} L={L} M={M}, tau2 1e-3 "
          f"to 2: finite {finite}; beta max err {err_b:.3e} (atol "
          f"{atol_b:.3e}, rtol 1e-5: {ok_b}), post max err {err_p:.3e} "
          f"(atol 1e-7, rtol 1e-5: {ok_p}); ms per call (kernel, plain): "
          f"{ms}; at B={CLI_BATCH} scaled torch.softmax {library_ms:.3f} ms,"
          f" bound {dn_b} on {card} ({clock.lap():.1f} s)", flush=True)
    require(finite, "the denoiser kernel gave inf or nan")
    require(ok_b and ok_p, "the denoiser kernel disagrees with its plain "
            "version")
    return {"name": "denoise", "route": "cuda",
            "source": "sparc_ldpc_tpu_torch/csrc/denoise.cu",
            "replaces": "sparc_ldpc_tpu/ops/denoiser.py:40",
            "max_abs_err": err_b, "ms": ms[CLI_BATCH][0],
            "plain_ms": ms[CLI_BATCH][1], **dn_b, "library_ms": library_ms}


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


def device_ms_by_kernel(fn, names) -> dict:
    """Device ms of one fn() call by kernel, from a torch.profiler Chrome
    trace: each of `names` sums the kernels whose name contains it, the
    rest go to "other"."""
    us = dict.fromkeys((*names, "other"), 0.0)
    for e in traced_kernels(fn):
        key = next((k for k in names if k in e.get("name", "")), "other")
        us[key] += float(e.get("dur", 0.0))
    return {k: round(v / 1e3, 3) for k, v in us.items()}


def launch_ms(fn, per_call: dict) -> dict:
    """Device ms of each launch of one fn() call, in launch order, for each
    name of per_call (the kernels whose name contains it), which gives the
    launches a call makes.  Two calls are traced and the second one's
    launches kept: a trace can lose the records of its first kernels."""
    out = {k: [] for k in per_call}
    for e in sorted(traced_kernels(fn, calls=2), key=lambda e: float(e["ts"])):
        key = next((k for k in per_call if k in e.get("name", "")), None)
        if key is not None:
            out[key].append(float(e.get("dur", 0.0)) / 1e3)
    for k, n in per_call.items():
        require(len(out[k]) >= n, f"the trace holds {len(out[k])} {k} "
                f"launches, fewer than one call's {n}")
        out[k] = out[k][-n:]
    return out


def traced_kernels(fn, calls: int = 1) -> list:
    """The kernel events of `calls` fn() calls from a torch.profiler Chrome
    trace, after a warm-up call in the same profiler (a one-call trace late
    in a long process lost some of its first kernels' records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(1 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return [e for e in events if e.get("cat") == "kernel"]


CAMPAIGN_RATE_TOL = 0.02   # 13b's campaign bits/s against phase 9's


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
        require(rec["bits_per_s"] is not None and abs(
            rec["bits_per_s"] / cp["bits_per_s"] - 1) <= CAMPAIGN_RATE_TOL,
            f"the concat campaign's bits_per_s {rec['bits_per_s']} is not "
            f"within {CAMPAIGN_RATE_TOL:.0%} of phase 9's "
            f"{cp['bits_per_s']}")
        require(concat_windows(rec["fer"], rec["ber"], bp_ok) == [],
                f"concat campaign off: "
                f"{concat_windows(rec['fer'], rec['ber'], bp_ok)}")
        return dict(cli_pallas=la, cli_concat=lb), rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def option_runs(args, opts, idx, T: int) -> dict:
    """The fused AMP kernel (the form `args`' shape and the keyword
    arguments route to) against its plain version for each option set
    (`compare_runs`)."""
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference)

    return {label: compare_runs(
        label, amp_fused(*args, encode_idx=idx, **kw),
        amp_fused_reference(*args, encode_idx=idx, **kw), args, kw, idx, T)
        for label, kw in opts.items()}


def compare_runs(label: str, kout, pout, args, kw: dict, idx,
                 T: int) -> dict:
    """One kernel result against its plain version's, both (beta, trace,
    iters) of the call amp_fused(*args, encode_idx=idx, **kw): the
    iteration counts, flips, section error rates, the tau2 error up to the
    first stop and the beta error where the counts agree."""
    import torch

    from sparc_ldpc_tpu_torch.models.amp import decision_flips

    (bk, tk, ik), (bp, tp, ip) = kout, pout
    require(bool(torch.isfinite(bk).all() & torch.isfinite(tk).all()),
            f"{label}: kernel output is not finite")
    t_min = int(min(ik.min(), ip.min()))
    same = ik == ip
    flips, decisive = decision_flips(bk, bp)
    r = dict(
        iters_kernel_mean=float(ik.float().mean()),
        iters_plain_mean=float(ip.float().mean()),
        iters_max_diff=int((ik - ip).abs().max()),
        iters_min=int(ik.min()), flips=flips, decisive=decisive,
        ser_kernel=float((bk.argmax(-1) != idx).float().mean()),
        ser_plain=float((bp.argmax(-1) != idx).float().mean()),
        tau2_rel_err=float(((tk - tp).abs() / tp)[:t_min].max()),
        beta_abs_err=float((bk - bp).abs()[same].max())
        if bool(same.any()) else 0.0)
    pin = kw.get("pin_idx")
    if pin is not None:
        # sq in the kernels' scale-free form and back, as they round it
        rows, n = pin >= 0, args[4]
        sq = (args[2] * math.sqrt(n)) * (1.0 / math.sqrt(n))
        want = torch.where(torch.arange(bk.shape[-1], device=bk.device)
                           == pin[..., None], sq[None, :, None], 0.0)
        r["pinned_rows_exact"] = bool(torch.equal(bk[rows], want[rows])
                                      and torch.equal(bp[rows], want[rows]))
    sched = kw.get("tau2_schedule")
    if sched is not None:
        B = tk.shape[1]
        r["trace_is_schedule"] = bool(
            torch.equal(tk, sched[:, None].expand(T, B))
            and torch.equal(tp, sched[:, None].expand(T, B)))
    return r


def check_options(res: dict, sections: int, f32_keys=()) -> None:
    """Phase 3's and 6's rules: at most 1 % flipped decisions; in float32
    (labels in f32_keys) no decisive flip, tau2 to rtol 1e-4, beta to
    1e-3 and iteration counts within 4; with bf16 rounding tau2 to rtol
    2e-2 and mean iteration counts within 2."""
    for key, r in res.items():
        f32 = key in f32_keys
        require(r["flips"] <= 0.01 * sections, f"{key}: flips > 1%")
        require(r["tau2_rel_err"] <= (1e-4 if f32 else 2e-2),
                f"{key}: tau2 rel err {r['tau2_rel_err']}")
        if f32:
            require(r["decisive"] == 0, f"{key}: decisive flips")
            require(r["beta_abs_err"] <= 1e-3,
                    f"{key}: beta abs err {r['beta_abs_err']}")
            require(r["iters_max_diff"] <= 4,
                    f"{key}: iteration counts differ by more than 4")
        else:
            require(abs(r["iters_kernel_mean"] - r["iters_plain_mean"]) <= 2,
                    f"{key}: mean iteration counts differ by more than 2")
        require(r.get("pinned_rows_exact", True),
                f"{key}: pinned rows are not sq * one_hot")
        require(r.get("trace_is_schedule", True),
                f"{key}: trace is not the schedule")


def mono_design_bytes(iters, L: int, M: int, ns: int, T: int) -> dict:
    """The bytes K6's design moves in one call, by launch (MONO_STAGES):
    the encode (the indices read, y_n read on the support and y written
    on it), then per iteration t over the codewords still running it: C1
    (the float32 work tile read unless t = 0, y, z read (z not at t = 0)
    and z and its packed bf16 copy written on the support, the row
    |beta'|^2 partials read), R2C2 (the packed z read, the work tile
    written), R3 (the work tile read, beta' read unless t = 0 and
    written, the work tile written unless it is the codeword's last
    iteration).  iters (B,) the iterations each codeword ran."""
    N = L * M
    it = iters.to("cpu").long()
    B = it.numel()
    out = {k: [] for k in MONO_STAGES}
    out[MONO_STAGES[0]].append(B * (4 * L + 8 * ns))
    for t in range(T):
        active = int((it > t).sum())
        last = int((it == t + 1).sum())
        out[MONO_STAGES[1]].append(active * ((4 * N + 4 * L if t else 0)
                                             + (16 if t else 12) * ns))
        out[MONO_STAGES[2]].append(active * (4 * ns + 4 * N))
        out[MONO_STAGES[3]].append(active * (4 * N + (8 if t else 4) * N)
                                   + (active - last) * 4 * N)
    total = sum(sum(v) for v in out.values())
    return {**out, "total": total, "floor_ms": 1e3 * total / HBM_BYTES_PER_S}


def slab_design_bytes(iters, L: int, M: int, ns: int, T: int) -> dict:
    """The bytes K7's design moves in one call, by launch (SLAB_STAGES_K7):
    the encode (the indices read, y_n read on the support and y written
    on it), then per iteration t over the codewords still running it: C1
    (the bf16 work tile read unless t = 0, y, z read (z not at t = 0) and
    z and its packed bf16 copy written on the support, the slab |beta'|^2
    partials read), R2C2 (the packed z read, u written in float32), R3 (u
    read, beta' read unless t = 0 and written, the bf16 work tile written
    unless it is the codeword's last iteration).  iters (B,) the
    iterations each codeword ran."""
    N = L * M
    it = iters.to("cpu").long()
    B = it.numel()
    out = {k: [] for k in SLAB_STAGES_K7}
    out[SLAB_STAGES_K7[0]].append(B * (4 * L + 8 * ns))
    for t in range(T):
        active = int((it > t).sum())
        last = int((it == t + 1).sum())
        out[SLAB_STAGES_K7[1]].append(active * (
            (2 * N + 4 * (L // min(128, L)) if t else 0)
            + (16 if t else 12) * ns))
        out[SLAB_STAGES_K7[2]].append(active * (4 * ns + 4 * N))
        out[SLAB_STAGES_K7[3]].append(active * (4 * N + (8 if t else 4) * N)
                                      + (active - last) * 2 * N)
    total = sum(sum(v) for v in out.values())
    return {**out, "total": total, "floor_ms": 1e3 * total / HBM_BYTES_PER_S}


def mono_path(dev, card: str, sp: dict, clock: Clock) -> dict:
    """Phases 14-15: K6 against its plain version, and the mono main path
    (amp_kernel="fused" on the headline configuration)."""
    import dataclasses

    import torch

    from sparc_ldpc_tpu_torch.design.se import se_trajectory
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference, fused_form, mono_adjoint,
        mono_tile_reference)
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    # phase 4's model (the SE-derived T) with the "fused" kernel choice
    hm = sp["model"]
    model = dataclasses.replace(hm, cfg=hm.cfg.replace(amp_kernel="fused"))
    c = model.cfg
    T, L, M, n = c.amp_iters, c.L, c.M, c.n
    sigma = math.sqrt(model.sigma2)
    mask2d = model.op.mask.reshape(L, M)
    require(fused_form(L, model.fused_kw["fused_split"]) == "mono"
            and not model.noise_in_kernel,
            "amp_kernel='fused' at L=1024 must route to the mono form with "
            "the noise drawn outside")

    def draw(batch, stream, block):
        gen = block_generator(SEED, stream, block, dev)
        bits = torch.randint(0, 2, (batch, c.k_bits), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn((batch, n), generator=gen, device=dev)
        return (model.op.embed_y(noise * sigma).reshape(batch, L, M),
                bits_to_indices(bits, c.logM), gen)

    # 14. K6 against its plain version at full width
    B14 = OPTION_BATCH
    y_n, idx, gen = draw(B14, 11, 0)
    # the decode's adjoint launch alone, from a compact z on the operator's
    # support: normals to 1e-5 of the scale, integers bit for bit
    sup = model.op.split_support(L, M, dev)
    adj, adj_err = {}, 0.0
    for kind in ("normal", "integer"):
        zc = (torch.randn((B14, sup.ns), generator=gen, device=dev)
              if kind == "normal" else torch.randint(
                  -8, 9, (B14, sup.ns), generator=gen, device=dev).float())
        dense = torch.zeros((B14, L * M), device=dev)
        dense[:, sup.flat] = zc
        ref = mono_tile_reference(dense.reshape(B14, L, M))
        got = mono_adjoint(zc, sup)
        adj[kind] = (float((got - ref).abs().max() / ref.abs().max())
                     if kind == "normal" else bool(torch.equal(got, ref)))
        adj_err = max(adj_err, float((got - ref).abs().max()))
    del ref, dense, got
    rows = torch.rand((B14, L), generator=gen, device=dev) < 0.4
    pin = torch.where(rows, idx, -1).to(torch.int32)
    tr = se_trajectory(model.p_alloc, n, M, SCHED_MARGIN * model.sigma2,
                       T=OPTION_T, method="quad")
    sched = torch.as_tensor(
        np.pad(tr[1:], (0, max(0, OPTION_T - len(tr) + 1)),
               mode="edge")[:OPTION_T], dtype=torch.float32, device=dev)
    res = option_runs((y_n, mask2d, model.sq_npl, c.P, n, T),
                      {"fixed T": {}}, idx, T)
    res.update(option_runs(
        (y_n, mask2d, model.sq_npl, c.P, n, OPTION_T),
        {"tol": dict(tol=1e-4), "tol+pin": dict(tol=1e-4, pin_idx=pin),
         "schedule": dict(tau2_schedule=sched)}, idx, OPTION_T))
    print(f"[14 mono kernel vs plain] B={B14} L={L} M={M} T={T} (options "
          f"at T={OPTION_T}): the adjoint launch from the compact z "
          f"(ns={sup.ns}): max err {adj_err:.3e}, normals "
          f"{adj['normal']:.3e} of max |out|, integers bit for bit: "
          f"{adj['integer']}; {res} ({clock.lap():.1f} s)", flush=True)
    require(adj["normal"] <= 1e-5, f"mono adjoint err {adj['normal']}")
    require(adj["integer"], "mono adjoint: integer inputs differ")
    check_options(res, B14 * L)
    require(res["tol"]["iters_min"] < OPTION_T, "tol: no early stop")
    del y_n

    # 15. the mono main path (phase 4's model and SE fixed point)
    se_fp = sp["se_fp"]
    reset_counts()
    out = model.run_block(block_generator(SEED, 12, 0, dev), BATCH)
    launches = read_counts()
    cnt = {k: v.item() for k, v in out.items()}
    cnt2 = {k: v.item() for k, v in model.run_block(
        block_generator(SEED, 12, 0, dev), BATCH).items()}
    tau_gap = cnt["tau2_final"] / se_fp - 1.0
    times = []
    for r in range(REPS):
        gen = block_generator(SEED, 12, 1 + r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = int(model.run_block(gen, BATCH)["bit_errors"])
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    bits_per_s = BATCH * c.k_bits / dt
    y_n, idx, _ = draw(BATCH, 12, 9)
    args = (y_n, mask2d, model.sq_npl, c.P, n, T)
    kw = dict(encode_idx=idx, support=sup)
    kernel_ms, kout = timed_result(lambda: amp_fused(*args, **kw), REPS)
    # each launch's device ms beside the bytes K6's design moves in it
    per = launch_ms(lambda: amp_fused(*args, **kw),
                    dict(zip(MONO_STAGES, (1, T, T, T))))
    db = mono_design_bytes(kout[2], L, M, sup.ns, T)
    stages = {k: sum(v) for k, v in per.items()}
    by_launch = {k: dict(ms=[round(x, 3) for x in per[k]],
                         tb_per_s=[round(b / t / 1e9, 3)
                                   for b, t in zip(db[k], per[k])])
                 for k in MONO_STAGES}
    plain_ms, pout = timed_result(
        lambda: amp_fused_reference(*args, encode_idx=idx), 1)
    mono_b = amp_bound(BATCH, L, M, T, kout[2])
    # the timed calls' results, held to phase 14's rules at this shape
    res15 = {"main path": compare_runs("main path", kout, pout, args, {},
                                       idx, T)}
    del y_n, args, kout, pout
    print(f"[15 mono main path] run_block B={BATCH}: launches {launches}; "
          f"counters {cnt}; tau2_final vs SE fixed point {se_fp:.4f}: "
          f"{100 * tau_gap:+.2f} %; same seed again: "
          f"{'identical' if cnt2 == cnt else cnt2}; {bits_per_s:.1f} bits/s "
          f"({1e3 * dt:.2f} ms per block, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) against phase 5's "
          f"{sp['bits_per_s']:.1f} ({sp['block_ms']:.2f} ms, split form, "
          f"noise in the kernel); decode call at B={BATCH}: mono kernel "
          f"{kernel_ms:.2f} ms, plain {plain_ms:.2f} ms, bound {mono_b} "
          f"(split kernel {sp['kernel_ms']:.2f} ms); one call's device ms "
          f"by launch kind (torch.profiler): {stages}, by launch with the "
          f"TB/s of its design bytes: {by_launch}; design bytes "
          f"{db['total'] / 1e9:.3f} GB, over 3.35 TB/s {db['floor_ms']:.3f} "
          f"ms; the timed calls, kernel vs plain: {res15} on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    check_options(res15, BATCH * L)
    require(launches["amp_mono"] > 0, "the mono path did not launch K6")
    require(launches["amp_split"] == 0, "the mono path launched K1")
    require(cnt["trials"] == BATCH and cnt["iters_sum"] == BATCH * T,
            "trial or iteration count wrong")
    require(abs(tau_gap) <= 0.03, f"tau2_final off SE by {tau_gap:+.3%}")
    require(cnt2 == cnt, "same seed gave different counters")
    return dict(launches=launches, adj_err=adj_err, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound=mono_b, block_ms=1e3 * dt,
                bits_per_s=bits_per_s, stages_ms=stages)


def l4096_path(dev, card: str, clock: Clock) -> dict:
    """Phase 16: K1 at L=4096 (fast_l4096) against its plain version."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference, channel_noise,
        channel_noise_reference, fused_form, fwht_tile, fwht_tile_reference,
        noise_uniforms, noise_uniforms_reference)
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    model = SparcModel.build(slt.PRESETS["fast_l4096"], FAST_EBNO_DB, dev)
    c = model.cfg
    L, M, n = c.L, c.M, c.n
    sigma = math.sqrt(model.sigma2)
    mask2d = model.op.mask.reshape(L, M)
    require(model.noise_in_kernel and fused_form(L) == "split",
            "fast_l4096 must run K1's split form with the noise in it")

    def draw(batch, block):
        gen = block_generator(SEED, 13, block, dev)
        bits = torch.randint(0, 2, (batch, c.k_bits), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn((batch, n), generator=gen, device=dev)
        return (model.op.embed_y(noise * sigma).reshape(batch, L, M),
                bits_to_indices(bits, c.logM), gen)

    B = L4096_BATCH
    y_n, idx, gen = draw(B, 0)
    args = (y_n, mask2d, model.sq_npl, c.P, n, L4096_T)
    opts = {f"{label} {prec}": dict(precision=prec, **kw)
            for prec in ("highest", "bf16")
            for label, kw in (("fixed T", {}), ("tol", dict(tol=1e-4)))}
    res = option_runs(args, opts, idx, L4096_T)
    x = torch.randn((B, L, M), generator=gen, device=dev)
    ref = fwht_tile_reference(x)
    tile_rel = float((fwht_tile(x) - ref).abs().max() / ref.abs().max())
    seeds = model.draw_seeds(gen, B)
    u1k, thk = noise_uniforms(seeds, L, M)
    u1p, thp = noise_uniforms_reference(seeds, L, M)
    uniforms_equal = bool(torch.equal(u1k, u1p) and torch.equal(thk, thp))
    normal_err = float((channel_noise(seeds, mask2d, 1.0)
                        - channel_noise_reference(seeds, mask2d, 1.0))
                       .abs().max())
    del x, ref, u1k, thk, u1p, thp, y_n, args
    print(f"[16 K1 at L={L} vs plain] B={B} M={M} T={L4096_T}: {res}; "
          f"transform alone (f32) {tile_rel:.3e} of max |out|; noise "
          f"uniforms equal {uniforms_equal}, normals max err "
          f"{normal_err:.3e} ({clock.lap():.1f} s)", flush=True)
    check_options(res, B * L, f32_keys=("fixed T highest", "tol highest"))
    require(tile_rel <= 1e-5, f"f32 transform err {tile_rel}")
    require(uniforms_equal, "kernel and plain uniforms differ at L=4096")
    require(normal_err <= 1e-5, f"normals differ by {normal_err}")

    # the decode call at the campaign's shape: B=512, T=32, tol 1e-4
    y_n, idx, gen = draw(FAST_BATCH, 1)
    seeds = model.draw_seeds(gen, FAST_BATCH)
    args = (y_n, mask2d, model.sq_npl, c.P, n, c.amp_iters)
    kw = dict(encode_idx=idx, tol=c.amp_tol)
    sup = model.op.split_support(L, M, dev)
    kernel_ms, kout = timed_result(
        lambda: amp_fused(*args, support=sup, **kw), REPS)
    iters = kout[2]
    noise_ms = call_ms(lambda: amp_fused(
        None, *args[1:], noise_seed=seeds, noise_sigma=sigma, support=sup,
        **kw), REPS)
    stages = device_ms_by_kernel(
        lambda: amp_fused(None, *args[1:], noise_seed=seeds,
                          noise_sigma=sigma, support=sup, **kw), K1_STAGES)
    plain_ms, pout = timed_result(lambda: amp_fused_reference(*args, **kw),
                                  1)
    l_b = amp_bound(FAST_BATCH, L, M, c.amp_iters, iters)
    # the timed calls' results, held to phase 6's bf16 rules at this shape
    res_t = {"campaign shape": compare_runs("campaign shape", kout, pout,
                                            args, kw, idx, c.amp_iters)}
    del y_n, args, kout, pout
    print(f"[16 timing] decode call at B={FAST_BATCH}, L={L}, T cap "
          f"{c.amp_iters}, tol {c.amp_tol} (mean {float(iters.float().mean()):.2f}"
          f" iterations): kernel {kernel_ms:.2f} ms with the noise as input,"
          f" {noise_ms:.2f} ms drawing it; plain {plain_ms:.2f} ms; bound "
          f"{l_b}; one call's device ms by launch (torch.profiler, noise "
          f"drawn): {stages}; the timed calls, kernel vs plain: {res_t} on "
          f"{card} ({clock.lap():.1f} s)", flush=True)
    check_options(res_t, FAST_BATCH * L)
    return dict(max_abs_err=max(r["beta_abs_err"] for k, r in res.items()
                                if k.endswith("highest")),
                kernel_ms=kernel_ms, noise_ms=noise_ms, plain_ms=plain_ms,
                bound=l_b, model=model)


def fast_cli_phase(card: str, clock: Clock) -> dict:
    """Phase 17: `campaign --preset fast_l4096` as shipped, in process."""
    from sparc_ldpc_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fast_")
    try:
        out = os.path.join(tmp, "fast.jsonl")
        argv = ["campaign", "--preset", "fast_l4096", "--ebno",
                str(FAST_EBNO_DB), "--batch", str(FAST_BATCH),
                "--max-trials", str(FAST_TRIALS), "--min-frame-errors",
                "1000000", "--out", out]
        reset_counts()
        require(cli.main(argv) == 0, "the fast_l4096 campaign failed")
        launches = read_counts()
        rec = last_record(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lo, hi = FAST_FER_WINDOW
    print(f"[17 cli fast_l4096] launches {launches}; FER {rec['fer']:.4f} "
          f"(window [{lo}, {hi}], oracle 0.553), BER {rec['ber']:.4e} "
          f"(oracle {FAST_ORACLE_BER}), trials {rec['trials']} in "
          f"{rec['blocks']} blocks, mean iterations {rec['mean_iters']:.2f};"
          f" bits_per_s {rec['bits_per_s']}, first_block_s "
          f"{rec['first_block_s']:.3f} on {card} ({clock.lap():.1f} s)",
          flush=True)
    require(launches["amp_split"] > 0 and launches["amp_split_noise"] > 0,
            "fast_l4096 did not run K1 with its noise")
    require(launches["amp_mono"] == 0, "fast_l4096 launched K6")
    require(rec["trials"] >= FAST_TRIALS, "too few trials")
    require(lo <= rec["fer"] <= hi, f"fast_l4096 FER {rec['fer']}")
    require(0.7 * FAST_ORACLE_BER <= rec["ber"] <= 1.4 * FAST_ORACLE_BER,
            f"fast_l4096 BER {rec['ber']} off the oracle's "
            f"{FAST_ORACLE_BER}")
    require(rec["bits_per_s"] is not None, "no steady bits/s")
    return dict(launches=launches, rec=rec)


def k3_phase(dev, card: str, clock: Clock) -> dict:
    """Phase 18: K3 (`fwht_tile` with its scale) against its plain
    version, and its time beside its bound."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        fwht_tile, fwht_tile_reference)
    from sparc_ldpc_tpu_torch.ops.fwht import fwht_kron, round_bf16
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    def flip_limit(x, scale) -> float:
        """In bf16 both round the H_M stage's values before H_l, but they
        sum in other orders, so a value's rounding may fall to the other
        neighbour: that moves the outputs of its column by one bf16 ulp
        of it, times the scale.  The limit is one ulp of the largest."""
        v = float(fwht_kron(round_bf16(x), "highest", -1).abs().max())
        return scale * 2.0 ** (math.floor(math.log2(v)) - 7)

    def compare(kout, pout, x, scale) -> dict:
        """Max |kernel - plain| and the flip limit, both over max |plain|,
        and whether the error is within the limit."""
        err, top = float((kout - pout).abs().max()), float(pout.abs().max())
        lim = flip_limit(x, scale)
        return dict(err=err / top, limit=lim / top, ok=err <= lim), err

    # (B, l) with the 1/sqrt(n) of its configuration: l = L / 2 of the
    # headline configuration and of fast_l4096 at B=64, and the shapes the
    # main paths give K3: phase 20's slabs (B=1024, l = 1024 / S) and
    # phase 21's (the campaign's B, l = 4096 / 4)
    n_head = slt.SparcConfig(**HEADLINE).n
    n_fast = slt.PRESETS["fast_l4096"].n
    shapes = {(KERNEL_BATCH, 512): n_head, (KERNEL_BATCH, 2048): n_fast,
              (SHARD_BATCH, 512): n_head, (SHARD_BATCH, 256): n_head,
              (FAST_BATCH, 1024): n_fast}
    gen = block_generator(SEED, 14, 0, dev)
    res, err_abs = {}, 0.0
    M = HEADLINE["M"]
    for (B, l), n in shapes.items():
        scale = 1.0 / math.sqrt(n)
        x = torch.randn((B, l, M), generator=gen, device=dev)
        ref = fwht_tile_reference(x, "highest") * scale
        err = float((fwht_tile(x, "highest", scale) - ref).abs().max())
        r = dict(f32=err / float(ref.abs().max()))
        err_abs = max(err_abs, err)
        del ref
        r["bf16"], err = compare(fwht_tile(x, "bf16", scale),
                                 fwht_tile_reference(x, "bf16") * scale,
                                 x, scale)
        err_abs = max(err_abs, err)
        ints = torch.randint(-8, 9, (B, l, M), generator=gen,
                             device=dev).float()
        r["bf16 integers equal"] = bool(torch.equal(
            fwht_tile(ints, "bf16", scale),
            fwht_tile_reference(ints, "bf16") * scale))
        res[(B, l)] = r
        del x, ints
        torch.cuda.empty_cache()
    # timed at the campaign's B, l = 4096 / 4 (phase 21) and / 2; the
    # results of the timed calls are held to the plain version's, and the
    # library call's at l = 1024 to it within LIBRARY_TOL
    ms, bounds, timed, stages, design = {}, {}, {}, {}, {}
    scale = 1.0 / math.sqrt(n_fast)
    for l in (1024, 2048):
        x = torch.randn((FAST_BATCH, l, M), generator=gen, device=dev)
        k_ms, kout = timed_result(lambda: fwht_tile(x, "bf16", scale), REPS,
                                  inner=5)
        p_ms, pout = timed_result(
            lambda: fwht_tile_reference(x, "bf16") * scale, REPS)
        ms[l] = (k_ms, p_ms)
        timed[l], err = compare(kout, pout, x, scale)
        err_abs = max(err_abs, err)
        # each launch's device ms beside its design bytes (the row and the
        # column launch at both l: the cluster kernel takes l <= 256)
        stages[l] = {k: v for k, v in device_ms_by_kernel(
            lambda: fwht_tile(x, "bf16", scale), K3_STAGES).items()
            if k in K3_STAGES and v > 0}
        design[l] = {k: K3_DESIGN_BYTES[k] * x.numel() for k in stages[l]}
        if l == 1024:
            lib_ms, lib_err = library_times(
                lambda f: library_tile(x, scale, f), pout, REPS, 5)
        # x read and the result written once; log2(l M) adds an element
        bounds[l] = bound(2 * tensor_bytes(x),
                          {"fp32": math.log2(l * M) * x.numel()})
        del x, kout, pout
        torch.cuda.empty_cache()
    design_ms = {l: {k: dict(ms=round(stages[l][k], 4),
                             tb_per_s=round(b / stages[l][k] / 1e9, 3))
                     for k, b in design[l].items()} for l in design}
    floor = {l: 1e3 * sum(d.values()) / HBM_BYTES_PER_S
             for l, d in design.items()}
    print(f"[18 K3 fwht_tile vs plain] M={M}, scale 1/sqrt(n), errors over "
          f"max |plain| by (B, l): {res}; ms per call, bf16 (kernel, plain) "
          f"at B={FAST_BATCH}: {ms}, their results' bf16 errors {timed}, "
          f"bounds {bounds}; by launch with the TB/s of its design bytes: "
          f"{design_ms}, design floor {floor} ms; library (bf16 "
          f"factors) at l=1024 ms {lib_ms}, max err / max |plain| "
          f"{lib_err} on {card} ({clock.lap():.1f} s)", flush=True)
    for s, r in res.items():
        require(r["f32"] <= 1e-5, f"K3 at {s}: f32 error {r['f32']}")
        require(r["bf16"]["ok"], f"K3 at {s}: bf16 error {r['bf16']}")
        require(r["bf16 integers equal"], f"K3 at {s}: integer inputs "
                "differ in bf16")
    for l, r in timed.items():
        require(r["ok"], f"K3's timed call at l={l}: bf16 error {r}")
    for form, e in lib_err.items():
        require(e <= LIBRARY_TOL, f"K3's library {form}: error {e}")
    return {"name": "fwht_tile", "route": "cuda",
            "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
            "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:672",
            "max_abs_err": err_abs, "ms": ms[1024][0],
            "plain_ms": ms[1024][1], **bounds[1024],
            "library_ms": min(lib_ms.values()), "library_ms_by_form": lib_ms,
            "ms_l2048": ms[2048][0], "plain_ms_l2048": ms[2048][1],
            "bound_ms_l2048": bounds[2048]["bound_ms"],
            "stages_ms": stages[1024]}


def virtual_policy(dev, D: int, S: int):
    """A (D, S) virtual mesh of the one card."""
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh

    return ShardingPolicy(make_mesh(S, [dev] * (D * S)))


def dp_phase(dev, card: str, sp: dict, clock: Clock) -> dict:
    """Phase 19: phase 4's block on a virtual (4 x 1) mesh."""
    import dataclasses

    import torch

    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    model = dataclasses.replace(sp["model"], policy=virtual_policy(dev, 4, 1))
    c = model.cfg
    reset_counts()
    out = model.run_block(block_generator(SEED, 0, 0, dev), BATCH)
    launches = read_counts()
    cnt = {k: v.item() for k, v in out.items()}
    times = []
    for r in range(REPS):
        gen = block_generator(SEED, 0, 1 + r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = int(model.run_block(gen, BATCH)["bit_errors"])
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    # the block's device ms by kernel: K1's stages and the gather
    stages = device_ms_by_kernel(
        lambda: model.run_block(block_generator(SEED, 0, 9, dev), BATCH),
        (*K1_STAGES, "CatArrayBatchedCopy"))
    ref = sp["cnt"]
    same = {k: cnt[k] == ref[k] for k in ref}
    tau_rel = abs(cnt["tau2_final"] / ref["tau2_final"] - 1.0)
    print(f"[19 data parallel, virtual (4 x 1)] run_block B={BATCH}: "
          f"launches {launches}; counters {cnt}; equal to phase 4's: "
          f"{all(same.values())} (tau2_final relative difference "
          f"{tau_rel:.3e}); {1e3 * dt:.2f} ms per block (median of "
          f"{[round(1e3 * t, 2) for t in times]}), "
          f"{BATCH * c.k_bits / dt:.1f} bits/s, against phase 5's "
          f"{sp['block_ms']:.2f} ms; one block's device ms by kernel "
          f"(torch.profiler): {stages} on {card} ({clock.lap():.1f} s)",
          flush=True)
    require(launches["amp_split"] == 4 and launches["amp_split_noise"] == 4,
            "the DP block must launch K1 once a shard, with its noise")
    require(all(v for k, v in same.items() if k != "tau2_final"),
            f"DP counters differ from the single device's: {same}")
    require(tau_rel <= 1e-6, f"DP tau2_final off by {tau_rel}")
    return dict(launches=launches, block_ms=1e3 * dt)


def sharded_phase(dev, card: str, sp: dict, clock: Clock) -> dict:
    """Phase 20: section-sharded decodes of the headline model against the
    single-device K1 decode of the same draws."""
    import dataclasses

    import torch

    from sparc_ldpc_tpu_torch.models.amp import decision_flips
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    torch.cuda.empty_cache()
    model = sp["model"]
    c = model.cfg
    T, L, B = c.amp_iters, c.L, SHARD_BATCH
    gen = block_generator(SEED, 15, 0, dev)
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    noise = torch.randn((B, c.n), generator=gen, device=dev) * math.sqrt(
        model.sigma2)
    idx = bits_to_indices(bits, c.logM)
    y = model.encode(bits) + noise
    ref = model.decode(noise, encode_idx=idx)
    ref_ms = call_ms(lambda: model.decode(noise, encode_idx=idx), REPS)
    tau_ref = float(ref.tau2_trace[-1].mean())
    res, launches = {}, {}
    for S in (2, 4):
        sharded = dataclasses.replace(model,
                                      policy=virtual_policy(dev, 1, S))
        reset_counts()
        got = sharded.decode(y)
        launches[S] = read_counts()
        flips, decisive = decision_flips(got.beta, ref.beta)
        tau = float(got.tau2_trace[-1].mean())
        res[S] = dict(
            flips=flips, decisive=decisive,
            ser=float((got.beta.argmax(-1) != idx).float().mean()),
            tau2_final=tau, tau2_rel_diff=abs(tau / tau_ref - 1.0),
            tau2_vs_se=tau / sp["se_fp"] - 1.0,
            ms=call_ms(lambda: sharded.decode(y), 2))
        del got
        # where a decode's device time goes, and the device's idle share
        res[S]["device_ms"] = device_ms_by_kernel(
            lambda: sharded.decode(y), SHARD_STAGES)
        res[S]["idle_share"] = 1.0 - sum(
            res[S]["device_ms"].values()) / res[S]["ms"]
    print(f"[20 section-sharded AMP, virtual (1 x S)] headline model, B={B},"
          f" T={T}: single-device K1 {ref_ms:.2f} ms per decode, section "
          f"error rate {float((ref.beta.argmax(-1) != idx).float().mean()):.4e}"
          f", mean final tau2 {tau_ref:.5f} ({100 * (tau_ref / sp['se_fp'] - 1):+.2f}"
          f" % off SE {sp['se_fp']:.4f}); sharded {res}; launches {launches} "
          f"on {card} ({clock.lap():.1f} s)", flush=True)
    require(abs(tau_ref / sp["se_fp"] - 1.0) <= 0.03,
            "the single-device decode is off SE")
    for S, r in res.items():
        require(r["flips"] <= 0.01 * B * L, f"S={S}: flips > 1 %")
        require(r["tau2_rel_diff"] <= 2e-2, f"S={S}: tau2 differs by "
                f"{r['tau2_rel_diff']}")
        require(abs(r["tau2_vs_se"]) <= 0.03, f"S={S}: tau2 off SE")
        require(launches[S]["fwht_tile"] == 2 * T * S,
                f"S={S}: K3 launched {launches[S]['fwht_tile']} times, not "
                f"2 T S")
        require(launches[S]["amp_split"] == 0, f"S={S}: K1 was launched")
    return dict(launches=launches, res=res, ref_ms=ref_ms)


def policy_campaign_phase(dev, card: str, concat_rec: dict,
                          clock: Clock) -> dict:
    """Phase 21: campaigns under a policy, in process."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.config import CampaignConfig
    from sparc_ldpc_tpu_torch.models.concat import ConcatSweep
    from sparc_ldpc_tpu_torch.models.sparc import SparcSweep
    from sparc_ldpc_tpu_torch.parallel.campaign import run_campaign

    torch.cuda.empty_cache()
    pol = virtual_policy(dev, 1, 4)
    sweep = SparcSweep(slt.PRESETS["fast_l4096"], device=dev, policy=pol)
    ccfg = CampaignConfig(ebno_grid_db=(FAST_EBNO_DB,), batch=FAST_BATCH,
                          min_frame_errors=1_000_000, max_trials=FAST_TRIALS,
                          base_seed=1234, section_shards=4)
    reset_counts()
    rec = run_campaign(sweep.model_for_point, ccfg, lambda m: m.cfg.k_bits,
                       policy=pol, verbose=False)[0]
    launches = read_counts()
    # phase 13b's campaign (the CLI's defaults) on a virtual (2 x 1) mesh
    pol2 = virtual_policy(dev, 2, 1)
    csweep = ConcatSweep(slt.PRESETS["concat"], device=dev, policy=pol2)
    cc = CampaignConfig(ebno_grid_db=(CONCAT_EBNO_DB,), batch=BATCH,
                        min_frame_errors=100, max_trials=4096,
                        base_seed=1234)
    reset_counts()
    crec = run_campaign(csweep.model_for_point, cc, lambda m: m.k_user,
                        policy=pol2, verbose=False)[0]
    claunches = read_counts()
    keys = ("bit_errors", "frame_errors", "trials", "bit_errors_sq",
            "blocks")
    same = {k: crec[k] == concat_rec[k] for k in keys}
    got = {k: crec[k] for k in keys}
    want = {k: concat_rec[k] for k in keys}
    lo, hi = FAST_FER_WINDOW
    print(f"[21 campaigns under a policy] fast_l4096 on a virtual (1 x 4) "
          f"mesh: launches {launches}; FER {rec['fer']:.4f} (window [{lo}, "
          f"{hi}]), BER {rec['ber']:.4e} (oracle {FAST_ORACLE_BER}), trials "
          f"{rec['trials']} in {rec['blocks']} blocks, mean iterations "
          f"{rec['mean_iters']:.2f}; bits_per_s {rec['bits_per_s']}; concat "
          f"on a virtual (2 x 1) mesh: launches {claunches}; {got} vs phase "
          f"13b's {want}; bits_per_s {crec['bits_per_s']} on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    require(launches["fwht_tile"] > 0 and launches["amp_split"] == 0,
            "the sharded fast_l4096 campaign must run K3, not K1")
    require(rec["trials"] >= FAST_TRIALS, "too few trials")
    require(lo <= rec["fer"] <= hi, f"sharded fast_l4096 FER {rec['fer']}")
    require(0.7 * FAST_ORACLE_BER <= rec["ber"] <= 1.4 * FAST_ORACLE_BER,
            f"sharded fast_l4096 BER {rec['ber']}")
    require(claunches["amp_split"] == 2 * 2 * crec["blocks"],
            "the DP concat campaign must launch K1 twice a block a shard")
    require(all(same.values()), f"DP concat counters differ: {same}")
    return dict(launches=launches, rec=rec, crec=crec)


def run_launcher(cmd, timeout: float, **kw) -> subprocess.CompletedProcess:
    """subprocess.run of a process launcher (torch.distributed.run) in a
    session of its own, so that a timeout kills it with every worker it
    started."""
    import signal

    proc = subprocess.Popen(cmd, start_new_session=True, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def distributed_phase(card: str, concat_rec: dict, clock: Clock) -> dict:
    """Phase 22: the concat campaign in two processes with --distributed."""
    import socket

    import torch

    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out = os.path.join(tmp, "dist.jsonl")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
               "--master_port", str(port), "-m", "sparc_ldpc_tpu_torch.cli",
               "campaign", "--distributed", "--preset", "concat", "--ebno",
               str(CONCAT_EBNO_DB), "--batch", str(BATCH), "--max-trials",
               "4096", "--out", out]
        proc = run_launcher(cmd, DIST_TIMEOUT_S, cwd=root)
        require(proc.returncode == 0, f"the two-process campaign failed "
                f"({proc.returncode}):\n{proc.stderr[-3000:]}")
        with open(out) as f:
            recs = [json.loads(x) for x in f if x.strip()]
        with open(out + ".journal") as f:
            journal = [x for x in f if x.strip()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("bit_errors", "frame_errors", "trials", "bit_errors_sq",
            "blocks")
    rec = recs[-1]
    same = {k: rec[k] == concat_rec[k] for k in keys}
    got = {k: rec[k] for k in keys}
    want = {k: concat_rec[k] for k in keys}
    print(f"[22 --distributed, 2 processes on one card] records {len(recs)},"
          f" journal lines {len(journal)}; processes {rec.get('processes')},"
          f" mesh {rec.get('mesh')}; {got} vs phase 13b's {want}; "
          f"bits_per_s {rec['bits_per_s']} on {card} ({clock.lap():.1f} s)",
          flush=True)
    require(len(recs) == 1, "more than one process wrote a record")
    require(len(journal) == rec["exec_blocks"], "the journal was written "
            "by more than one process")
    require(rec.get("processes") == 2, "the record is not two processes'")
    require(all(same.values()), f"two-process counters differ: {same}")
    return dict(rec=rec)


def multicard_phase(card: str, clock: Clock) -> dict:
    """Phase 23, with two GPUs or more: the headline block and the
    section-sharded decode on real meshes of every card, against one card
    and against the same meshes made virtual on cuda:0, and their times."""
    import dataclasses

    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    n = torch.cuda.device_count()
    gpus = [torch.device("cuda", i) for i in range(n)]
    dev = gpus[0]

    def host_ms(fn) -> float:
        """Median host ms of fn() over REPS calls after a warm-up, every
        card synchronized around each."""
        fn()
        times = []
        for _ in range(REPS):
            for g in gpus:
                torch.cuda.synchronize(g)
            t0 = time.perf_counter()
            fn()
            for g in gpus:
                torch.cuda.synchronize(g)
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def on(mesh):
        return dataclasses.replace(model, policy=ShardingPolicy(mesh))

    model = SparcModel.build(slt.SparcConfig(**HEADLINE), EBNO_DB, dev)

    def block(m):
        out = m.run_block(block_generator(SEED, 0, 0, dev), BATCH)
        return {k: v.item() for k, v in out.items()}

    dp = on(make_mesh(1, gpus))
    res = {f"DP ({n} x 1)": dict(
        equal=block(dp) == block(model), ms=host_ms(lambda: block(dp)),
        ms_one_card=host_ms(lambda: block(model)))}
    c = model.cfg
    gen = block_generator(SEED, 15, 0, dev)
    bits = torch.randint(0, 2, (SHARD_BATCH, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    y = model.encode(bits) + math.sqrt(model.sigma2) * torch.randn(
        (SHARD_BATCH, c.n), generator=gen, device=dev)
    for S in sorted({2, n}):
        if n % S or S & (S - 1):
            continue
        real, virtual = on(make_mesh(S, gpus)), on(make_mesh(S, [dev] * n))
        a, b = real.decode(y), virtual.decode(y)
        res[f"section-sharded ({n // S} x {S})"] = dict(
            equal=all(torch.equal(getattr(a, f), getattr(b, f))
                      for f in ("beta", "tau2_trace", "iters")),
            ms=host_ms(lambda: real.decode(y)),
            ms_virtual=host_ms(lambda: virtual.decode(y)))
        del a, b
        torch.cuda.empty_cache()
    print(f"[23 real meshes of {n} cards] headline model, run_block B={BATCH}"
          f" and decode B={SHARD_BATCH}, T={c.amp_iters}, ms: {res} on "
          f"{card} ({clock.lap():.1f} s)", flush=True)
    for k, r in res.items():
        require(r["equal"], f"{k}: the real mesh differs")
    return res


def slab_check_phase(dev, card: str, sp: dict, cp: dict, lp: dict,
                     clock: Clock) -> dict:
    """Phase 24: K7 (the slab form) against its plain version, bf16 rules
    (module docstring)."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.design.se import se_trajectory
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        fwht_tile_reference, slab_adjoint, slab_adjoint_reference, slab_tile)
    from sparc_ldpc_tpu_torch.ops.fwht import fwht_kron, round_bf16
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    slab = dict(form="slab")

    def draw(model, batch, stream):
        """A model's decode arguments at T = None, its true indices and the
        generator."""
        c = model.cfg
        gen = block_generator(SEED, stream, 0, dev)
        bits = torch.randint(0, 2, (batch, c.k_bits), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn((batch, c.n), generator=gen, device=dev)
        y_n = model.op.embed_y(noise * math.sqrt(model.sigma2)).reshape(
            batch, c.L, c.M)
        return ((y_n, model.op.mask.reshape(c.L, c.M), model.sq_npl, c.P,
                 c.n), bits_to_indices(bits, c.logM), gen)

    groups = []                  # (results, sections) for check_options
    # the headline shape at fixed T, and the transform alone
    hm = sp["model"]
    T, L, M = hm.cfg.amp_iters, hm.cfg.L, hm.cfg.M
    a, idx, gen = draw(hm, CHECK_BATCH, 18)
    groups.append((option_runs(a + (T,), {"headline fixed T": slab}, idx, T),
                   CHECK_BATCH * L))
    x = torch.randn((CHECK_BATCH, L, M), generator=gen, device=dev)
    ref = fwht_tile_reference(x, "bf16")
    top = float(ref.abs().max())
    h_m = float(fwht_kron(round_bf16(x), "highest", -1).abs().max())
    tile_err = float((slab_tile(x) - ref).abs().max())
    ints = torch.randint(-8, 9, (CHECK_BATCH, L, M), generator=gen,
                         device=dev).float()
    ri = fwht_tile_reference(ints, "bf16")
    ki = slab_tile(ints)
    tile = dict(normals=tile_err / top,
                ulp_limit=2.0 ** (math.floor(math.log2(h_m)) - 7) / top,
                integers=float((ki - ri).abs().max() / ri.abs().max()),
                integers_equal=bool(torch.equal(ki, ri)))
    del a, x, ref, ints, ri, ki
    # the decode's adjoint launch alone, from a compact z on the headline
    # support: normals to 1e-5 of the scale, integers bit for bit
    sup = hm.op.split_support(L, M, dev)
    adj, adj_err = {}, 0.0
    for kind in ("normal", "integer"):
        zc = (torch.randn((CHECK_BATCH, sup.ns), generator=gen, device=dev)
              if kind == "normal" else torch.randint(
                  -8, 9, (CHECK_BATCH, sup.ns), generator=gen,
                  device=dev).float())
        ref = slab_adjoint_reference(zc, sup)
        got = slab_adjoint(zc, sup)
        adj[kind] = (float((got - ref).abs().max() / ref.abs().max())
                     if kind == "normal" else bool(torch.equal(got, ref)))
        adj_err = max(adj_err, float((got - ref).abs().max()))
    del zc, ref, got
    # the concat configuration at B=32: tol, tol with pins, SE schedule
    sm = cp["model"].sparc
    T = sm.cfg.amp_iters
    a, idx, gen = draw(sm, OPTION_BATCH, 19)
    rows = torch.rand((OPTION_BATCH, sm.cfg.L), generator=gen,
                      device=dev) < 0.4
    pin = torch.where(rows, idx, -1).to(torch.int32)
    tr = se_trajectory(sm.p_alloc, sm.cfg.n, sm.cfg.M,
                       SCHED_MARGIN * sm.sigma2, T=T)
    sched = torch.as_tensor(np.pad(tr[1:], (0, max(0, T - len(tr) + 1)),
                                   mode="edge")[:T], dtype=torch.float32,
                            device=dev)
    groups.append((option_runs(a + (T,), {
        "concat tol": dict(slab, tol=1e-4),
        "concat tol+pin": dict(slab, tol=1e-4, pin_idx=pin),
        "concat schedule": dict(slab, tau2_schedule=sched)}, idx, T),
        OPTION_BATCH * sm.cfg.L))
    del a
    # the fast_l4096 shape (a cluster of four column blocks a strip)
    fm = lp["model"]
    a, idx, _ = draw(fm, L4096_BATCH, 20)
    groups.append((option_runs(a + (L4096_T,), {
        "L=4096 fixed T": slab, "L=4096 tol": dict(slab, tol=1e-4)}, idx,
        L4096_T), L4096_BATCH * fm.cfg.L))
    del a
    # L = M = 64: one slab, one column block (f_a = m_a = 1)
    small = SparcModel.build(slt.SparcConfig(
        L=64, M=64, R=1.0, power_alloc="iterative", op_kind="hadamard",
        amp_kernel="fused_slab", transform_precision="bf16", amp_iters=16,
        amp_tol=0.0), 6.0, dev)
    a, idx, _ = draw(small, OPTION_BATCH, 21)
    groups.append((option_runs(a + (16,), {
        "L=M=64 fixed T": slab, "L=M=64 tol": dict(slab, tol=1e-4)}, idx,
        16), OPTION_BATCH * 64))
    res = {k: r for g, _ in groups for k, r in g.items()}
    print(f"[24 slab kernel (K7) vs plain] bf16; transform alone at B="
          f"{CHECK_BATCH} L={L} M={M}, errors over max |plain|: {tile}; the "
          f"adjoint launch from the compact z (ns={sup.ns}): max err "
          f"{adj_err:.3e}, normals {adj['normal']:.3e} of max |out|, "
          f"integers bit for bit: {adj['integer']}; decodes: {res} "
          f"({clock.lap():.1f} s)", flush=True)
    for g, sections in groups:
        check_options(g, sections)
    require(res["concat tol"]["iters_min"] < OPTION_T,
            "concat tol: no early stop")
    require(tile["integers_equal"] and tile["integers"] <= 1e-5,
            f"K7 transform on integers: {tile}")
    require(tile["normals"] <= tile["ulp_limit"],
            f"K7 transform on normals: {tile}")
    require(adj["normal"] <= 1e-5, f"K7 adjoint err {adj['normal']}")
    require(adj["integer"], "K7 adjoint: integer inputs differ")
    return dict(tile_err=tile_err, adj_err=adj_err, res=res)


def slab_path(dev, card: str, sp: dict, mp: dict, clock: Clock) -> dict:
    """Phase 25: the slab main path (the headline configuration with
    amp_kernel="fused_slab")."""
    import dataclasses

    import torch

    from sparc_ldpc_tpu_torch.models.amp import decision_flips
    from sparc_ldpc_tpu_torch.ops.amp_kernel import (
        amp_fused, amp_fused_reference)
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    torch.cuda.empty_cache()
    hm = sp["model"]
    model = dataclasses.replace(hm, cfg=hm.cfg.replace(
        amp_kernel="fused_slab"))
    c = model.cfg
    T, L, M, n = c.amp_iters, c.L, c.M, c.n
    require(model.fused_kw["fused_form"] == "slab" and model.enc_in_kernel
            and not model.noise_in_kernel,
            "amp_kernel='fused_slab' must reach the slab form with the "
            "encode in the kernel and the noise drawn outside")
    se_fp = sp["se_fp"]
    reset_counts()
    out = model.run_block(block_generator(SEED, 22, 0, dev), BATCH)
    launches = read_counts()
    cnt = {k: v.item() for k, v in out.items()}
    cnt2 = {k: v.item() for k, v in model.run_block(
        block_generator(SEED, 22, 0, dev), BATCH).items()}
    tau_gap = cnt["tau2_final"] / se_fp - 1.0
    times = []
    for r in range(REPS):
        gen = block_generator(SEED, 22, 1 + r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = int(model.run_block(gen, BATCH)["bit_errors"])
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    bits_per_s = BATCH * c.k_bits / dt
    gen = block_generator(SEED, 22, 9, dev)
    bits = torch.randint(0, 2, (BATCH, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    noise = torch.randn((BATCH, n), generator=gen, device=dev)
    y_n = model.op.embed_y(noise * math.sqrt(model.sigma2)).reshape(
        BATCH, L, M)
    idx = bits_to_indices(bits, c.logM)
    del bits, noise
    args = (y_n, model.op.mask.reshape(L, M), model.sq_npl, c.P, n, T)
    sup = model.op.split_support(L, M, dev)
    kw = dict(encode_idx=idx, form="slab", support=sup)
    kernel_ms, kout = timed_result(lambda: amp_fused(*args, **kw), REPS)
    # each launch's device ms beside the bytes K7's design moves in it
    per = launch_ms(lambda: amp_fused(*args, **kw),
                    dict(zip(SLAB_STAGES_K7, (1, T, T, T))))
    db = slab_design_bytes(kout[2], L, M, sup.ns, T)
    stages = {k: round(sum(v), 3) for k, v in per.items()}
    by_launch = {k: dict(ms=[round(x, 3) for x in per[k]],
                         tb_per_s=[round(b / t / 1e9, 3)
                                   for b, t in zip(db[k], per[k])])
                 for k in SLAB_STAGES_K7}
    plain_ms, pout = timed_result(
        lambda: amp_fused_reference(*args, encode_idx=idx, form="slab"), 1)
    slab_b = amp_bound(BATCH, L, M, T, kout[2], noise_drawn=False)
    # the timed calls' results, held to phase 24's rules at this shape
    res25 = {"main path": compare_runs("main path", kout, pout, args,
                                       dict(form="slab"), idx, T)}
    del pout
    # the same draws through K1 (the noise as input)
    k1_ms, k1out = timed_result(
        lambda: amp_fused(*args, encode_idx=idx, split=True,
                          support=model.op.split_support(L, M, dev)), REPS)
    flips, decisive = decision_flips(kout[0], k1out[0])
    tau_k7, tau_k1 = (float(o[1][-1].mean()) for o in (kout, k1out))
    vs_k1 = dict(flips=flips, decisive=decisive,
                 tau2_rel_diff=abs(tau_k7 / tau_k1 - 1.0))
    del y_n, args, kout, k1out
    print(f"[25 slab main path] run_block B={BATCH}: launches {launches}; "
          f"counters {cnt}; tau2_final vs SE fixed point {se_fp:.4f}: "
          f"{100 * tau_gap:+.2f} %; same seed again: "
          f"{'identical' if cnt2 == cnt else cnt2}; {bits_per_s:.1f} bits/s "
          f"({1e3 * dt:.2f} ms per block, median of "
          f"{[round(1e3 * t, 2) for t in times]} ms) against phase 5's "
          f"{sp['bits_per_s']:.1f} ({sp['block_ms']:.2f} ms, K1, noise in "
          f"the kernel) and phase 15's {mp['bits_per_s']:.1f} "
          f"({mp['block_ms']:.2f} ms, K6); decode call at B={BATCH}: K7 "
          f"{kernel_ms:.2f} ms, plain {plain_ms:.2f} ms, bound {slab_b}, K1 "
          f"on the same draws {k1_ms:.2f} ms; one call's device ms by launch "
          f"kind (torch.profiler): {stages}, by launch with the TB/s of its "
          f"design bytes: {by_launch}; design bytes {db['total'] / 1e9:.3f} "
          f"GB, over 3.35 TB/s {db['floor_ms']:.3f} ms; the timed calls, "
          f"kernel vs plain: {res25}; K7 vs K1 on the same draws: {vs_k1} on "
          f"{card} ({clock.lap():.1f} s)", flush=True)
    check_options(res25, BATCH * L)
    require(launches["amp_slab"] > 0, "the slab path did not launch K7")
    require(launches["amp_split"] == 0 and launches["amp_mono"] == 0,
            "the slab path launched K1 or K6")
    require(cnt["trials"] == BATCH and cnt["iters_sum"] == BATCH * T,
            "trial or iteration count wrong")
    require(abs(tau_gap) <= 0.03, f"tau2_final off SE by {tau_gap:+.3%}")
    require(cnt2 == cnt, "same seed gave different counters")
    require(vs_k1["flips"] <= 0.01 * BATCH * L, "K7 and K1 differ in more "
            "than 1 % of the decisions")
    require(vs_k1["tau2_rel_diff"] <= 2e-2, "K7's and K1's tau2 differ")
    return dict(launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound=slab_b, block_ms=1e3 * dt, bits_per_s=bits_per_s,
                k1_ms=k1_ms, stages_ms=stages,
                design_floor_ms=db["floor_ms"])


def slab_concat_phase(dev, card: str, cp: dict, clock: Clock) -> dict:
    """Phase 26: a concat block with sparc.amp_kernel="fused_slab"."""
    import dataclasses

    import torch

    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    torch.cuda.empty_cache()
    cm0 = cp["model"]
    scfg = cm0.sparc.cfg.replace(amp_kernel="fused_slab")
    cm = dataclasses.replace(cm0, cfg=cm0.cfg.replace(sparc=scfg),
                             sparc=dataclasses.replace(cm0.sparc, cfg=scfg))
    require(cm.sparc.fused_kw["fused_form"] == "slab"
            and not cm.sparc.noise_in_kernel,
            "the slab concat block must reach the slab form, noise outside")
    T = scfg.amp_iters
    reset_counts()
    out = cm.run_block(block_generator(SEED, 23, 0, dev), BATCH)
    launches = read_counts()
    cnt = {k: v.item() for k, v in out.items()}
    fer = cnt["frame_errors"] / BATCH
    ber = cnt["bit_errors"] / (BATCH * cm.k_user)
    bp_ok = cnt["bp_ok"] / (BATCH * cm.num_cw)
    times = []
    for r in range(REPS):
        gen = block_generator(SEED, 23, 1 + r, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ = int(cm.run_block(gen, BATCH)["bit_errors"])
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    bits_per_s = BATCH * cm.k_user / dt
    print(f"[26 slab concat block] run_block B={BATCH}: launches {launches}; "
          f"counters {cnt}; FER {fer:.4f} (oracle {ORACLE_FER}), BER "
          f"{ber:.4e} (oracle {ORACLE_BER}), bp_ok {bp_ok:.4f} (reference "
          f"{REF_BP_OK}), mean AMP iterations {cnt['iters_sum'] / BATCH:.2f}"
          f" of {T}; {bits_per_s:.1f} user bits/s ({1e3 * dt:.2f} ms per "
          f"block, median of {[round(1e3 * t, 2) for t in times]} ms) "
          f"against phase 9's {cp['bits_per_s']:.1f} (K1) on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    require(launches["amp_slab"] == 2 and launches["bp_qc_layered"] == 1,
            "the slab concat block must launch K7 twice and K2 once")
    require(launches["amp_split"] == 0 and launches["amp_mono"] == 0,
            "the slab concat block launched K1 or K6")
    require(cnt["trials"] == BATCH, "trial count wrong")
    require(concat_windows(fer, ber, bp_ok) == [],
            f"slab concat quality off: {concat_windows(fer, ber, bp_ok)}")
    require(cnt["iters_sum"] < BATCH * T, "the early stop did not engage")
    return dict(launches=launches, block_ms=1e3 * dt, bits_per_s=bits_per_s)

# the experiment tools' sizes (scripts/kernel_ablation.py main): B, T
EXP_BATCH, EXP_T = 512, 32
EXP_ABLATED_T = 2     # the ablated variants' comparison: garbage decodes
# other operations an element and iteration besides the transforms, per
# variant (AMP_ELEM_OPS less what the variant drops: no_softmax the max,
# exp and two sums; no_max the max and its subtraction; no_norms |z|^2 and
# |beta|^2)
EXP_ELEM_OPS = {"no_softmax": 8, "no_max": 10, "no_norms": 10}


def exp_bound(mode: str, B: int, L: int, M: int, T: int) -> dict:
    """Bound of one experiment call (ops/amp_exp.py) at fixed T: y read
    once, the bf16 mask and sq once, beta and the trace written once;
    2 T - 1 transforms (the first forward one acts on beta = 0) at one
    float32 add an element and radix-2 stage, plus EXP_ELEM_OPS.  Every
    decoding variant (full, S3's, the pair) computes full's function, so
    it gets full's bound, the least over the ways to compute H_L (the
    butterflies); the ablated ones compute other functions, bounded by
    the stages they keep.  exp_dense_flops gives what S3's products
    compute."""
    from sparc_ldpc_tpu_torch.ops.amp_exp import ABLATED

    el, E = L * M, B * L * M
    nbytes = 8 * E + 2 * el + 4 * L + 4 * T * B
    n_tr = (2 * T - 1) * E
    if mode not in ABLATED:
        mode = "full"
    stages = {"no_transform": 0, "m_stage_only": math.log2(M)}
    f32 = n_tr * stages.get(mode, math.log2(el))
    f32 += T * E * EXP_ELEM_OPS.get(mode, AMP_ELEM_OPS)
    return bound(nbytes, {"fp32": f32})


def exp_dense_flops(mode: str, L: int) -> int:
    """bf16 tensor-core flops an element and transform that the S3 variant
    computes for its dense products (2 f a product by H_f: H_{f_b}, and
    H_{f_a} for slab_*, H_128 on the rows for l256_m128); 0 elsewhere."""
    from sparc_ldpc_tpu_torch.ops.amp_exp import S3_MODES, mode_f_b

    if mode not in S3_MODES:
        return 0
    f_b = mode_f_b(mode, L)
    extra = {"slab_loop": L // f_b, "slab_unroll": L // f_b,
             "slab_batched": L // f_b, "l256_m128": 128}
    return 2 * (f_b + extra.get(mode, 0))


def exp_compare(kout, pout, idx, decoding: bool) -> dict:
    """An experiment kernel's (beta, trace) against its plain version's.
    Decoding variants: flips (and decisive ones), section error rates and
    the tau2 trace's largest relative error.  Ablated ones: NaN positions
    equal, and the largest beta error where both are finite over the
    plain version's largest finite |beta|."""
    import torch

    from sparc_ldpc_tpu_torch.models.amp import decision_flips

    (bk, tk), (bp, tp) = kout, pout
    if decoding:
        require(bool(torch.isfinite(bk).all() & torch.isfinite(tk).all()),
                "kernel output is not finite")
        flips, decisive = decision_flips(bk, bp)
        return dict(flips=flips, decisive=decisive,
                    ser_kernel=float((bk.argmax(-1) != idx).float().mean()),
                    ser_plain=float((bp.argmax(-1) != idx).float().mean()),
                    tau2_rel_err=float(((tk - tp).abs() / tp).max()),
                    beta_abs_err=float((bk - bp).abs().max()))
    nan_k, nan_p = torch.isnan(bk), torch.isnan(bp)
    fin = ~(nan_k | nan_p)
    scale = float(bp[fin].abs().max()) if bool(fin.any()) else 1.0
    err = float((bk - bp)[fin].abs().max()) if bool(fin.any()) else 0.0
    return dict(nan_equal=bool(torch.equal(nan_k, nan_p)),
                nan_frac=float(nan_p.float().mean()),
                err_over_scale=err / max(scale, 1e-30))


def exp_plain(model, mode: str, y_n, T: int, prec: str = "bf16"):
    """The plain version of variant `mode` on y_n, T iterations: the pair
    and the bf16 ablated variants as the K1-style kernels compute them
    (order="kernel", ops/amp_exp.py: the pair's is full's,
    k1_form_reference), the rest where the scripts round."""
    from sparc_ldpc_tpu_torch.ops.amp_exp import (
        ABLATED, amp_exp_reference, mode_f_b)

    c = model.cfg
    order = ("kernel" if mode == "pair" or (mode in ABLATED
                                            and prec == "bf16")
             else "script")
    return amp_exp_reference(mode, y_n, model.op.mask.reshape(c.L, c.M),
                             model.sq_npl, c.P, c.n, T, mode_f_b(mode, c.L),
                             mode == "pair", prec, order)


def exp_hold(key: str, r: dict, sections: int, prec: str = "bf16") -> None:
    """An exp_compare result held to its contract: decoding variants at
    most 1 % flipped sections and the tau2 trace to rtol 2e-2 (1e-4 and
    no decisive flip in float32); ablated ones NaN positions equal and
    beta within 1e-2 of the output scale."""
    if "nan_equal" in r:
        require(r["nan_equal"], f"{key}: NaN positions differ")
        require(r["err_over_scale"] <= 1e-2,
                f"{key}: beta err {r['err_over_scale']} of scale")
        return
    require(r["flips"] <= 0.01 * sections, f"{key}: flips > 1 %")
    tol = 1e-4 if prec == "highest" else 2e-2
    require(r["tau2_rel_err"] <= tol,
            f"{key}: tau2 rel err {r['tau2_rel_err']}")
    if prec == "highest":
        require(r["decisive"] == 0, f"{key}: decisive flips")


class Experiment(NamedTuple):
    """One family of experiment kernels as the shared harness (exp_checks,
    exp_timing, exp_record) drives it: S1-S3 (ops/amp_exp.py, amp_family)
    or S4 (ops/amp_slab_exp.py, slab_family).  A variant is held in each
    of its forms: precisions for S1-S3, starts for S4."""
    model: object
    phase: int          # its draws: block_generator(SEED, phase, 0 | 1)
    batch: int          # the timed batch, the scripts'
    ablated: tuple      # the variants held at EXP_ABLATED_T
    forms: Callable     # (mode, timed) -> the forms it is held in
    decode: Callable    # (mode, y_n, T, form) -> the kernel's (beta, trace)
    plain: Callable     # (mode, y_n, T, form) -> the plain (beta, trace)
    compare: Callable   # (mode, kout, pout, idx) -> dict
    hold: Callable      # (key, r, sections, timed) -> None, or raises
    tool: Callable      # modes -> the tool's block records
    counts: Callable    # () -> kernel runs by variant
    reset: Callable     # () -> None: those counts set to 0
    bound: Callable     # mode -> its bound at (batch, EXP_T)
    extra: Callable     # mode -> more fields of its timed record


def amp_family(model, decodes: bool) -> Experiment:
    """S1-S3 (tools/kernel_ablation.py and its siblings): decoding variants
    in bf16, full and the pair in float32 too; ablated ones in float32 and
    in bf16; the timed calls in bf16.  decodes: the tool's blocks read
    back decisions (S1, S3) or not (S2)."""
    from sparc_ldpc_tpu_torch.ops.amp_exp import (
        ABLATED, amp_exp, reset_launches)
    from sparc_ldpc_tpu_torch.tools import kernel_ablation as ka

    c = model.cfg

    def forms(mode, timed):
        if timed:
            return ("bf16",)
        if mode in ABLATED or mode in ("full", "pair"):
            return ("highest", "bf16")
        return ("bf16",)

    return Experiment(
        model=model, phase=27, batch=EXP_BATCH, ablated=ABLATED, forms=forms,
        decode=lambda mode, y_n, T, prec: ka.decode(model, mode, y_n, T,
                                                    prec),
        plain=lambda mode, y_n, T, prec: exp_plain(model, mode, y_n, T,
                                                   prec),
        compare=lambda mode, kout, pout, idx: exp_compare(
            kout, pout, idx, mode not in ABLATED),
        hold=lambda key, r, sections, timed: exp_hold(key, r, sections,
                                                      key.split()[1]),
        tool=lambda modes: ka.run(model, modes, EXP_BATCH, EXP_T, decodes),
        counts=lambda: amp_exp.launches, reset=reset_launches,
        bound=lambda mode: exp_bound(mode, EXP_BATCH, c.L, c.M, EXP_T),
        extra=lambda mode: dict(
            dense_bf16_flops_per_element=exp_dense_flops(mode, c.L)))


def exp_checks(dev, ex: Experiment, modes, clock, label: str) -> dict:
    """Each variant's kernel against its plain version at B=CHECK_BATCH on
    the same draws, in each of its forms (ex.hold): decoding variants over
    EXP_T iterations, ablated ones over EXP_ABLATED_T."""
    from sparc_ldpc_tpu_torch.tools.kernel_ablation import draw_block
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    L, M = ex.model.cfg.L, ex.model.cfg.M
    y_n, idx = draw_block(ex.model, block_generator(SEED, ex.phase, 0, dev),
                          CHECK_BATCH)
    res = {}
    for mode in modes:
        T = EXP_ABLATED_T if mode in ex.ablated else EXP_T
        for form in ex.forms(mode, False):
            res[f"{mode} {form}"] = ex.compare(
                mode, ex.decode(mode, y_n, T, form),
                ex.plain(mode, y_n, T, form), idx)
    print(f"[{label} kernels vs plain] B={CHECK_BATCH} L={L} M={M}, T="
          f"{EXP_T} (ablated T={EXP_ABLATED_T}): {res} "
          f"({clock.lap():.1f} s)", flush=True)
    for key, r in res.items():
        ex.hold(key, r, CHECK_BATCH * L, False)
    return res


def exp_timing(dev, ex: Experiment, modes, label: str) -> dict:
    """The tool's blocks (the main path: counts set to 0 before, read
    after) and, per variant at B=ex.batch, the kernel's call at T=EXP_T by
    CUDA events and its bound; each decoding variant's call held to the
    plain version's (timed) on the same draws, each ablated one's at
    T=EXP_ABLATED_T in each of its timed forms (ex.hold)."""
    import torch

    from sparc_ldpc_tpu_torch.tools.kernel_ablation import draw_block
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    model, B = ex.model, ex.batch
    L, M = model.cfg.L, model.cfg.M
    torch.cuda.empty_cache()
    reset_counts()
    ex.reset()
    blocks = ex.tool(modes)
    torch.cuda.synchronize()
    launches = {m: ex.counts()[m] for m in modes}
    others = read_counts()
    require(all(v > 0 for v in launches.values()),
            f"phase {label}: a variant was never launched: {launches}")
    require(not any(others.values()),
            f"phase {label}: the experiments launched another kernel: "
            f"{others}")
    y_n, idx = draw_block(model, block_generator(SEED, ex.phase, 1, dev), B)
    calls, checks = {}, {}
    for mode in modes:
        form, *more = ex.forms(mode, True)
        ms, out = timed_result(lambda: ex.decode(mode, y_n, EXP_T, form),
                               REPS)
        rec = dict(ms=ms, **ex.bound(mode), **ex.extra(mode),
                   sec_err=int((out[0].argmax(-1) != idx).sum()),
                   tau2_final=float(out[1][EXP_T - 1].mean()))
        if mode in ex.ablated:
            del out
            for f in (form, *more):
                checks[f"{mode} {f}"] = ex.compare(
                    mode, ex.decode(mode, y_n, EXP_ABLATED_T, f),
                    ex.plain(mode, y_n, EXP_ABLATED_T, f), idx)
        else:
            # one call, no warm-up: the plain versions take seconds a call
            # (S4's over 4 s at B=1024)
            rec["plain_ms"], pout = timed_result(
                lambda: ex.plain(mode, y_n, EXP_T, form), 1, warm=False)
            checks[f"{mode} {form}"] = ex.compare(mode, out, pout, idx)
            del out, pout
        calls[mode] = rec
        torch.cuda.empty_cache()
    print(f"[{label} kernels vs plain] B={B} L={L} M={M}, T={EXP_T} "
          f"(ablated T={EXP_ABLATED_T}): {checks}", flush=True)
    for key, r in checks.items():
        ex.hold(f"{key} B={B}", r, B * L, True)
    return dict(blocks={b["mode"]: b for b in blocks}, calls=calls,
                launches=launches, y_n=y_n, idx=idx, checks=checks)


def exp_record(name: str, source: str, script: str, mode: str,
               checks: dict, tm: dict) -> dict:
    """The kernels line's record of one experiment: its headline variant's
    numbers, every variant's ms, bound, plain ms and launches beside them.
    max_abs_err is the largest beta error against the plain version in
    float32 where the experiment has a float32 form (over the output scale
    for the ablated variants), else in bf16 (where near-tie sections
    flip); the ablated variants' largest error over the scale beside it."""
    calls = tm["calls"]
    errs = [r.get("err_over_scale", r.get("beta_abs_err"))
            for k, r in checks.items() if k.endswith("highest")]
    errs = errs or [r["beta_abs_err"] for r in checks.values()
                    if "beta_abs_err" in r]
    ablated = [r["err_over_scale"] for r in checks.values()
               if "err_over_scale" in r]
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": script,
        "variant": mode, "launches": sum(tm["launches"].values()),
        "launches_by_variant": tm["launches"],
        "max_abs_err": max(errs),
        "ms": calls[mode]["ms"], "plain_ms": calls[mode]["plain_ms"],
        "bound_ms": calls[mode]["bound_ms"],
        "bound_by": calls[mode]["bound_by"], "library_ms": None,
        "ms_by_variant": {m: round(r["ms"], 3) for m, r in calls.items()},
        "bound_ms_by_variant": {m: round(r["bound_ms"], 3)
                                for m, r in calls.items()},
        "plain_ms_by_variant": {m: round(r["plain_ms"], 1)
                                for m, r in calls.items() if "plain_ms" in r}}
    if ablated:
        rec["max_err_over_scale_ablated"] = max(ablated)
    return rec


def exp_stages(calls: dict) -> dict:
    """Device ms of one call by launch kind for each of calls = {label:
    (fn, per_call)}, per_call the launches of each kernel name (a
    substring of it) in one fn() call.  One torch.profiler session after a
    warm-up call: each fn called twice in turn, and its second call's
    launches kept; the kernels of those names, in launch order, are split
    call by call, every launch of a call accounted for."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    names = {k for _, pc in calls.values() for k in pc}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            next(iter(calls.values()))[0]()
            torch.cuda.synchronize()
            prof.step()
            for fn, _ in calls.values():
                fn()
                fn()
            torch.cuda.synchronize()
            prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    events = sorted((e for e in events if e.get("cat") == "kernel"
                     and any(k in e.get("name", "") for k in names)),
                    key=lambda e: float(e["ts"]))
    out, pos = {}, 0
    for label, (_, per_call) in calls.items():
        n = sum(per_call.values())
        ms = dict.fromkeys(per_call, 0.0)
        count = dict.fromkeys(per_call, 0)
        for e in events[pos + n:pos + 2 * n]:
            key = next((k for k in per_call if k in e["name"]), None)
            require(key is not None, f"{label}: the trace has another "
                    f"call's kernel {e['name']} in its place")
            ms[key] += float(e.get("dur", 0.0)) / 1e3
            count[key] += 1
        require(count == per_call, f"{label}: the trace holds {count} "
                f"launches of a call, not {per_call}")
        out[label] = {k: round(v, 3) for k, v in ms.items()}
        pos += 2 * n
    require(pos == len(events), f"the trace holds {len(events)} launches, "
            f"not the calls' {pos}")
    return out


def ablation_phase(dev, card: str, model, clock: Clock) -> dict:
    """Phase 27: S2, the stage ablation (tools/kernel_ablation.py) on K1's
    own kernels, and K1's own fixed-T call beside its "full" variant: the
    same bits, and their ms."""
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_exp import S2_MODES
    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
    from sparc_ldpc_tpu_torch.tools.kernel_ablation import decode

    c = model.cfg
    L, M = c.L, c.M
    ex = amp_family(model, False)
    checks = exp_checks(dev, ex, S2_MODES, clock, "27 S2")
    tm = exp_timing(dev, ex, S2_MODES, "27")
    calls = tm["calls"]
    y_n = tm["y_n"]
    args = (y_n, model.op.mask.reshape(L, M), model.sq_npl, c.P, c.n, EXP_T)
    sup = model.op.split_support(L, M, dev)
    k1_ms, k1_out = timed_result(
        lambda: amp_fused(*args, split=True, support=sup), REPS)
    full_out = decode(model, "full", y_n, EXP_T)
    same = bool(torch.equal(full_out[0], k1_out[0])
                and torch.equal(full_out[1], k1_out[1]))
    del k1_out, full_out
    # device ms of each launch kind in a call (the second of two traced)
    per_call = dict(zip(K1_STAGES, (1, EXP_T, EXP_T)))
    stages = exp_stages({
        **{m: (functools.partial(decode, model, m, y_n, EXP_T), per_call)
           for m in S2_MODES},
        "K1": (lambda: amp_fused(*args, split=True, support=sup), per_call)})
    full = calls["full"]["ms"]
    se_fp = se_final(model, EXP_T)
    # full's time by stage: what each ablation saves, in ms and in % of
    # full's call, and by launch
    split = {f"full - {m}": (round(full - calls[m]["ms"], 3),
                             round(100 * (1 - calls[m]["ms"] / full), 2))
             for m in S2_MODES if m != "full"}
    split_by_launch = {
        f"full - {m}": {k: round(stages["full"][k] - stages[m][k], 3)
                        for k in K1_STAGES}
        for m in S2_MODES if m != "full"}
    print(f"[27 S2 stage ablation on K1's kernels] B={EXP_BATCH} T={EXP_T} "
          f"L={L} M={M}: launches {tm['launches']}; decode call ms (CUDA "
          f"events) { {m: round(r['ms'], 3) for m, r in calls.items()} }; "
          f"K1's own fixed-T call (amp_fused split, y given) {k1_ms:.3f} ms "
          f"beside full {full:.3f} ms ({100 * (full / k1_ms - 1):+.2f} %), "
          f"beta and trace bit for bit: {same}; device ms by launch "
          f"{stages}; full's stage split (ms, % of full's call) {split}, by "
          f"launch {split_by_launch}; plain full "
          f"{calls['full']['plain_ms']:.1f} ms; bounds "
          f"{ {m: round(r['bound_ms'], 3) for m, r in calls.items()} }; "
          f"full's sections in error {calls['full']['sec_err']} of "
          f"{EXP_BATCH * L}, mean final tau2 {calls['full']['tau2_final']:.4f}"
          f" (SE {se_fp:.4f}) on {card} ({clock.lap():.1f} s)", flush=True)
    require(same, "full's beta and trace differ from K1's call")
    require(abs(full / k1_ms - 1) <= 0.02,
            f"full's call {full:.3f} ms is not within 2 % of K1's "
            f"{k1_ms:.3f}")
    require(abs(calls["full"]["tau2_final"] / se_fp - 1) <= 0.03,
            "full: mean final tau2 off SE by more than 3 %")
    rec = exp_record("amp_ablation", K1_SOURCE,
                     "scripts/kernel_ablation.py:23", "full", checks, tm)
    rec["k1_ms"] = k1_ms
    rec["full_is_k1_bit_for_bit"] = same
    rec["stages_ms_by_variant"] = stages
    return dict(rec=rec, full_ms=full, sec_err=calls["full"]["sec_err"],
                k1_ms=k1_ms, k1_stages=stages["K1"])


def lstage_phase(dev, card: str, model, ab: dict, clock: Clock) -> dict:
    """Phase 28: S3, the H_L factorings (tools/lstage_exp.py), each
    column stage's ms a launch beside K1's (phase 27's call)."""
    from sparc_ldpc_tpu_torch.ops.amp_exp import S3_MODES
    from sparc_ldpc_tpu_torch.tools.kernel_ablation import decode

    L = model.cfg.L
    ex = amp_family(model, True)
    checks = exp_checks(dev, ex, S3_MODES, clock, "28 S3")
    tm = exp_timing(dev, ex, S3_MODES, "28")
    calls = tm["calls"]
    sec = {m: r["sec_err"] for m, r in calls.items()}
    stages = exp_stages({
        m: (functools.partial(decode, model, m, tm["y_n"], EXP_T),
            {"k1_encode_kernel": 1, "s3_col_kernel": EXP_T,
             ("s3_hm_row_kernel" if m == "l256_m128" else "k1_row_kernel"):
             EXP_T})
        for m in S3_MODES})
    col = {m: round(st["s3_col_kernel"] / EXP_T, 4)
           for m, st in stages.items()}
    k1_col = ab["k1_stages"]["k1_col_kernel"] / EXP_T
    print(f"[28 S3 H_L factorings] B={EXP_BATCH} T={EXP_T}: launches "
          f"{tm['launches']}; decode call ms "
          f"{ {m: round(r['ms'], 3) for m, r in calls.items()} } beside "
          f"full's {ab['full_ms']:.3f} (K1's call {ab['k1_ms']:.3f}); column "
          f"stage ms a launch {col} beside K1's {k1_col:.4f}; sections in "
          f"error {sec} (full: {ab['sec_err']}); final tau2 "
          f"{ {m: round(r['tau2_final'], 4) for m, r in calls.items()} }; "
          f"device ms by launch {stages}; plain ms "
          f"{ {m: round(r['plain_ms'], 1) for m, r in calls.items()} }; "
          f"bound (full's function) {calls['slab_loop']['bound_ms']:.3f} ms;"
          f" dense bf16 flops an element and transform "
          f"{ {m: r['dense_bf16_flops_per_element'] for m, r in calls.items()} }"
          f" on {card} ({clock.lap():.1f} s)", flush=True)
    for m, e in sec.items():
        require(abs(e - ab["sec_err"]) <= 0.01 * EXP_BATCH * L,
                f"{m}: section errors {e} against full's {ab['sec_err']}")
    rec = exp_record("amp_lstage", AMP_EXP_SOURCE, "scripts/lstage_exp.py:34",
                     "slab_loop", checks, tm)
    rec["dense_bf16_flops_per_element_by_variant"] = {
        m: r["dense_bf16_flops_per_element"] for m, r in calls.items()}
    rec["col_ms_per_launch_by_variant"] = col
    rec["k1_col_ms_per_launch"] = k1_col
    return dict(rec=rec)


def pair_phase(dev, card: str, model, ab: dict, clock: Clock) -> dict:
    """Phase 29: S1, two codewords per row-stage block
    (tools/pair_kernel_exp.py) on K1's kernels, beside K1's own fixed-T
    call on the same draws: the same bits, their ms and the row stage's
    ms a launch."""
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
    from sparc_ldpc_tpu_torch.tools.kernel_ablation import decode

    c = model.cfg
    L, M = c.L, c.M
    modes = ("pair",)
    ex = amp_family(model, True)
    checks = exp_checks(dev, ex, modes, clock, "29 S1")
    tm = exp_timing(dev, ex, modes, "29")
    r = tm["calls"]["pair"]
    y_n = tm["y_n"]
    args = (y_n, model.op.mask.reshape(L, M), model.sq_npl, c.P, c.n, EXP_T)
    sup = model.op.split_support(L, M, dev)
    k1_ms, k1_out = timed_result(
        lambda: amp_fused(*args, split=True, support=sup), REPS)
    pair_out = decode(model, "pair", y_n, EXP_T)
    same = bool(torch.equal(pair_out[0], k1_out[0])
                and torch.equal(pair_out[1], k1_out[1][:, 0::2]))
    del k1_out, pair_out
    per_call = dict(zip(K1_STAGES, (1, EXP_T, EXP_T)))
    stages = exp_stages({
        "pair": (lambda: decode(model, "pair", y_n, EXP_T), per_call),
        "K1": (lambda: amp_fused(*args, split=True, support=sup), per_call)})
    row = {k: round(v["k1_row_kernel"] / EXP_T, 4) for k, v in stages.items()}
    print(f"[29 S1 pair on K1's kernels] B={EXP_BATCH} T={EXP_T}: launches "
          f"{tm['launches']}; decode call {r['ms']:.3f} ms beside K1's own "
          f"fixed-T call {k1_ms:.3f} ms ({100 * (r['ms'] / k1_ms - 1):+.2f} "
          f"%; phase 27's full {ab['full_ms']:.3f}), beta and trace (the "
          f"first codeword of each pair) bit for bit: {same}; row stage ms a "
          f"launch {row}; device ms by launch {stages}; sections in error "
          f"{r['sec_err']} (full: {ab['sec_err']}); plain "
          f"{r['plain_ms']:.1f} ms; bound {r['bound_ms']:.3f} on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    require(same, "the pair's beta and trace differ from K1's call")
    require(abs(r["sec_err"] - ab["sec_err"]) <= 0.01 * EXP_BATCH * L,
            "pair: section errors off full's")
    rec = exp_record("amp_pair", K1_SOURCE, "scripts/pair_kernel_exp.py:28",
                     "pair", checks, tm)
    rec["k1_ms"] = k1_ms
    rec["pair_is_k1_bit_for_bit"] = same
    rec["row_ms_per_launch"] = row
    rec["stages_ms"] = stages
    return dict(rec=rec)


# the slab ablation's timed batch (scripts/slab_ablation.py main; T is
# EXP_T, the script's 32 too)
SLAB_EXP_BATCH = 1024
# other operations an element and iteration besides the transforms, per
# S4 variant (AMP_ELEM_OPS less what it drops: no_softmax the max, exp and
# two sums; no_consume those and the residual's mask multiply, subtract
# and Onsager term; sched and fold_sched |z|^2)
SLAB_ELEM_OPS = {"no_softmax": 8, "no_consume": 5, "sched": 10,
                 "fold_sched": 10}
AMP_EXP_SOURCE = "sparc_ldpc_tpu_torch/csrc/amp_exp.cu"
# S2's kernels: K1's own, at compile-time variants
K1_SOURCE = "sparc_ldpc_tpu_torch/csrc/amp_k1.cuh"
SLAB_EXP_SOURCE = "sparc_ldpc_tpu_torch/csrc/amp_slab_exp.cu"


def slab_exp_bound(mode: str, B: int, L: int, M: int, T: int) -> dict:
    """Bound of one S4 call (ops/amp_slab_exp.py) at fixed T: y read once,
    the mask and sq once, beta and the trace written once; T - 1 forward
    transforms (the first acts on beta = 0) and T adjoints at one float32
    add an element and radix-2 stage, plus SLAB_ELEM_OPS.  Decoding
    variants compute full's function and get full's bound; no_radix keeps
    the stages of the 128-wide factors (log2 f_b + log2 m_b), no_mm those
    of the radix factors (log2 f_a + log2 m_a), and both the adjoint's
    whole H_M (log2 M: K7's closed form, which they keep); the compact
    variants are bounded by the rows they produce: per codeword and
    iteration H_M of every row, the slab sum, H_{f_b} of one slab each way,
    H_M of the csub rows, and AMP_ELEM_OPS an element."""
    from sparc_ldpc_tpu_torch.ops.amp_slab_exp import parse_mode

    el, E = L * M, B * L * M
    nbytes = 8 * E + 2 * el + 4 * L + 4 * T * B
    v = parse_mode(mode, L, M, 1)
    if v.base == "compact":
        per = (el * math.log2(M) + el + 2 * v.f_b * M * math.log2(v.f_b)
               + v.csub * M * math.log2(M) + el * AMP_ELEM_OPS)
        return bound(nbytes, {"fp32": B * T * per})
    fwd = adj = math.log2(el)
    if mode in ("no_radix", "no_mm"):
        f = v.f_b if mode == "no_radix" else L // v.f_b
        fwd = math.log2(f) + math.log2(v.m_b if mode == "no_radix"
                                       else M // v.m_b)
        adj = math.log2(f) + math.log2(M)
    f32 = (T - 1) * E * fwd + T * E * adj
    f32 += T * E * SLAB_ELEM_OPS.get(mode, AMP_ELEM_OPS)
    return bound(nbytes, {"fp32": f32})


def slab_compare(mode: str, kout, pout, idx) -> dict:
    """exp_compare for an S4 variant; no_trace's traces must both be zero
    (its decode is then compared as any decoding variant's).  An ablated
    variant's result adds the count of elements off by more than 1e-2 of
    the output scale (where both are finite) and the element count."""
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_slab_exp import DECODING

    if mode == "no_trace":
        require(not bool(kout[1].any()) and not bool(pout[1].any()),
                "no_trace stored a trace")
        one = torch.ones_like(kout[1])
        kout, pout = (kout[0], one), (pout[0], one)
    r = exp_compare(kout, pout, idx, mode in DECODING)
    if mode not in DECODING:
        bk, bp = kout[0], pout[0]
        fin = ~(torch.isnan(bk) | torch.isnan(bp))
        if bool(fin.any()):
            scale = float(bp[fin].abs().max())
            r["n_over"] = int(((bk - bp).abs() > 1e-2 * scale)[fin].sum())
        else:
            r["n_over"] = 0
        r["numel"] = bk.numel()
    return r


def slab_hold(key: str, r: dict, sections: int, timed: bool) -> None:
    """A slab_compare result held to its contract (exp_hold).  An ablated
    variant is held only where it has values: NaN anywhere fails it, but
    for no_consume from beta' = 0, which must be NaN throughout on both
    sides (the script's function: its first tau2 is 0)."""
    mode, form = key.split()[:2]
    if "n_over" in r:
        require(r["nan_equal"], f"{key}: NaN positions differ")
        if (mode, form) == ("no_consume", "cold"):
            require(r["nan_frac"] == 1.0,
                    f"{key}: finite where the script's function is NaN")
            return
        require(r["nan_frac"] == 0.0, f"{key}: NaN in {r['nan_frac']} of "
                f"beta, nothing to hold there")
    exp_hold(key, r, sections)


def slab_family(model) -> Experiment:
    """S4 (tools/slab_ablation.py), each variant held to its kernels' plain
    version (K7's form, order="kernel"): every variant from beta = 0
    ("cold"), the script's start, and no_consume also from the state one
    plain full iteration leaves ("warm"): from beta = 0 its function is
    NaN throughout, which holds its arithmetic to nothing."""
    from sparc_ldpc_tpu_torch.ops.amp_slab_exp import (
        ABLATED, amp_slab_exp, amp_slab_exp_reference, reset_launches)
    from sparc_ldpc_tpu_torch.tools import slab_ablation as sa

    c = model.cfg
    masks, sups = {}, {}

    def args(mode, y_n, form):
        if mode not in masks:
            masks[mode] = sa.variant_mask(model, mode)
            sups[mode] = sa.variant_support(model, mode, masks[mode])
        state = None
        if form == "warm":
            state = amp_slab_exp_reference(
                "full", y_n, masks[mode], model.sq_npl, c.P, c.n, 1,
                keep_state=True, order="kernel")[2]
        return (mode, y_n, masks[mode], model.sq_npl, c.P, c.n), state

    def decode(mode, y_n, T, form):
        a, state = args(mode, y_n, form)
        return amp_slab_exp(*a, T, state=state, support=sups[mode])

    def plain(mode, y_n, T, form):
        a, state = args(mode, y_n, form)
        return amp_slab_exp_reference(*a, T, state=state, order="kernel")

    return Experiment(
        model=model, phase=30, batch=SLAB_EXP_BATCH, ablated=ABLATED,
        forms=lambda mode, timed: (("cold", "warm") if mode == "no_consume"
                                   else ("cold",)),
        decode=decode, plain=plain, compare=slab_compare, hold=slab_hold,
        tool=lambda modes: sa.run(model, modes, SLAB_EXP_BATCH, EXP_T, REPS),
        counts=lambda: amp_slab_exp.launches, reset=reset_launches,
        bound=lambda mode: slab_exp_bound(mode, SLAB_EXP_BATCH, model.cfg.L,
                                          model.cfg.M, EXP_T),
        extra=lambda mode: {})


def pair_vs_full(ex: Experiment, y_n) -> dict:
    """The pair's kernels against full's over EXP_T iterations on y_n
    (their plain versions are bit-identical; per codeword the paired R2C2
    and R3 do K7's arithmetic, so the two must agree too): per part of the
    kept state and for full's trace of the first codeword of each pair,
    how many elements differ."""
    from sparc_ldpc_tpu_torch.ops.amp_slab_exp import SlabState, amp_slab_exp

    model = ex.model
    c = model.cfg
    args = (y_n, model.op.mask.reshape(c.L, c.M), model.sq_npl, c.P, c.n,
            EXP_T)
    sup = model.op.split_support(c.L, c.M, y_n.device)
    _, tf, sf = amp_slab_exp("full", *args, keep_state=True, support=sup)
    _, tp, sp = amp_slab_exp("pair", *args, keep_state=True, support=sup)
    out = {name: int((getattr(sf, name) != getattr(sp, name)).sum())
           for name in SlabState._fields}
    out["trace"] = int((tf[:, 0::2] != tp).sum())
    return out


def slab_report(label: str, title: str, tm: dict, stages: dict,
                full: dict, card: str) -> str:
    """The head of an S4 phase's line: launches, the tool's blocks, each
    variant's call and device ms by launch beside full's, plain ms,
    bounds, section errors and final tau2."""
    calls, blocks = tm["calls"], tm["blocks"]
    return (f"[{label} {title}] B={SLAB_EXP_BATCH} T={EXP_T}: launches "
            f"{tm['launches']}; tool ms/block "
            f"{ {m: round(b['ms'], 2) for m, b in blocks.items()} }; "
            f"us/iter/cw "
            f"{ {m: round(b['us_per_iter_cw'], 3) for m, b in blocks.items()} }"
            f"; decode call ms (CUDA events) "
            f"{ {m: round(r['ms'], 3) for m, r in calls.items()} } beside "
            f"full's {full['ms']:.3f}; device ms by launch {stages}; plain ms "
            f"{ {m: round(r['plain_ms'], 1) for m, r in calls.items() if 'plain_ms' in r} }"
            f"; bound ms "
            f"{ {m: round(r['bound_ms'], 3) for m, r in calls.items()} }; "
            f"sections in error "
            f"{ {m: r['sec_err'] for m, r in calls.items()} } (full: "
            f"{full['sec_err']}), mean final tau2 "
            f"{ {m: round(r['tau2_final'], 4) for m, r in calls.items()} } on "
            f"{card}")


# K7's launches in one S4 call at EXP_T: the encode, then C1, R2C2 and R3
# an iteration
SLAB_PER_CALL = dict(zip(SLAB_STAGES_K7, (1, EXP_T, EXP_T, EXP_T)))


def slab_calls(ex: Experiment, tm: dict, modes) -> dict:
    """exp_stages's calls of `modes`' timed decodes (encode, C1, R2C2, R3
    by launch)."""
    return {m: (functools.partial(ex.decode, m, tm["y_n"], EXP_T, "cold"),
                SLAB_PER_CALL) for m in modes}


def stage_split(stages: dict, modes) -> dict:
    """full - variant by launch, in device ms a call."""
    return {f"full - {m}": {k: round(stages["full"][k] - stages[m][k], 3)
                            for k in SLAB_STAGES_K7}
            for m in modes if m != "full"}


def slab_ablation_phase(dev, card: str, model, clock: Clock) -> dict:
    """Phase 30: S4's make_kernel variants and factorings
    (tools/slab_ablation.py) on K7's own kernels, and K7's own fixed-T
    call beside its "full" variant: the same bits, and their ms."""
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
    from sparc_ldpc_tpu_torch.ops.amp_slab_exp import DECODING, MODES

    c = model.cfg
    L, M = c.L, c.M
    ex = slab_family(model)
    modes = tuple(m for m in MODES if not m.startswith("compact")
                  and m != "pair")
    checks = exp_checks(dev, ex, modes, clock, "30 S4")
    tm = exp_timing(dev, ex, modes, "30")
    calls = tm["calls"]
    full = calls["full"]
    y_n = tm["y_n"]
    args = (y_n, model.op.mask.reshape(L, M), model.sq_npl, c.P, c.n, EXP_T)
    sup = model.op.split_support(L, M, dev)
    k7_ms, k7_out = timed_result(
        lambda: amp_fused(*args, form="slab", support=sup), REPS)
    full_out = ex.decode("full", y_n, EXP_T, "cold")
    same = bool(torch.equal(full_out[0], k7_out[0])
                and torch.equal(full_out[1], k7_out[1]))
    del k7_out, full_out
    stages = exp_stages({
        **slab_calls(ex, tm, modes),
        "K7": (lambda: amp_fused(*args, form="slab", support=sup),
               SLAB_PER_CALL)})
    head = slab_report("30", "S4 slab stage ablation on K7's kernels", tm,
                       stages, full, card)
    se_fp = se_final(model, EXP_T)
    # full's time by stage: what each changed variant saves, in ms and in
    # % of full's call, and by launch
    split = {f"full - {m}": (round(full["ms"] - calls[m]["ms"], 3),
                             round(100 * (1 - calls[m]["ms"] / full["ms"]), 2))
             for m in modes if m != "full"}
    share = {k: round(100 * v / full["ms"], 1)
             for k, v in stages["full"].items()}
    print(f"{head}; full {full['ms']:.3f} ms a call, K7's own fixed-T "
          f"call (amp_fused slab, y given) {k7_ms:.3f} ms "
          f"({100 * (full['ms'] / k7_ms - 1):+.2f} %), beta and trace bit "
          f"for bit: {same}; full {full['ms'] / full['bound_ms']:.1f}x its "
          f"{full['bound_ms']:.3f} ms bound; by launch, % of the call "
          f"{share}; full - each variant (ms, % of full's call) {split}, by "
          f"launch {stage_split(stages, modes)}; full's mean final tau2 "
          f"{full['tau2_final']:.4f} (SE {se_fp:.4f}) ({clock.lap():.1f} s)",
          flush=True)
    require(same, "S4 full's beta and trace differ from K7's call")
    require(abs(full["ms"] / k7_ms - 1) <= 0.02,
            f"S4 full's call {full['ms']:.3f} ms is not within 2 % of K7's "
            f"{k7_ms:.3f}")
    require(abs(full["tau2_final"] / se_fp - 1) <= 0.03,
            "S4 full: mean final tau2 off SE by more than 3 %")
    for m in modes:
        if m in DECODING:
            require(abs(calls[m]["sec_err"] - full["sec_err"])
                    <= 0.01 * SLAB_EXP_BATCH * L,
                    f"{m}: section errors {calls[m]['sec_err']} against "
                    f"full's {full['sec_err']}")
    return dict(ex=ex, checks=checks, tm=tm, full=full, stages=stages,
                k7_ms=k7_ms, same=same)


def slab_layout_phase(dev, card: str, model, sa: dict, clock: Clock) -> dict:
    """Phase 31: S4's compact layouts and the pair, by launch beside
    full."""
    ex, full = sa["ex"], sa["full"]
    modes = ("compact", "compact32", "pair")
    checks = exp_checks(dev, ex, modes, clock, "31 S4")
    tm = exp_timing(dev, ex, modes, "31")
    stages = exp_stages(slab_calls(ex, tm, modes))
    stages["full"] = sa["stages"]["full"]
    head = slab_report("31", "S4 compact and pair on K7's kernels", tm,
                       stages, full, card)
    pf = pair_vs_full(ex, tm["y_n"])
    split = {f"full - {m}": (round(full["ms"] - tm["calls"][m]["ms"], 3),
                             round(100 * (1 - tm["calls"][m]["ms"]
                                          / full["ms"]), 2))
             for m in modes}
    print(f"{head}; full - each variant (ms, % of full's call) {split}, "
          f"by launch {stage_split(stages, modes)}; pair vs full kernels: "
          f"elements that differ {pf} ({clock.lap():.1f} s)", flush=True)
    require(not any(pf.values()), f"S4 pair: not full's bits: {pf}")
    pair = tm["calls"]["pair"]
    require(abs(pair["sec_err"] - full["sec_err"])
            <= 0.01 * SLAB_EXP_BATCH * model.cfg.L,
            "S4 pair: section errors off full's")
    return dict(checks=checks, tm=tm, pair_vs_full=pf, stages=stages)


def k1_design_bytes(iters, L: int, M: int, ns: int, T: int,
                    noise_drawn: bool, work_bytes: int = 2) -> dict:
    """The bytes K1's design moves in one call, by launch: the encode (the
    indices read; y_n read on the support unless the noise is drawn; y
    written on it), then per iteration t over the codewords still running
    it: the column stage (the work tile read unless t = 0 and written, y,
    z read and z written on the support (z not read at t = 0), the row
    |beta'|^2 partials read), the row stage (the work tile read, beta' read
    unless t = 0 and written, the work tile written unless it is the
    codeword's last iteration).  iters (B,) the iterations each codeword
    ran."""
    N = L * M
    it = iters.to("cpu").long()
    B = it.numel()
    enc = B * (4 * L + 4 * ns + (0 if noise_drawn else 4 * ns))
    col, row = [], []
    for t in range(T):
        active = int((it > t).sum())
        last = int((it == t + 1).sum())
        col.append(active * ((work_bytes * N if t else 0) + work_bytes * N
                             + (12 if t else 8) * ns + (4 * L if t else 0)))
        row.append(active * (work_bytes * N + (8 if t else 4) * N)
                   + (active - last) * work_bytes * N)
    total = enc + sum(col) + sum(row)
    return {"encode": enc, "col": col, "row": row, "total": total,
            "floor_ms": 1e3 * total / HBM_BYTES_PER_S}


def k1_stage_phase(dev, card: str, sp: dict, lp: dict,
                   clock: Clock) -> dict:
    """Phase 32: K1's encode, column and row launches, one by one, at the
    headline (B=2048, T=22, the main path's call with the noise drawn) and
    at fast_l4096 (B=512, T cap 32, tol 1e-4, the campaign's call), each
    beside the bytes its design moves."""
    import torch

    from sparc_ldpc_tpu_torch.ops.amp_kernel import amp_fused
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    out = {}
    for key, model, batch, stream in (("headline", sp["model"], BATCH, 30),
                                      ("l4096", lp["model"], FAST_BATCH, 31)):
        c = model.cfg
        L, M, n, T = c.L, c.M, c.n, c.amp_iters
        gen = block_generator(SEED, stream, 0, dev)
        bits = torch.randint(0, 2, (batch, c.k_bits), generator=gen,
                             dtype=torch.int32, device=dev)
        idx = bits_to_indices(bits, c.logM)
        seeds = model.draw_seeds(gen, batch)
        sup = model.op.split_support(L, M, dev)
        args = (None, model.op.mask.reshape(L, M), model.sq_npl, c.P, n, T)
        kw = dict(encode_idx=idx, noise_seed=seeds,
                  noise_sigma=math.sqrt(model.sigma2), split=True,
                  support=sup, tol=c.amp_tol)
        ms, res = timed_result(lambda: amp_fused(*args, **kw), REPS)
        per = launch_ms(lambda: amp_fused(*args, **kw),
                        dict(zip(K1_STAGES, (1, T, T))))
        enc, col, row = (per[k] for k in K1_STAGES)
        db = k1_design_bytes(res[2], L, M, sup.ns, T, noise_drawn=True)
        rate = {"encode": db["encode"] / enc[0] / 1e9,
                "col": [b / t / 1e9 for b, t in zip(db["col"], col)],
                "row": [b / t / 1e9 for b, t in zip(db["row"], row)]}
        out[key] = dict(
            ms=ms, design_bytes=db["total"], design_floor_ms=db["floor_ms"],
            stages_ms={"encode": enc[0], "col": sum(col), "row": sum(row),
                       "col_per_launch": col, "row_per_launch": row},
            tb_per_s=rate, iters_mean=float(res[2].float().mean()))
        print(f"[32 K1 by launch, {key}] B={batch} L={L} M={M} ns={sup.ns} "
              f"T={T} tol={c.amp_tol} (mean {out[key]['iters_mean']:.2f} "
              f"iterations): call {ms:.3f} ms (CUDA events), launches' sum "
              f"{enc[0] + sum(col) + sum(row):.3f} ms; encode {enc[0]:.3f} "
              f"ms ({rate['encode']:.3f} TB/s of design bytes); column "
              f"stage ms by launch {[round(x, 3) for x in col]} (TB/s "
              f"{[round(x, 3) for x in rate['col']]}); row stage ms by "
              f"launch {[round(x, 3) for x in row]} (TB/s "
              f"{[round(x, 3) for x in rate['row']]}); design bytes "
              f"{db['total'] / 1e9:.3f} GB, over 3.35 TB/s "
              f"{db['floor_ms']:.3f} ms on {card} ({clock.lap():.1f} s)",
              flush=True)
        del res
    return out


LEGS_TRIALS = 1024    # phase 33's trials a leg
# phase 33's legs: (preset, point index in the tool's GRIDS, kind), 2.0
# and 3.0 dB; the route legs are paired with K1 on the same frames
LEG_POINTS = (("plain_small", 0, "torch"), ("concat_small", 1, "torch"),
              ("plain_small", 0, "torch_mono"),
              ("plain_small", 0, "torch_slab"))
# the kernel each leg must launch besides K1 (the route legs' partner)
LEG_KERNELS = {"torch": "amp_split", "torch_mono": "amp_mono",
               "torch_slab": "amp_slab"}
OP_BATCH = 4          # phase 34's operator inputs
OP_BLOCK = 64         # phase 34's decoded block
OP_CPU_ROWS = 16      # the rows of it the CPU decodes too
OP_TOL = 1e-4         # card against CPU, of the output scale
OP_ADJ_TOL = 1e-6     # |<Ax, z> - <x, A^T z>| / (|Ax| |z|)
OP_TAU2_RTOL = 1e-3


def legs_phase(dev, card: str, clock: Clock) -> dict:
    """Phase 33: the BER/FER leg tool (tools/ber_legs.py) in process: a
    `torch` leg of plain_small at 2.0 dB and of concat_small at 3.0 dB,
    and torch_mono and torch_slab legs of plain_small at 2.0 dB paired
    with K1, LEGS_TRIALS each, into a temporary directory; each record
    well formed and its BER within the joint 95 % bound of the float64
    oracle leg on disk, floored as the tool's test floors it (REL_FLOOR,
    default 1 %); a paired leg's mean per-frame d not wholly beyond 2 % of
    K1's bit errors a frame."""
    from sparc_ldpc_tpu_torch.tools import ber_legs as bl

    tmp = tempfile.mkdtemp(prefix="chip_smoke_legs_")
    out = {}
    try:
        for preset, point, kind in LEG_POINTS:
            ebno = bl.GRIDS[preset][point]
            name = f"{preset} {kind}"
            reset_counts()
            bl.run_legs([preset], [kind], LEGS_TRIALS, 512, dev, tmp,
                        ebnos=[ebno], commit="chip_smoke")
            launches = read_counts()
            recs = [r for r in bl.load_records(bl.out_path(tmp, preset))
                    if r["kind"] == kind]
            require(len(recs) == 1, f"{name}: {len(recs)} records")
            rec = recs[0]
            missing = {"kind", "ebno_db", "trials", "bit_errors",
                       "bit_errors_sq", "frame_errors", "k_bits", "ber",
                       "fer", "wall_s", "bits_per_s", "seed_base",
                       "allow_tf32", "device", "card", "commit",
                       "launches"} - set(rec)
            require(not missing, f"{name}: record lacks {missing}")
            require(rec["trials"] == LEGS_TRIALS and rec["ebno_db"] == ebno
                    and rec["allow_tf32"] is False and rec["card"] == card,
                    f"{name}: record {rec}")
            require(all(isinstance(rec[k], int) for k in
                        ("bit_errors", "frame_errors", "trials")),
                    f"{name}: counters are not integers")
            oracle = bl.last_leg(bl.load_records(bl.ref_path(bl.RESULTS,
                                                             preset)),
                                 "oracle", ebno)
            require(oracle is not None, f"{name}: no oracle leg on disk")
            cmp = bl.compare(rec, oracle, bl.REL_FLOOR.get(preset, 0.01))
            out[name] = dict(ebno_db=ebno, ber=rec["ber"], fer=rec["fer"],
                             oracle_ber=oracle["ber"], gap=cmp["gap"],
                             bound=cmp["bound"], wall_s=rec["wall_s"],
                             bits_per_s=rec["bits_per_s"],
                             launches=launches)
            require(launches["amp_split"] > 0,
                    f"{name}: the leg did not run K1")
            require(launches[LEG_KERNELS[kind]] > 0,
                    f"{name}: the leg did not run {LEG_KERNELS[kind]}")
            if preset in bl.CONCAT_PRESETS:
                require(launches["bp_qc_layered"] > 0,
                        f"{name}: the leg did not run K2")
            require(cmp["ok"], f"{name} @ {ebno} dB: BER {rec['ber']} "
                    f"off the oracle's {oracle['ber']} by {cmp['gap']} > "
                    f"{cmp['bound']}")
            if kind != "torch":
                pc = bl.paired_compare(rec)
                out[name]["paired"] = dict(
                    partner_ber=rec["paired"]["partner_bit_errors"]
                    / (rec["trials"] * rec["k_bits"]), **pc)
                require(pc["ok"], f"{name} @ {ebno} dB: mean d {pc['diff']}"
                        f" ± {pc['half']} a frame wholly beyond ±"
                        f"{pc['bound']} (2 % of K1's bit errors a frame)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[33 ber legs] {out} on {card} ({clock.lap():.1f} s)", flush=True)
    return out


def op_compare(op_k, op_c, gen, dev) -> dict:
    """An operator on the card against the same operator on the CPU:
    Ax and Ay of OP_BATCH seeded inputs (max error over the output's
    max), and the card's adjointness normalized by |Ax| |z|."""
    import torch

    beta = torch.randn((OP_BATCH, op_k.ML), generator=gen, device=dev)
    z = torch.randn((OP_BATCH, op_k.n), generator=gen, device=dev)
    res = {}
    for name, fk, fc, x in (("Ax", op_k.Ax, op_c.Ax, beta),
                            ("Ay", op_k.Ay, op_c.Ay, z)):
        want = fc(x.cpu())
        res[name] = float((fk(x).cpu() - want).abs().max()
                          / want.abs().max())
    Ab, Az = op_k.Ax(beta).double(), op_k.Ay(z).double()
    adj = ((Ab * z.double()).sum(-1) - (beta.double() * Az).sum(-1)).abs()
    res["adjoint"] = float((adj / (Ab.norm(dim=-1) * z.double().norm(dim=-1)))
                           .max())
    return res


def operators_phase(dev, card: str, clock: Clock) -> dict:
    """Phase 34: the column-signed Hadamard operator (PRESETS["pa_l1024"]
    with col_signs=True, on fwht_kron and with --pallas on K5) and the DCT
    operator at fast_l4096's geometry (L=4096, M=512, R=1.5, ML=2^21,
    cuFFT): Ax and Ay on the card against the CPU within OP_TOL of the
    scale, adjointness within OP_ADJ_TOL; then a block of OP_BLOCK at
    6.0 dB (col_signs, both routes, the same draws) and 7.0 dB (dct)
    decoded on the card (`decode`, and `run_block_from` for the
    counters, which must agree with the decode) and its first
    OP_CPU_ROWS rows, from the same draws, once on the CPU (their
    counters from that decode, as run_block_from counts them): on those
    rows no decisive flip, mean final tau2 within OP_TAU2_RTOL.  The
    --pallas block's launches are counted (K5 and K4 on its scan
    route)."""
    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.models.amp import decision_flips, hard_indices
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.ops.operators import make_operator
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
    from sparc_ldpc_tpu_torch.utils.rng import block_generator

    cpu = torch.device("cpu")
    signed = slt.PRESETS["pa_l1024"].replace(col_signs=True)
    cases = (("col_signs", signed, 6.0, (False, True)),
             ("dct", slt.PRESETS["fast_l4096"].replace(op_kind="dct"), 7.0,
              (False,)))
    out, launches = {}, None
    for i, (label, cfg, ebno, routes) in enumerate(cases):
        gen = block_generator(SEED, 34, i, dev)
        bits = torch.randint(0, 2, (OP_BLOCK, cfg.k_bits), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn((OP_BLOCK, cfg.n), generator=gen, device=dev)
        rows = slice(0, OP_CPU_ROWS)
        t0 = time.perf_counter()
        mc = SparcModel.build(cfg, ebno, cpu)
        rc = mc.decode(mc.encode(bits[rows].cpu())
                       + noise[rows].cpu() * math.sqrt(mc.sigma2))
        cpu_s = time.perf_counter() - t0
        idx = bits_to_indices(bits[rows].cpu(), cfg.logM)
        cpu_sections = int((hard_indices(rc.beta) != idx).sum())
        tc = float(rc.tau2_trace[-1].double().mean())
        for pallas in routes:
            name = label + (" --pallas" if pallas else "")
            mk = SparcModel.build(cfg, ebno, dev, use_pallas=pallas)
            require(mk.op.mask is None and not mk.enc_in_kernel
                    and not mk.noise_in_kernel,
                    f"{name}: must take the scan route, encode outside")
            res = op_compare(mk.op, make_operator(cfg, cpu,
                                                  use_pallas=pallas),
                             block_generator(SEED, 34, 10 + i, dev), dev)
            t0 = time.perf_counter()
            if pallas:
                reset_counts()
            ck = mk.run_block_from(bits, noise)
            if pallas:
                launches = read_counts()
            rk = mk.decode(mk.encode(bits) + noise * math.sqrt(mk.sigma2))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            card_s = time.perf_counter() - t0
            flips, decisive = decision_flips(rk.beta[rows], rc.beta)
            tk = float(rk.tau2_trace[-1][rows].double().mean())
            tb = float(rk.tau2_trace[-1].double().mean())
            bk = float(ck["tau2_final"])
            res.update(flips=flips, decisive=decisive, tau2=tk,
                       block_tau2=bk, tau2_block_decode=tb, tau2_cpu=tc,
                       iters=float(rk.iters[rows].float().mean()),
                       iters_cpu=float(rc.iters.float().mean()),
                       section_errors=int((hard_indices(rk.beta[rows]).cpu()
                                           != idx).sum()),
                       section_errors_cpu=cpu_sections,
                       block_section_errors=int(ck["section_errors"]),
                       block_section_errors_decode=int(
                           (hard_indices(rk.beta).cpu()
                            != bits_to_indices(bits.cpu(), cfg.logM)).sum()),
                       card_s=card_s, cpu_s=cpu_s)
            out[name] = res
            del mk, rk
            require(res["Ax"] <= OP_TOL and res["Ay"] <= OP_TOL,
                    f"{name}: card vs CPU {res}")
            require(res["adjoint"] <= OP_ADJ_TOL, f"{name}: adjoint {res}")
            require(decisive == 0, f"{name}: {decisive} decisive flips")
            require(abs(tk - tc) <= OP_TAU2_RTOL * abs(tc),
                    f"{name}: tau2 {tk} vs CPU {tc}")
            require(abs(bk - tb) <= OP_TAU2_RTOL * abs(tb)
                    and res["block_section_errors"]
                    == res["block_section_errors_decode"],
                    f"{name}: the block's counters {bk}, "
                    f"{res['block_section_errors']} vs its decode's {tb}, "
                    f"{res['block_section_errors_decode']}")
            require(abs(res["section_errors"] - cpu_sections) <= flips,
                    f"{name}: section errors {res['section_errors']} vs "
                    f"CPU {cpu_sections} with {flips} flips")
        del mc, rc, bits, noise
    require(launches["fwht2"] > 0 and launches["denoise"] > 0,
            f"the col_signs --pallas block did not run K5 and K4: "
            f"{launches}")
    require(launches["amp_split"] == 0, "the signed operator ran K1")
    print(f"[34 operators] {out}; --pallas launches {launches} on {card} "
          f"({clock.lap():.1f} s)", flush=True)
    return dict(res=out, launches=launches)


SECTION_PROC_BATCH = 32      # phase 35 on one card: gloo, through the host
SECTION_PROC_NCCL_BATCH = 512  # phase 35 on two cards or more: NCCL
SECTION_PROC_TIMEOUT_S = 400
SECTION_PROC_RATE_TOL = 0.10   # the record's bits/s against wall / blocks
SECTION_PROC_KEYS = ("bit_errors", "frame_errors", "trials", "bit_errors_sq",
                     "blocks", "exec_blocks", "mean_iters", "ber", "fer")


def section_processes_phase(dev, card: str, clock: Clock) -> dict:
    """Phase 35: fast_l4096's campaign with its section axis across two
    processes (the CLI under torch.distributed.run), against the same
    campaign in this process on a virtual (1 x 2) mesh."""
    import socket

    import torch

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.config import CampaignConfig
    from sparc_ldpc_tpu_torch.models.sparc import SparcSweep
    from sparc_ldpc_tpu_torch.parallel.campaign import run_campaign

    torch.cuda.empty_cache()
    nccl = torch.cuda.device_count() >= 2
    backend = "nccl" if nccl else "gloo"
    B = SECTION_PROC_NCCL_BATCH if nccl else SECTION_PROC_BATCH
    # the budget is met once two blocks are counted; the pipelined
    # dispatch has launched the third by then: three blocks, the last two
    # the steady ms a block (the first carries each process's warm-up,
    # seconds of it on one card, which the wall over three blocks dilutes)
    trials = 2 * B
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sections_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out = os.path.join(tmp, "sections.jsonl")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
               "--master_port", str(port), "-m", "sparc_ldpc_tpu_torch.cli",
               "campaign", "--distributed", "--section-shards", "2",
               "--dist-backend", backend, "--preset", "fast_l4096",
               "--ebno", str(FAST_EBNO_DB), "--batch", str(B),
               "--max-trials", str(trials), "--min-frame-errors", "1000000",
               "--out", out]
        env = dict(os.environ)
        if nccl:
            env["CUDA_VISIBLE_DEVICES"] = "0,1"     # one card a process
        t0 = time.perf_counter()
        proc = run_launcher(cmd, SECTION_PROC_TIMEOUT_S, cwd=root, env=env)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"the two-process sharded campaign "
                f"failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
        with open(out) as f:
            recs = [json.loads(x) for x in f if x.strip()]
        with open(out + ".journal") as f:
            journal = [x for x in f if x.strip()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = sorted((json.loads(line.split(" ", 1)[1])
                    for line in proc.stdout.splitlines()
                    if line.startswith("section_exchange ")),
                   key=lambda r: r["rank"])
    # the same campaign in this process on a virtual (1 x 2) mesh
    pol = virtual_policy(dev, 1, 2)
    sweep = SparcSweep(slt.PRESETS["fast_l4096"], device=dev, policy=pol)
    ccfg = CampaignConfig(ebno_grid_db=(FAST_EBNO_DB,), batch=B,
                          min_frame_errors=1_000_000, max_trials=trials,
                          base_seed=1234, section_shards=2)
    reset_counts()
    ref = run_campaign(sweep.model_for_point, ccfg, lambda m: m.cfg.k_bits,
                       policy=pol, verbose=False)[0]
    launches = read_counts()
    del sweep
    torch.cuda.empty_cache()
    require(len(recs) == 1, "more than one process wrote a record")
    rec = recs[-1]
    same = {k: rec[k] == ref[k] for k in SECTION_PROC_KEYS}
    # every exchange waits for the card, so the two-process blocks run one
    # after the other; the campaign times each block by its completion, so
    # its steady bits_per_s (the blocks after the first) gives one block's
    # time, which the point's wall over its blocks must confirm
    k_bits = slt.PRESETS["fast_l4096"].k_bits
    res = dict(
        backend=backend, batch=B, wall_s=wall, record_wall_s=rec["wall_s"],
        ms_a_block=1e3 * rec["wall_s"] / rec["blocks"],
        ms_a_block_from_bits_per_s=1e3 * B * k_bits / rec["bits_per_s"],
        ms_a_block_one_process=1e3 * ref["wall_s"] / ref["blocks"],
        exchange_share=[r["s"] / rec["wall_s"] for r in ranks],
        ranks=ranks, launches_one_process=launches,
        counters={k: rec[k] for k in SECTION_PROC_KEYS})
    print(f"[35 section axis across 2 processes, {backend}] fast_l4096 B={B}"
          f", {trials} trials: record of processes {rec.get('processes')}, "
          f"section processes {rec.get('section_processes')}, mesh "
          f"{rec.get('mesh')}; counters {res['counters']} vs one process on "
          f"a virtual (1 x 2) mesh: equal {all(same.values())}; ranks "
          f"{ranks}; one process's launches {launches}; ms a block (the "
          f"point's wall over its blocks) {res['ms_a_block']}, from the "
          f"record's bits_per_s {rec['bits_per_s']} "
          f"{res['ms_a_block_from_bits_per_s']} (one process "
          f"{res['ms_a_block_one_process']}), exchange share of the wall "
          f"{res['exchange_share']}; the "
          f"launcher's wall {wall:.1f} s on {card} ({clock.lap():.1f} s)",
          flush=True)
    require(rec.get("processes") == 2 and rec.get("section_processes") == 2,
            f"the record is not two processes' with one section axis: {rec}")
    require(len(journal) == rec["exec_blocks"], "the journal was written "
            "by more than one process")
    require(all(same.values()), f"two-process sharded counters differ: "
            f"{same}")
    require(len(ranks) == 2, f"{len(ranks)} ranks reported their exchange")
    require(abs(res["ms_a_block_from_bits_per_s"] / res["ms_a_block"] - 1)
            <= SECTION_PROC_RATE_TOL,
            f"the record's bits_per_s gives "
            f"{res['ms_a_block_from_bits_per_s']} ms a block, the point's "
            f"wall over its blocks {res['ms_a_block']}")
    require(launches["fwht_tile"] > 0 and launches["denoise"] > 0
            and launches["amp_split"] == 0,
            f"the one-process campaign did not run K3 and K4: {launches}")
    for r in ranks:
        require(2 * r["fwht_tile"] == launches["fwht_tile"]
                and 2 * r["denoise"] == launches["denoise"],
                f"rank {r['rank']} launched K3 {r['fwht_tile']} and K4 "
                f"{r['denoise']} times, not half of {launches}")
        require(r["calls"] > 0, f"rank {r['rank']} exchanged nothing")
    return res


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
    cl, concat_rec = cli_phase(dev, card, cp, clock)
    mp = mono_path(dev, card, sp, clock)
    lp = l4096_path(dev, card, clock)
    fc = fast_cli_phase(card, clock)
    k3_rec = k3_phase(dev, card, clock)
    dp_phase(dev, card, sp, clock)
    sh = sharded_phase(dev, card, sp, clock)
    pc = policy_campaign_phase(dev, card, concat_rec, clock)
    distributed_phase(card, concat_rec, clock)
    if torch.cuda.device_count() > 1:
        multicard_phase(card, clock)
    else:
        print("[23 real meshes] one card visible: nothing to run", flush=True)
    k7 = slab_check_phase(dev, card, sp, cp, lp, clock)
    sl = slab_path(dev, card, sp, mp, clock)
    sc = slab_concat_phase(dev, card, cp, clock)
    ab = ablation_phase(dev, card, sp["model"], clock)
    ls = lstage_phase(dev, card, sp["model"], ab, clock)
    pr = pair_phase(dev, card, sp["model"], ab, clock)
    s4 = slab_ablation_phase(dev, card, sp["model"], clock)
    s4l = slab_layout_phase(dev, card, sp["model"], s4, clock)
    s4_tm = {k: {**s4["tm"][k], **s4l["tm"][k]} for k in ("calls",
                                                          "launches")}
    s4_rec = exp_record("slab_ablation", SLAB_EXP_SOURCE,
                        "scripts/slab_ablation.py:130", "full",
                        {**s4["checks"], **s4l["checks"]}, s4_tm)
    s4_rec["stages_ms_by_variant"] = {**s4["stages"], **s4l["stages"]}
    s4_rec["k7_ms"] = s4["k7_ms"]
    s4_rec["full_is_k7_bit_for_bit"] = s4["same"]
    k1s = k1_stage_phase(dev, card, sp, lp, clock)
    legs = legs_phase(dev, card, clock)
    ops = operators_phase(dev, card, clock)
    sx = section_processes_phase(dev, card, clock)

    require("jax" not in sys.modules, "jax was imported")
    ref = [k for k in sys.modules
           if k == "sparc_ldpc_tpu" or k.startswith("sparc_ldpc_tpu.")]
    require(not ref, f"the reference package was imported: {ref}")
    # the paths of the L=1024 records; phases 15 and 17 have their own
    paths = dict(sparc=sp["launches"], concat=cp["launches"], **cl,
                 col_signs_pallas=ops["launches"],
                 **{f"legs {p}": r["launches"] for p, r in legs.items()})

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
        "ms": sp["kernel_ms"], "plain_ms": sp["plain_ms"], **sp["bound"],
        "library_ms": None, "noise_ms": sp["noise_ms"],
        "stages_ms": k1s["headline"]["stages_ms"]}
    mono_rec = {
        "name": "amp_mono", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/amp_mono.cu",
        "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:561",
        "launches": mp["launches"]["amp_mono"],
        "max_abs_err": mp["adj_err"], "ms": mp["kernel_ms"],
        "plain_ms": mp["plain_ms"], **mp["bound"], "library_ms": None,
        "stages_ms": mp["stages_ms"]}
    l4096_rec = {
        "name": "amp_split_l4096", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/amp_split.cu",
        "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:366",
        "launches": fc["launches"]["amp_split"],
        "launches_by_path": {"noise": fc["launches"]["amp_split_noise"]},
        "max_abs_err": lp["max_abs_err"], "ms": lp["kernel_ms"],
        "plain_ms": lp["plain_ms"], **lp["bound"], "library_ms": None,
        "noise_ms": lp["noise_ms"],
        "stages_ms": k1s["l4096"]["stages_ms"]}
    slab_rec = {
        "name": "amp_slab", "route": "cuda",
        "source": "sparc_ldpc_tpu_torch/csrc/amp_slab.cu",
        "replaces": "sparc_ldpc_tpu/ops/amp_kernel.py:134",
        "launches": sl["launches"]["amp_slab"],
        "launches_by_path": {"concat": sc["launches"]["amp_slab"]},
        "max_abs_err": max(k7["tile_err"], k7["adj_err"]),
        "ms": sl["kernel_ms"], "plain_ms": sl["plain_ms"], **sl["bound"],
        "library_ms": None, "stages_ms": sl["stages_ms"]}
    # K3's main path: the section-sharded fast_l4096 campaign (phase 21)
    k3_rec["launches"] = pc["launches"]["fwht_tile"]
    k3_rec["launches_by_path"] = {
        f"decode S={S}": c["fwht_tile"] for S, c in sh["launches"].items()}
    # phase 35: each rank's launches of the two-process sharded campaign
    for rec, key in ((k3_rec, "fwht_tile"), (dn_rec, "denoise")):
        rec["launches_by_path"].update({
            f"section axis across processes, rank {r['rank']}": r[key]
            for r in sx["ranks"]})
        rec["section_axis_across_processes"] = {
            k: sx[k] for k in ("backend", "batch", "ms_a_block",
                               "ms_a_block_from_bits_per_s",
                               "exchange_share")}
    # phase 33's route legs
    for rec, key in ((mono_rec, "amp_mono"), (slab_rec, "amp_slab")):
        rec.setdefault("launches_by_path", {}).update({
            f"legs {p}": r["launches"][key] for p, r in legs.items()
            if r["launches"][key]})
    records = [amp_rec, bp_rec, fw_rec, dn_rec, mono_rec, l4096_rec, k3_rec,
               slab_rec, ab["rec"], ls["rec"], pr["rec"], s4_rec]
    for rec in records:
        require(rec["launches"] > 0, f"{rec['name']} was never launched")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
