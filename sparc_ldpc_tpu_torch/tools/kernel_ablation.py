#!/usr/bin/env python3
"""Stage ablation of the split fused AMP kernel (port of
scripts/kernel_ablation.py): where does the time of an iteration go?

    python -m sparc_ldpc_tpu_torch.tools.kernel_ablation [VARIANT ...]
        [--batch 512] [--iters 32] [--cpu]

Each variant replaces one stage of the decode with a near-free stand-in
(ops/amp_exp.py): "full" is the decode itself, "no_softmax",
"no_max", "no_transform", "m_stage_only" and "no_norms" are for timing
only (their decodes are garbage); on the card each is K1's own kernels
(csrc/amp_k1.cuh) with that stage dropped at compile time, "full" K1's
fixed-T decode itself.  The code is the scripts': L=1024,
M=512, R=1.0, iterative power at 2.0 dB, bf16 transforms, B=512
codewords, T=32 fixed iterations.  A block draws its bits and noise from
an explicit torch.Generator, encodes them with the port's SparcModel and
decodes with the variant; each variant's line gives the median of 5
blocks after a warm one (host clock around draws, decode and a scalar
readback, as the script times its jitted block): ms per block and us per
iteration and codeword.  On the card the variants are hand-written CUDA
kernels (csrc/amp_exp.cu) and the `nvidia-smi` name and power limit are
printed beside the numbers; with --cpu the plain versions run (slow at
these sizes; the tests run them small).  Without a GPU and without --cpu
it exits with an error.

`run(model, variants, B, T)` is the same for a model built elsewhere
(chip_smoke.py reuses its headline model); the S3 and S1 tools
(lstage_exp.py, pair_kernel_exp.py) use this module's helpers.
"""

from __future__ import annotations

import argparse
import math
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Sequence

import torch

from sparc_ldpc_tpu_torch.config import SparcConfig
from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_exp import S2_MODES, amp_exp
from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices
from sparc_ldpc_tpu_torch.utils.rng import block_generator

EBNO_DB = 2.0
BATCH, ITERS = 512, 32
REPS = 5
WARM_BLOCK = 999          # the scripts' warm-up key
SEED = 0


def script_config(T: int = ITERS, L: int = 1024, M: int = 512
                  ) -> SparcConfig:
    """The scripts' code: L=1024, M=512, R=1.0, iterative power, bf16
    transforms, T fixed iterations (no early stop)."""
    return SparcConfig(L=L, M=M, R=1.0, power_alloc="iterative",
                       op_kind="hadamard", amp_iters=T, amp_tol=0.0,
                       transform_precision="bf16")


def card_line() -> str:
    """The card's `nvidia-smi` name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def draw_block(model: SparcModel, gen: torch.Generator, B: int):
    """One block's draws: (y_n (B, L, M) the observation on the row
    support, true section indices (B, L)); bits, then noise, from gen."""
    c = model.cfg
    dev = model.device
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    x = model.encode(bits)
    noise = torch.randn((B, c.n), generator=gen, device=dev)
    y = x + noise * math.sqrt(model.sigma2)
    return (model.op.embed_y(y).reshape(B, c.L, c.M),
            bits_to_indices(bits, c.logM))


def decode(model: SparcModel, mode: str, y_n: torch.Tensor, T: int,
           precision: str = "bf16"):
    """Variant `mode` on y_n: (beta, trace (T, B or B / 2)); on the card
    with the operator's support tables (K1's, which S2 and S3 read y and z
    by), built once per device."""
    c = model.cfg
    sup = (model.op.split_support(c.L, c.M, y_n.device)
           if y_n.device.type == "cuda" else None)
    return amp_exp(mode, y_n, model.op.mask.reshape(c.L, c.M), model.sq_npl,
                   c.P, c.n, T, precision, sup)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_variant(model: SparcModel, mode: str, B: int, T: int,
                 reps: int = REPS) -> Dict:
    """Median host ms of `reps` blocks (draws, decode, a scalar readback)
    after a warm one, and the last block's section errors and mean final
    tau2."""
    dev = model.device

    def block(r: int):
        y_n, idx = draw_block(model, block_generator(SEED, 0, r, dev), B)
        beta, trace = decode(model, mode, y_n, T)
        sec_err = int((beta.argmax(-1) != idx).sum())
        return sec_err, float(trace[T - 1].mean())

    block(WARM_BLOCK)
    times = []
    for r in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        sec_err, tau2 = block(r)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return dict(mode=mode, ms=1e3 * med, us_per_iter_cw=1e6 * med / (B * T),
                ms_all=[1e3 * t for t in times], sec_err=sec_err,
                tau2_final=tau2, mbit_s=B * model.cfg.k_bits / med / 1e6)


def line(rec: Dict, decodes: bool) -> str:
    """The scripts' printed line for one variant."""
    s = (f"{rec['mode']:14s}: {rec['ms']:7.1f} ms/block "
         f"({rec['us_per_iter_cw']:5.2f} us/iter/cw)")
    if decodes:
        s += (f"  {rec['mbit_s']:6.2f} Mbit/s  sec_err={rec['sec_err']} "
              f"tau2={rec['tau2_final']:.4f}")
    return s


def run(model: SparcModel, variants: Sequence[str] = S2_MODES,
        B: int = BATCH, T: int = ITERS, decodes: bool = False,
        reps: int = REPS) -> List[Dict]:
    """Time each variant on `model` (its device: kernels on the card, the
    plain versions on the CPU) and print its line; returns the records."""
    recs = []
    for mode in variants:
        rec = time_variant(model, mode, B, T, reps)
        print(line(rec, decodes), flush=True)
        recs.append(rec)
    return recs


def main_for(doc: str, variants: Sequence[str], decodes: bool,
             argv=None) -> List[Dict]:
    """The command line of the three experiment tools."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(variants),
                    help=f"of {', '.join(variants)}")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    a = ap.parse_args(argv)
    bad = [v for v in a.variants if v not in variants]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {list(variants)}")
    if a.cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            sys.exit("no CUDA device is visible; pass --cpu for the plain "
                     "versions")
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"{torch.cuda.get_device_name(0)} | nvidia-smi: {card_line()}",
              flush=True)
    model = SparcModel.build(script_config(a.iters), EBNO_DB, dev)
    return run(model, a.variants, a.batch, a.iters, decodes)


def main(argv=None) -> List[Dict]:
    return main_for(__doc__, S2_MODES, decodes=False, argv=argv)


if __name__ == "__main__":
    main()
