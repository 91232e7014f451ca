#!/usr/bin/env python3
"""Stage ablation of the slab fused AMP kernel (port of
scripts/slab_ablation.py): where does the time of K7's iteration go?

    python -m sparc_ldpc_tpu_torch.tools.slab_ablation [VARIANT ...]
        [--batch 1024] [--iters 32] [--cpu]

Each variant is the slab kernel's decode with one stage removed or changed
(ops/amp_slab_exp.py; on the card K7's own kernels at a compile-time
variant, "full" K7's instantiation): "full" is the decode, "fold", "fold_hfb",
"no_trace", "exp2", "bf16_radix", "midbf16", the factorings "fXmY" and
"pair" compute the same function otherwise; "no_radix", "no_mm",
"no_softmax", "no_consume", "sched", "fold_sched", "compact" and
"compactNN" are for timing only (their decodes are garbage).  The default
list is the script's: full no_radix no_mm no_softmax no_consume
bf16_radix.  The code is the script's: L=1024, M=512, R=1.0, iterative
power at 2.0 dB, bf16 transforms, B=1024 codewords, T=32 fixed
iterations.  As the script does, a block decodes pure noise: y standard
normal (B, L, M), no codeword, drawn from an explicit torch.Generator
(the compact variants on the script's fabricated support,
`compact_mask`).  Each variant's line gives the median of 5 blocks after
a warm one (host clock around the draw, the decode and a scalar readback
of sum(beta^2), as the script times its jitted block): ms per block and
us per iteration and codeword, and the seconds the variant took in all.
On the card the variants are hand-written CUDA kernels
(csrc/amp_slab_exp.cu on csrc/amp_k7.cuh) and the `nvidia-smi` name and
power limit are printed beside the numbers; with --cpu the kernels' plain
versions run (K7's form, `amp_slab_exp_reference(order="kernel")`; slow
at these sizes, the tests run them small).  Without a GPU and without --cpu
it exits with an error.

`run(model, variants, B, T)` is the same for a model built elsewhere
(chip_smoke.py reuses its headline model).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List, Sequence

import torch

from sparc_ldpc_tpu_torch.models.sparc import SparcModel
from sparc_ldpc_tpu_torch.ops.amp_slab_exp import (
    DEFAULT_VARIANTS, amp_slab_exp, compact_mask, parse_mode)
from sparc_ldpc_tpu_torch.ops.split_support import (SplitSupport,
                                                    split_support_from_mask)
from sparc_ldpc_tpu_torch.tools.kernel_ablation import (
    EBNO_DB, REPS, SEED, WARM_BLOCK, _sync, card_line, script_config)
from sparc_ldpc_tpu_torch.utils.rng import block_generator

BATCH, ITERS = 1024, 32


def variant_mask(model: SparcModel, mode: str) -> torch.Tensor:
    """The mask the script hands variant `mode`: the model's 0/1 support,
    or for the compact variants the fabricated one."""
    c = model.cfg
    if parse_mode(mode, c.L, c.M, c.n).base == "compact":
        return compact_mask(c.L, c.M, c.n, model.device)
    return model.op.mask.reshape(c.L, c.M)


def variant_support(model: SparcModel, mode: str,
                    mask: torch.Tensor = None) -> SplitSupport:
    """The support tables the kernels read y and z by: the operator's
    (built once per device), or the compact variants' own; None on the
    CPU, whose plain versions do not read them."""
    c = model.cfg
    if model.device.type == "cpu":
        return None
    if parse_mode(mode, c.L, c.M, c.n).base == "compact":
        return split_support_from_mask(
            variant_mask(model, mode) if mask is None else mask)
    return model.op.split_support(c.L, c.M, model.device)


def decode(model: SparcModel, mode: str, y_n: torch.Tensor, T: int,
           mask: torch.Tensor = None, support: SplitSupport = None):
    """Variant `mode` on y_n: (beta, trace (T, B or B / 2))."""
    c = model.cfg
    if mask is None:
        mask = variant_mask(model, mode)
    if support is None:
        support = variant_support(model, mode, mask)
    return amp_slab_exp(mode, y_n, mask, model.sq_npl, c.P, c.n, T,
                        support=support)


def draw_noise(model: SparcModel, gen: torch.Generator, B: int
               ) -> torch.Tensor:
    """The script's draws: y standard normal (B, L, M), no codeword."""
    c = model.cfg
    return torch.randn((B, c.L, c.M), generator=gen, device=model.device)


def time_variant(model: SparcModel, mode: str, B: int, T: int,
                 reps: int = REPS) -> Dict:
    """Median host ms of `reps` blocks (draw, decode, a scalar readback)
    after a warm one."""
    dev = model.device
    mask = variant_mask(model, mode)
    support = variant_support(model, mode, mask)
    t_start = time.perf_counter()

    def block(r: int) -> float:
        y = draw_noise(model, block_generator(SEED, 0, r, dev), B)
        beta, _ = decode(model, mode, y, T, mask, support)
        return float((beta * beta).sum())

    block(WARM_BLOCK)
    times = []
    for r in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        block(r)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return dict(mode=mode, ms=1e3 * med, us_per_iter_cw=1e6 * med / (B * T),
                ms_all=[1e3 * t for t in times],
                seconds=time.perf_counter() - t_start)


def line(rec: Dict) -> str:
    """The script's printed line for one variant."""
    return (f"{rec['mode']:11s}: {rec['ms']:7.1f} ms/block  "
            f"{rec['us_per_iter_cw']:5.2f} us/iter/cw  "
            f"(compile+run {rec['seconds']:.0f}s)")


def run(model: SparcModel, variants: Sequence[str] = DEFAULT_VARIANTS,
        B: int = BATCH, T: int = ITERS, reps: int = REPS) -> List[Dict]:
    """Time each variant on `model` (its device: kernels on the card, the
    plain versions on the CPU) and print its line; returns the records."""
    recs = []
    for mode in variants:
        rec = time_variant(model, mode, B, T, reps)
        print(line(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(DEFAULT_VARIANTS),
                    help="modes of ops/amp_slab_exp.py (MODES on the card)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    a = ap.parse_args(argv)
    cfg = script_config(a.iters)
    for v in a.variants:
        try:
            parse_mode(v, cfg.L, cfg.M, cfg.n)
        except ValueError as e:
            ap.error(str(e))
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
    model = SparcModel.build(cfg, EBNO_DB, dev)
    return run(model, a.variants, a.batch, a.iters)


if __name__ == "__main__":
    main()
