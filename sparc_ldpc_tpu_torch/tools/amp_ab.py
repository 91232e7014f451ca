#!/usr/bin/env python3
"""Time the split AMP kernel's decode call of two or more source trees on
one GPU, interleaved, to tell a code change from drift of the card.

    python3 sparc_ldpc_tpu_torch/tools/amp_ab.py TREE [TREE ...] \
        [--out results.json]

Each TREE is a directory that holds a `sparc_ldpc_tpu_torch/` package (the
repository root, or an unpacked `git archive` of another commit); list the
trees in the order to run them, e.g. `old new new old`.  Each runs in a
process of its own, which builds that tree's kernels and times the
headline decode call: L=1024, M=512, T=22 fixed, B=2048, bf16, the split
form with the in-kernel encode, once with the noise as an input and once
drawn in the kernel (median of 5 calls each, CUDA events), and the device
ms per iteration of the column and row stages from one torch.profiler trace.
The inputs are synthetic (a random row support of n = 9216 of the L M
positions, flat power, sigma2 of 2.0 dB at R = 1): at fixed T the kernel's
work does not depend on the data.  Prints one JSON line per run, the card's
`nvidia-smi` name and power limit, and writes all of it to --out.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

L, M, T, B, N_ROWS = 1024, 512, 22, 2048, 9216
REPS = 5
STAGES = ("amp_encode_kernel", "amp_col_kernel", "amp_row_kernel")


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


def _stage_ms(fn) -> dict:
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
    us = dict.fromkeys(STAGES, 0.0)
    for e in events:
        if e.get("cat") == "kernel":
            for k in STAGES:
                if k in e.get("name", ""):
                    us[k] += float(e.get("dur", 0.0))
    return {k: us[k] / 1e3 for k in STAGES}


def worker(root: str) -> dict:
    """Time one tree's decode call (in this process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import inspect

    import torch

    from sparc_ldpc_tpu_torch.ops import _build
    from sparc_ldpc_tpu_torch.ops import amp_kernel as ak

    if not os.path.abspath(ak.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ak.__file__}, not from {root}")
    nvcc_s = _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = torch.zeros(L * M, device=dev)
    mask[torch.randperm(L * M, generator=gen, device=dev)[:N_ROWS]] = 1.0
    mask = mask.reshape(L, M)
    P = 1.0
    sigma = math.sqrt(P / (2.0 * 10 ** 0.2))
    sq = torch.full((L,), math.sqrt(N_ROWS * P / L), device=dev)
    y_n = torch.randn((B, L, M), generator=gen, device=dev) * sigma * mask
    idx = torch.randint(0, M, (B, L), generator=gen, device=dev,
                        dtype=torch.int32)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), generator=gen,
                          device=dev, dtype=torch.int32)
    # the split form at L = 1024: the default before the mono form existed
    form = ({"split": True}
            if "split" in inspect.signature(ak.amp_fused).parameters else {})

    def call(noise: bool):
        if noise:
            return ak.amp_fused(None, mask, sq, P, N_ROWS, T, encode_idx=idx,
                                noise_seed=seeds, noise_sigma=sigma, **form)
        return ak.amp_fused(y_n, mask, sq, P, N_ROWS, T, encode_idx=idx,
                            **form)

    out = dict(tree=root, nvcc_s=nvcc_s,
               ms=_events_ms(lambda: call(False)),
               noise_ms=_events_ms(lambda: call(True)))
    st = _stage_ms(lambda: call(False))
    out.update(encode_ms=st["amp_encode_kernel"],
               col_ms_per_iter=st["amp_col_kernel"] / T,
               row_ms_per_iter=st["amp_row_kernel"] / T)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("amp_ab: no CUDA device is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for tree in a.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"amp_ab: {tree} failed:\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree_arg"] = tree
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    print(card)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(card=card, shape=dict(L=L, M=M, T=T, B=B),
                           runs=runs), f, indent=1)


if __name__ == "__main__":
    main()
