#!/usr/bin/env python3
"""Time the split AMP kernel's decode call of two or more source trees on
one GPU, interleaved, to tell a code change from drift of the card.

    python3 sparc_ldpc_tpu_torch/tools/amp_ab.py TREE ... \
        [--l4096] [--compare] [--out results.json]

Each TREE is a directory that holds a `sparc_ldpc_tpu_torch/` package (the
repository root, or an unpacked `git archive` of another commit); list the
trees in the order to run them, e.g. `old new new old`.  Each runs in a
process of its own, which builds that tree's kernels and times the decode
call: at the headline shape L=1024, M=512, T=22 fixed, B=2048 (with
--l4096: fast_l4096's L=4096, M=512, n=24576, B=512, T=32 fixed), bf16,
the split form with the in-kernel encode, once with the noise as an input
and once drawn in the kernel (median of 5 calls each, CUDA events), and
the device ms of the encode and per iteration of the column and row
stages from one torch.profiler trace.  The inputs are synthetic (a random
row support of n of the L M positions, flat power, sigma2 of 2.0 dB at
R = 1): at fixed T the kernel's work does not depend on the data; a tree
whose `amp_fused` takes the split kernel's support tables gets them built
once, outside the timing.

With --compare each run also decodes one headline block of the real
headline model (SparcModel.build of L=1024, M=512, R=1.0, iterative
power, 2.0 dB, noise drawn in the kernel, B=2048, generator seed 0), and
every run is held to the first: the sections whose decision differs,
whether beta, the trace and the iteration counts are equal bit for bit.
Prints one JSON line per run, the card's `nvidia-smi` name and power
limit, and writes all of it to --out.
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

REPS = 5
SHAPES = {"headline": dict(L=1024, M=512, T=22, B=2048, n=9216),
          "l4096": dict(L=4096, M=512, T=32, B=512, n=24576)}
# each stage's kernel names: the dense design's, then the support design's
STAGES = {"encode": ("amp_encode_kernel", "k1_encode_kernel"),
          "col": ("amp_col_kernel", "k1_col_kernel"),
          "row": ("amp_row_kernel", "k1_row_kernel")}


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
            for k, names in STAGES.items():
                if any(nm in e.get("name", "") for nm in names):
                    us[k] += float(e.get("dur", 0.0))
    return {k: us[k] / 1e3 for k in STAGES}


def _headline_block(torch, dev, out_dir: str) -> dict:
    """Decode one headline block of the real model; save its decisions."""
    import numpy as np

    import sparc_ldpc_tpu_torch as slt
    from sparc_ldpc_tpu_torch.models.sparc import SparcModel
    from sparc_ldpc_tpu_torch.utils.bits import bits_to_indices

    cfg = slt.SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_kernel="fused_split",
                          transform_precision="bf16", amp_iters=32,
                          amp_tol=0.0, amp_iters_auto=True,
                          amp_noise_in_kernel=True)
    model = SparcModel.build(cfg, 2.0, dev)
    c = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    B = 2048
    bits = torch.randint(0, 2, (B, c.k_bits), generator=gen,
                         dtype=torch.int32, device=dev)
    idx = bits_to_indices(bits, c.logM)
    seeds = model.draw_seeds(gen, B)
    res = model.decode(None, encode_idx=idx, noise_seed=seeds,
                       noise_sigma=math.sqrt(model.sigma2))
    dec = res.beta.argmax(-1).to(torch.int16).cpu().numpy()
    path = os.path.join(out_dir, f"dec_{os.getpid()}.npy")
    np.save(path, dec)
    digest = {k: hashlib.sha256(v.contiguous().cpu().numpy().tobytes())
              .hexdigest() for k, v in (("beta", res.beta),
                                        ("trace", res.tau2_trace),
                                        ("iters", res.iters))}
    return dict(T=c.amp_iters, decisions=path, digest=digest,
                section_errors=int((res.beta.argmax(-1) != idx).sum()))


def worker(tree: str, shape: str, compare_dir: str) -> dict:
    """Time one tree's decode call (in this process)."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import inspect

    import torch

    from sparc_ldpc_tpu_torch.ops import _build
    from sparc_ldpc_tpu_torch.ops import amp_kernel as ak

    if not os.path.abspath(ak.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ak.__file__}, not from {root}")
    sh = SHAPES[shape]
    L, M, T, B, n = sh["L"], sh["M"], sh["T"], sh["B"], sh["n"]
    nvcc_s = _build.build()
    dev = torch.device("cuda", 0)
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
    form = {"split": True} if "split" in params else {}
    if "support" in params:
        from sparc_ldpc_tpu_torch.ops.split_support import (
            split_support_from_mask)
        form["support"] = split_support_from_mask(mask)

    def call(noise: bool):
        if noise:
            return ak.amp_fused(None, mask, sq, P, n, T, encode_idx=idx,
                                noise_seed=seeds, noise_sigma=sigma, **form)
        return ak.amp_fused(y_n, mask, sq, P, n, T, encode_idx=idx, **form)

    out = dict(tree=root, shape=shape, nvcc_s=nvcc_s,
               ms=_events_ms(lambda: call(False)),
               noise_ms=_events_ms(lambda: call(True)))
    st = _stage_ms(lambda: call(False))
    out.update(encode_ms=st["encode"], col_ms_per_iter=st["col"] / T,
               row_ms_per_iter=st["row"] / T)
    if compare_dir:
        del y_n
        out["headline_block"] = _headline_block(torch, dev, compare_dir)
    return out


def _compare(runs) -> None:
    """Hold every run's headline block to the first run's."""
    import numpy as np

    first = runs[0]["headline_block"]
    d0 = np.load(first["decisions"])
    for r in runs:
        hb = r["headline_block"]
        d = np.load(hb["decisions"])
        hb["decisions_differing"] = int((d != d0).sum())
        hb["sections"] = int(d.size)
        hb["bitwise_equal_to_first"] = {
            k: hb["digest"][k] == first["digest"][k] for k in hb["digest"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--compare-dir", help=argparse.SUPPRESS)
    ap.add_argument("--l4096", action="store_true")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    shape = "l4096" if a.l4096 else "headline"
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
                   tree] + (["--l4096"] if a.l4096 else [])
            if a.compare:
                cmd += ["--compare-dir", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"amp_ab: {tree} failed:\n{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec["tree_arg"] = tree
            print(json.dumps(rec), flush=True)
            runs.append(rec)
        if a.compare:
            _compare(runs)
            for r in runs:
                print(json.dumps({"tree_arg": r["tree_arg"],
                                  **r["headline_block"]}), flush=True)
    print(card)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(card=card, shape=SHAPES[shape], runs=runs), f,
                      indent=1)


if __name__ == "__main__":
    main()
