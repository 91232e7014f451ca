#!/usr/bin/env python3
"""Sharded end-to-end blocks of the port on an n-device mesh, at tiny
shapes (port of the reference's `__graft_entry__.dryrun_multichip`).

    python -m sparc_ldpc_tpu_torch.tools.dryrun_multichip [N] [--cuda]

The mesh is N copies of the CPU (a virtual mesh), or with --cuda the
visible GPUs, repeated to N where there are fewer.  One `run_block` (a
fresh generator, a batch of two codewords per data shard) on each of the
reference's eight paths, each printing one line that ends in OK:

  1. the scan route on a (N/2, 2) data x section mesh (the collective
     transform: the port has no partitioner for the reference's "gspmd");
  2. the fused route section-sharded (K3 loop) with the early stop;
  3. fwht_dist="collective" on the scan route;
  4. the fused route pure DP on (N, 1) with the in-kernel encode;
  5. a tiny concat chain under pure DP (in-kernel encode on both passes);
  6. the concat chain with a section-sharded inner AMP;
  7.-8. the second mesh shape (N/4, 4): two hypercube stages, for the
     fused route and the concat chain.
"""

from __future__ import annotations

import argparse

import torch

from ..config import ConcatConfig, LdpcConfig, SparcConfig
from ..models.concat import ConcatModel
from ..models.sparc import SparcModel
from ..parallel.mesh import ShardingPolicy, make_mesh
from ..utils.rng import block_generator


def _devices(n: int, cuda: bool) -> list:
    if not cuda:
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("--cuda: no CUDA device is visible")
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices: int, cuda: bool = False) -> None:
    devices = _devices(n_devices, cuda)
    S = 2 if n_devices % 2 == 0 else 1
    policy = ShardingPolicy(make_mesh(S, devices))
    dp = ShardingPolicy(make_mesh(1, devices))

    def run(tag, build, pol, seed=0):
        model = build(pol)
        batch = 2 * pol.data_shards
        out = {k: v.item() for k, v in model.run_block(
            block_generator(seed, 0, 0, pol.home), batch).items()}
        assert out["trials"] == batch, out
        extra = (f" bp_ok={out['bp_ok']}" if "bp_ok" in out else "")
        print(f"dryrun_multichip({n_devices}) [{tag}]: mesh="
              f"{pol.mesh.shape} batch={batch} bit_errors="
              f"{out['bit_errors']}{extra} OK", flush=True)

    # L = 128: four section shards leave the K3 kernel its least l, 32
    base = SparcConfig(L=128, M=64, R=1.0, op_kind="hadamard", amp_iters=4)
    fused = base.replace(amp_kernel="fused", amp_tol=1e-4)

    def sparc(cfg):
        return lambda pol: SparcModel.build(cfg, 5.0, None, policy=pol)

    run("scan", sparc(base), policy)
    run("fused-sharded", sparc(fused), policy)
    run("collective-fwht", sparc(base.replace(fwht_dist="collective")),
        policy)
    assert fused.amp_encode_in_kernel
    run("fused-dp-enc", sparc(fused), dp)

    ccfg = ConcatConfig(
        sparc=base.replace(amp_tol=0.0, amp_kernel="fused"),
        ldpc=LdpcConfig(kind="array", z=7, rows_b=2, cols_b=6, bp_iters=8,
                        engine="qc", schedule="layered"),
        f_prot=0.5, feedback_iters=2)

    def concat(pol):
        model = ConcatModel.build(ccfg, 5.0, None, policy=pol)
        assert model.sparc.enc_in_kernel == (pol.section_shards == 1)
        return model

    run("concat-dp", concat, dp, seed=1)
    if S > 1:
        run("concat-sectioned", concat, policy, seed=2)
    if n_devices % 4 == 0:
        policy4 = ShardingPolicy(make_mesh(4, devices))
        run("fused-sharded-s4", sparc(fused), policy4)
        run("concat-sectioned-s4", concat, policy4, seed=3)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--cuda", action="store_true",
                   help="a mesh of the visible GPUs, repeated to n")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.cuda)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
