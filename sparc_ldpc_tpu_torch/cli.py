"""Campaign CLI of the PyTorch/CUDA port (port of sparc_ldpc_tpu/cli.py).

Presets are the reference's (the port's copy, config.PRESETS).  Examples:

  # BER sweep on the power-allocated L=1024 config, scan AMP through the
  # hand-written FWHT and denoiser kernels
  python -m sparc_ldpc_tpu_torch.cli campaign --preset pa_l1024 --pallas \\
      --ebno 2.5 3.0 --batch 512 --min-frame-errors 100 \\
      --out results/pa_l1024_torch.jsonl

  # concatenated SPARC + LDPC as shipped (fused AMP kernel with in-kernel
  # noise, layered BP kernel)
  python -m sparc_ldpc_tpu_torch.cli campaign --preset concat --ebno 3.0 \\
      --batch 2048 --out results/concat_torch.jsonl

  # the plain CPU routes, at a small size
  python -m sparc_ldpc_tpu_torch.cli campaign --preset plain_small --cpu \\
      --ebno 6.0 --batch 2 --max-trials 4

  # state-evolution design report (host only)
  python -m sparc_ldpc_tpu_torch.cli se --preset pa_l1024 --ebno 2.0

  # two processes (here on the GPUs of one node), counters summed over
  # them by gloo; only rank 0 writes
  python -m torch.distributed.run --nproc_per_node 2 \
      -m sparc_ldpc_tpu_torch.cli campaign --distributed --preset concat \
      --ebno 3.0 --batch 2048 --out results/concat_torch.jsonl

  # the section axis across two processes of one GPU each: the slabs
  # cross by NCCL (on one GPU shared by both: --dist-backend gloo)
  python -m torch.distributed.run --nproc_per_node 2 \
      -m sparc_ldpc_tpu_torch.cli campaign --distributed --section-shards 2 \
      --preset fast_l4096 --ebno 6.5 --batch 512 --out results/f.jsonl

Without --cpu the campaign runs on the GPUs and fails where there is none.
Its mesh (parallel/mesh.py) spans every GPU the process drives, D x S with
S = --section-shards; with --cpu it is S copies of the CPU.  Under
--distributed (torch.distributed, from the
environment that `python -m torch.distributed.run` sets; the counters
over gloo) each process drives its share of the node's GPUs (LOCAL_RANK
of LOCAL_WORLD_SIZE; processes share a GPU when they outnumber them) and
decodes its share of every block.  Where S does not divide a process's
devices, the section axis spans processes: S / k consecutive ranks of k
devices each hold one data group's slabs and decode the same rows, and
their slabs cross over a process group of their own, `--dist-backend`
(nccl on the GPUs by default, gloo with --cpu).  NCCL refuses two ranks
of one GPU, so processes that share a GPU need gloo, whose slabs cross
through host memory.  Results are jsonl, one record per sweep point with
the reference's keys plus backend and device (and the mesh, process
count and section processes under a mesh), and a per-block journal for
restart; --profile writes a torch.profiler trace and the program's
counters (one of each per process).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sparc_ldpc_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("campaign", help="run a Monte-Carlo BER/FER campaign")
    c.add_argument("--preset", default="plain_small",
                   help="plain_small | pa_l1024 | fast_l4096 | concat | "
                        "concat_wifi | concat_r56")
    c.add_argument("--ebno", type=float, nargs="+", default=None,
                   help="Eb/N0 grid in dB (default: preset grid)")
    c.add_argument("--batch", type=int, default=64)
    c.add_argument("--min-frame-errors", type=int, default=100)
    c.add_argument("--max-trials", type=int, default=100_000)
    c.add_argument("--seed", type=int, default=1234)
    c.add_argument("--out", default=None, help="results jsonl path")
    c.add_argument("--journal", default=None,
                   help="block journal for restart (default: <out>.journal)")
    c.add_argument("--section-shards", type=int, default=1)
    c.add_argument("--cpu", action="store_true",
                   help="run the plain CPU routes (debug, small sizes)")
    c.add_argument("--pallas", action="store_true",
                   help="the reference's Pallas route: scan AMP through the "
                        "FWHT and denoiser kernels")
    c.add_argument("--fused", action="store_true",
                   help="use the fused whole-AMP kernel (fixed-T)")
    c.add_argument("--amp-iters", type=int, default=None,
                   help="override the AMP iteration cap (e.g. 64 for "
                        "mid-waterfall points where SE needs >32 iters)")
    c.add_argument("--auto-iters", action="store_true",
                   help="SE-derived per-point AMP iteration budget "
                        "(amp_iters becomes the cap; design/se.py)")
    c.add_argument("--profile", default=None,
                   help="output dir of a torch.profiler trace of the "
                        "campaign (trace.json, with the program's spans) "
                        "and of its counters (counters.json: BP and "
                        "feedback-pass iterations, gathered bytes, each "
                        "interval's count and mean ms, the section "
                        "exchange)")
    c.add_argument("--distributed", action="store_true",
                   help="several processes (torch.distributed, gloo), "
                        "started by python -m torch.distributed.run")
    c.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the backend of a section axis across processes "
                        "(default: nccl on the GPUs, gloo with --cpu)")

    s = sub.add_parser("se", help="state-evolution design report")
    s.add_argument("--preset", default="pa_l1024")
    s.add_argument("--ebno", type=float, default=2.0)

    b = sub.add_parser("plot", help="render BER/FER curves from jsonl")
    b.add_argument("results", nargs="+")
    b.add_argument("--out", default="curves.png")
    return p


def _process_gpus(distributed: bool) -> list:
    """The CUDA devices this process drives: every visible GPU, or under
    --distributed its share of them (LOCAL_RANK of LOCAL_WORLD_SIZE, as
    `python -m torch.distributed.run` sets them), one shared GPU when the
    processes outnumber the GPUs.  Exits when the processes would leave
    some of the GPUs idle."""
    import torch

    import sparc_ldpc_tpu_torch as slt

    slt.default_device()                   # raises without a GPU
    n = torch.cuda.device_count()
    rank, local = 0, 1
    if distributed:
        rank = int(os.environ.get("LOCAL_RANK", "0"))
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if n < local:
        return [torch.device("cuda", rank % n)]
    if n % local:
        raise SystemExit(
            f"{local} processes cannot share {n} GPUs evenly: start a "
            f"number of processes that divides the GPUs, or set "
            f"CUDA_VISIBLE_DEVICES")
    k = n // local
    return [torch.device("cuda", i) for i in range(rank * k, (rank + 1) * k)]


def _section_procs(S: int, k: int, distributed: bool) -> int:
    """G, the processes the section axis spans: 1 where S divides the k
    GPUs of this process, else S / k (k must divide S, and the axis needs
    --distributed)."""
    if k % S == 0:
        return 1
    if S % k:
        raise SystemExit(f"--section-shards {S} and the {k} GPU(s) of this "
                         f"process: one must divide the other (start "
                         f"another number of processes)")
    if not distributed:
        raise SystemExit(f"--section-shards {S} spans more than the {k} "
                         f"GPU(s) of this process: a section axis across "
                         f"processes needs --distributed")
    return S // k


def _check_nccl_gpus() -> None:
    """NCCL refuses two ranks of one GPU ("Duplicate GPU detected"): exit
    where this node's processes share its GPUs."""
    import torch

    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    n = torch.cuda.device_count()
    if local > n:
        raise SystemExit(
            f"--dist-backend nccl: the {local} processes of this node share "
            f"its {n} GPU(s), and NCCL refuses two ranks of one GPU; start "
            f"one process a GPU, or pass --dist-backend gloo (the slabs "
            f"then cross through host memory)")


def _init_distributed() -> None:
    import torch.distributed as dist

    need = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise SystemExit(f"--distributed needs {', '.join(missing)} in the "
                         f"environment: start it with python -m "
                         f"torch.distributed.run")
    dist.init_process_group("gloo", init_method="env://")


def cmd_campaign(args) -> int:
    S = args.section_shards
    if S < 1 or S & (S - 1):
        raise SystemExit(f"--section-shards must be a power of two, got {S}")

    from .config import (
        PRESETS, CampaignConfig, ConcatConfig, SparcConfig)

    cfg = PRESETS[args.preset]
    if not isinstance(cfg, (SparcConfig, ConcatConfig)):
        raise SystemExit(f"--preset {args.preset} is not a code "
                         f"configuration")
    if args.fused:
        sp = cfg.sparc if isinstance(cfg, ConcatConfig) else cfg
        if sp.amp_tol != 0.0:
            print(f"--fused: fixed-T route replaces the preset's adaptive "
                  f"amp_tol={sp.amp_tol:g} with 0.0 "
                  f"(every codeword runs all {sp.amp_iters} iterations; "
                  f"drop --fused to keep the preset's kernel+tol)")
        if isinstance(cfg, ConcatConfig):
            cfg = cfg.replace(sparc=cfg.sparc.replace(
                amp_kernel="fused_split", amp_tol=0.0,
                transform_precision="bf16"))
        else:
            cfg = cfg.replace(amp_kernel="fused_split", amp_tol=0.0,
                              transform_precision="bf16")
    if args.amp_iters is not None:
        if args.amp_iters <= 0:
            raise SystemExit(f"--amp-iters must be positive, "
                             f"got {args.amp_iters}")
        if isinstance(cfg, ConcatConfig):
            cfg = cfg.replace(sparc=cfg.sparc.replace(
                amp_iters=args.amp_iters))
        else:
            cfg = cfg.replace(amp_iters=args.amp_iters)
    if args.auto_iters:
        if isinstance(cfg, ConcatConfig):
            cfg = cfg.replace(sparc=cfg.sparc.replace(amp_iters_auto=True))
        else:
            cfg = cfg.replace(amp_iters_auto=True)
    grid = tuple(args.ebno) if args.ebno else (1.5, 2.0, 2.5, 3.0)
    ccfg = CampaignConfig(ebno_grid_db=grid, batch=args.batch,
                          min_frame_errors=args.min_frame_errors,
                          max_trials=args.max_trials, base_seed=args.seed,
                          section_shards=args.section_shards)

    import torch

    from .parallel.mesh import make_mesh

    if args.cpu:
        if args.dist_backend == "nccl":
            raise SystemExit("--dist-backend nccl needs the GPUs: with --cpu "
                             "the counters cross processes over gloo and the "
                             "section axis stays in each")
        devices = [torch.device("cpu")] * S
        backend = "gloo"
    else:
        devices = _process_gpus(args.distributed)
        backend = args.dist_backend or "nccl"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    G = _section_procs(S, len(devices), args.distributed)
    if G > 1 and backend == "nccl":
        _check_nccl_gpus()
    if args.distributed:
        _init_distributed()
    try:
        _run_campaign(args, cfg, ccfg, make_mesh(S // G, devices), G,
                      backend)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()
    return 0


def _run_campaign(args, cfg, ccfg, mesh, section_procs: int = 1,
                  backend: str = "gloo") -> None:
    """The campaign of cmd_campaign on `mesh` (a policy unless it is one
    device in one process), its section axis spanning `section_procs`
    processes over `backend`."""
    import torch

    from .config import ConcatConfig
    from .parallel.campaign import run_campaign
    from .parallel.mesh import ShardingPolicy
    from .utils.profiling import trace
    from .utils.provenance import artifact_meta

    device = mesh.home
    if device.type == "cuda":
        torch.cuda.set_device(device)      # this process's first GPU (and
        # its section group's NCCL device)
    policy = ShardingPolicy.for_process(mesh, section_procs, backend)
    if mesh.shape == (1, 1) and policy.world == 1:
        policy = None
    if isinstance(cfg, ConcatConfig):
        from .models.concat import ConcatSweep
        sweep = ConcatSweep(cfg, use_pallas=args.pallas, device=device,
                            policy=policy)

        def k_bits(m):
            return m.k_user
    else:
        from .models.sparc import SparcSweep
        sweep = SparcSweep(cfg, use_pallas=args.pallas, device=device,
                           policy=policy)

        def k_bits(m):
            return m.cfg.k_bits

    out = args.out
    journal = args.journal or (out + ".journal" if out else None)
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    meta = artifact_meta(args.preset, cfg, device)
    if policy is not None:
        meta.update(mesh=list(mesh.shape), processes=policy.world)
        if section_procs > 1:
            meta.update(section_shards=policy.section_shards,
                        section_processes=section_procs,
                        dist_backend=backend)
    if policy is None or policy.is_writer:
        print(f"campaign: preset={args.preset} grid={ccfg.ebno_grid_db} "
              f"batch={args.batch} device={dev_name} "
              f"section_shards={args.section_shards} mesh="
              f"{meta.get('mesh', [1, 1])} processes="
              f"{meta.get('processes', 1)} section_processes="
              f"{section_procs} dist_backend="
              f"{backend if section_procs > 1 else 'none'}")

    def go():
        return run_campaign(sweep.model_for_point, ccfg, k_bits,
                            journal_path=journal, results_path=out,
                            policy=policy, meta=meta)

    if args.profile:
        where = args.profile
        if policy is not None and policy.world > 1:
            where = os.path.join(where, f"rank{policy.rank}")
        with trace(where):
            go()
        print(f"profile trace written to {where}")
    else:
        go()
    if section_procs > 1:
        _print_exchange(policy, device)


def _print_exchange(policy, device) -> None:
    """One line a rank: its section exchange (calls, bytes, host seconds)
    and its launches of K3 and K4, the kernels of the sharded decode."""
    from .ops.amp_kernel import fwht_tile
    from .ops.denoiser import denoise_kernel
    from .parallel.mesh import EXCHANGE_STATS

    print("section_exchange " + json.dumps(dict(
        rank=policy.rank, device=str(device), **EXCHANGE_STATS,
        fwht_tile=fwht_tile.launches, denoise=denoise_kernel.launches)),
        flush=True)


def cmd_se(args) -> int:
    from .config import PRESETS, ConcatConfig
    from .design.power import power_allocation
    from .design.se import se_trajectory

    cfg = PRESETS[args.preset]
    if isinstance(cfg, ConcatConfig):
        cfg = cfg.sparc
    sigma2 = cfg.sigma2(args.ebno)
    p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2, cfg.n, cfg.M,
                         cfg.pa_a, cfg.pa_f)
    tr = se_trajectory(p, cfg.n, cfg.M, sigma2)
    rec = dict(preset=args.preset, ebno_db=args.ebno, sigma2=sigma2,
               n=cfg.n, L=cfg.L, M=cfg.M,
               pa_kind=cfg.power_alloc,
               pa_min=float(p.min()), pa_max=float(p.max()),
               se_iters=len(tr) - 1, tau2_final=float(tr[-1]),
               decodes=bool(tr[-1] < 1.25 * sigma2),
               tau2_trace=[round(float(t), 6) for t in tr])
    print(json.dumps(rec, indent=2))
    return 0


def cmd_plot(args) -> int:
    from .utils.io import read_jsonl
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1
    fig, ax = plt.subplots(1, 2, figsize=(11, 4))
    for path in args.results:
        recs = list(read_jsonl(path))
        pts = [r for r in recs if r.get("kind") == "point"]
        if not pts:
            continue
        eb = [r["ebno_db"] for r in pts]
        label = os.path.basename(path).replace(".jsonl", "")
        ax[0].semilogy(eb, [max(r["ber"], 1e-12) for r in pts],
                       "o-", label=label)
        ax[1].semilogy(eb, [max(r["fer"], 1e-12) for r in pts],
                       "s-", label=label)
        # overlay SE-prediction legs when the artifact carries them
        se = sorted((r["ebno_db"], r["ber"]) for r in recs
                    if r.get("kind") == "se")
        if se:
            ax[0].semilogy([e for e, _ in se],
                           [max(b, 1e-12) for _, b in se],
                           "k--", alpha=0.7, label=f"{label} (SE)")
    for a, name in zip(ax, ("BER", "FER")):
        a.set_xlabel("Eb/N0 (dB)")
        a.set_ylabel(name)
        a.grid(True, which="both", alpha=0.3)
        a.legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "campaign":
        return cmd_campaign(args)
    if args.cmd == "se":
        return cmd_se(args)
    if args.cmd == "plot":
        return cmd_plot(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
