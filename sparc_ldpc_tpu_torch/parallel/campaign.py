"""Monte-Carlo BER/FER campaign driver (port of
sparc_ldpc_tpu/parallel/campaign.py).

Per Eb/N0 point: run trial blocks until the frame-error budget or the
trial cap is met.  Block b of point p draws everything from
`block_generator(base_seed, p, b, device)`, so a block's counters depend
only on its coordinates, and:

  - completed blocks are journaled (utils.io.CampaignState) and replayed on
    restart; a crash costs only the in-flight block;
  - the dispatch is pipelined: block b + 1 is launched before block b's
    counters are read back, so the host's readback overlaps the device's
    next block.  Block b's counters are copied into pinned host memory
    right after its launch (non_blocking) and a CUDA event is recorded
    behind the copy; the harvest waits on that event only.  A plain
    `.item()` on block b after b + 1 is queued on the same stream would
    wait for b + 1 as well and serialize the pipeline.

Throughput comes from the blocks this process executed, each timed by
when its work completed, not by when the host harvested it: on a CUDA
device by a timing event recorded behind the copy of its counters, read
on the device clock against a start event recorded at the point's first
launch; on the CPU by the host clock when `run_block` returns.  A launch
that waits for the device (an exchange between processes, any
synchronizing op, every CPU run) therefore moves no block's time into
another's.  Journal-replayed blocks add counters but no time, and the
first executed block, which carries the kernels' nvcc build at first use
and the CUDA warm-up, is excluded: `first_block_s` is its time from its
launch to its completion, and the steady rate divides the later blocks'
trials by the time from the first block's completion to the last's.

Under a ShardingPolicy (parallel/mesh.py) the generators live on the
mesh's home device and the model cuts each block over the mesh.  With
several processes (torch.distributed), every rank runs the same blocks
and decodes its rows of each; at each harvest the block's counters are
summed over the ranks before anything reads them, so every rank takes the
same budget decisions.  Only rank 0 (`is_writer`) writes the journal and
the results; on resume, rank 0's journal is broadcast, so every rank
replays the same blocks.  A journal of another section axis is refused
(utils.io.CampaignState.check_resume): S > 1 draws and decodes otherwise.
So is one whose blocks drew on another device type: the journal lines
record the device type of the generators (`draw_device`), and a CUDA and a
CPU generator draw differently from one seed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from .. import check_device
from ..utils import io as iou
from ..utils.profiling import annotate
from ..utils.rng import block_generator
from .mesh import ShardingPolicy

_COUNTER_KEYS = ("bit_errors", "frame_errors", "section_errors", "trials",
                 "iters_sum", "bp_ok", "bit_errors_sq")


def _stage(out: Dict[str, torch.Tensor]):
    """Queue the copy of a block's counters to the host.

    Returns (keys, values, done): on a CUDA device values is a pinned host
    tensor that holds the counters once `done`, a timing event, has
    completed; on the CPU it holds them already and done is the host
    clock (time.perf_counter) at which the block's work was complete."""
    keys = [k for k in _COUNTER_KEYS if k in out]
    vals = torch.stack([out[k].reshape(()).to(torch.float64) for k in keys])
    if not vals.is_cuda:
        return keys, vals, time.perf_counter()
    host = torch.empty(vals.shape, dtype=torch.float64, pin_memory=True)
    host.copy_(vals, non_blocking=True)       # on vals' device's stream
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(vals.device))
    return keys, host, event


def _launch_mark(device: torch.device):
    """The point's start, taken at its first launch: a timing event on the
    device's current stream (CUDA), or the host clock (CPU)."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _seconds(start, done) -> float:
    """Seconds from the start mark to a block's completion mark (on the
    device clock for CUDA events, which have completed)."""
    if isinstance(done, float):
        return done - start
    return start.elapsed_time(done) / 1e3


def run_point(
    run_block: Callable,
    base_seed: int,
    batch: int,
    min_frame_errors: int,
    max_trials: int,
    state: Optional[iou.CampaignState] = None,
    point_idx: int = 0,
    device=None,
    policy: Optional[ShardingPolicy] = None,
    pipelined: bool = True,
) -> Dict[str, float]:
    """Run blocks until the error budget of one sweep point is met.

    run_block(gen, batch) -> dict of counter tensors.  The budget check
    sees counters lagged by the one block in flight, which over-dispatches
    at most one block per point; that block is journaled like any other.
    To keep a restart exact, journal-replayed blocks go through the same
    one-slot pending machinery, so the decision to process block b always
    uses the totals through block b - 2, and a point resumed from its
    journal reproduces the original block set and counters bit for bit.
    pipelined=False harvests each block before the next is launched (the
    check then sees block b - 1); its block set can differ from the
    pipelined one by the trailing block.  The generators live on `device`;
    None takes the policy's home device, the device of the model whose
    bound run_block this is, and otherwise `default_device()`.  With a
    policy, batch is the whole block's (every process's rows) and must
    divide by its processes times its data shards.
    """
    if policy is not None:
        policy.check_batch(batch)
        if device is None:
            device = policy.home
    if device is None:
        device = getattr(getattr(run_block, "__self__", None), "device",
                         None)
    device = check_device(device)
    with annotate("campaign.point"):
        totals: Dict[str, float] = {}
        block = 0
        exec_blocks = 0
        exec_trials = 0
        exec_wall = 0.0
        t0 = time.perf_counter()
        start = None    # the first executed launch's mark (_launch_mark)
        pending = None  # ("exec", block_idx, staged) | ("replay", idx, rec)

        def harvest():
            """Fold the pending block's counters into totals (and
            journal)."""
            nonlocal pending, exec_blocks, exec_trials, exec_wall
            if pending is None:
                return
            tag, blk, payload = pending
            pending = None
            if tag == "replay":
                for k in _COUNTER_KEYS:
                    if k in payload:
                        totals[k] = totals.get(k, 0) + payload[k]
                return
            keys, vals, done = payload
            with annotate("campaign.wait"):
                if not isinstance(done, float):
                    done.synchronize()
            if policy is not None:
                vals = policy.all_reduce(vals)
            out = {k: int(v) for k, v in zip(keys, vals.tolist())}
            # this block's completion, from the first executed launch
            exec_wall = _seconds(start, done)
            if "first_block_s" not in totals:
                # the first executed block carries the kernels' build at
                # first use and the CUDA warm-up; kept apart from the
                # throughput
                totals["first_block_s"] = exec_wall
            exec_blocks += 1
            exec_trials += out.get("trials", 0)
            for k, v in out.items():
                totals[k] = totals.get(k, 0) + v
            if state is not None:
                with annotate("campaign.journal"):
                    state.record_block(point_idx, blk, out)

        while (totals.get("frame_errors", 0) < min_frame_errors
               and totals.get("trials", 0) < max_trials):
            if state is not None and state.is_done(point_idx, block):
                rec = state.block_record(point_idx, block)
                harvest()
                pending = ("replay", block, rec)
                if not pipelined:
                    harvest()
                block += 1
                continue
            with annotate("campaign.launch"):
                gen = block_generator(base_seed, point_idx, block, device)
                if start is None:
                    start = _launch_mark(device)
                # queued, not waited on
                staged = _stage(run_block(gen, batch))
            harvest()                               # the PREVIOUS block
            pending = ("exec", block, staged)
            if not pipelined:
                harvest()
            block += 1
        harvest()
        totals["wall_s"] = time.perf_counter() - t0
        totals["blocks"] = block
        totals["exec_blocks"] = exec_blocks
        totals["exec_trials"] = exec_trials
        totals["exec_wall_s"] = exec_wall
        return totals


def steady_bits_per_s(tot: Dict[str, float], batch: int,
                      kb: int) -> Optional[float]:
    """Steady-state throughput: blocks this process executed, the first
    (build- and warm-up-bearing) block excluded.  `exec_wall_s` is the
    last executed block's completion and `first_block_s` the first's, both
    from the first executed launch (run_point), so the rate is the later
    blocks' trials over the time between the two completions.

    None below two executed blocks: a one-block point's only timing
    includes the first use, and a journal-replayed point did no work
    here."""
    eb = tot.get("exec_blocks", 0)
    fb = tot.get("first_block_s")
    if fb is None or eb < 2:
        return None
    et = tot.get("exec_trials", 0)
    return ((et - batch) * kb
            / max(tot.get("exec_wall_s", 0.0) - fb, 1e-9))


def run_campaign(
    model_for_point: Callable[[float], object],
    cfg,
    k_bits_fn: Callable[[object], int],
    journal_path: Optional[str] = None,
    results_path: Optional[str] = None,
    policy: Optional[ShardingPolicy] = None,
    verbose: bool = True,
    meta: Optional[Dict[str, object]] = None,
    pipelined: bool = True,
) -> List[Dict[str, float]]:
    """Full Eb/N0 sweep -> list of result records (also appended to
    results_path as jsonl).

    Args:
      model_for_point: ebno_db -> model with .run_block(gen, batch) and
        .device.
      cfg: a CampaignConfig (grid, batch, budgets, base seed).
      k_bits_fn: model -> payload bits per trial (the BER denominator).
      meta: provenance fields merged into every record
        (utils.provenance.artifact_meta).
      policy: the ShardingPolicy the models were built with; only its
        writer writes the journal and the results.
    """
    writer = policy is None or policy.is_writer
    state = None
    results = []
    for pi, ebno in enumerate(cfg.ebno_grid_db):
        model = model_for_point(ebno)
        if journal_path and state is None:
            # the blocks draw on the models' device (run_point), which the
            # first model names
            state = iou.CampaignState(
                journal_path if writer else None,
                1 if policy is None else policy.section_shards,
                model.device.type)
            if policy is not None:
                state.done = policy.broadcast(state.done)
            state.check_resume()    # after the broadcast: every rank alike
        # the reference prefers a model's staged runner where it has one;
        # the port's models have none (ROADMAP A7)
        tot = run_point(model.run_block, cfg.base_seed, cfg.batch,
                        cfg.min_frame_errors, cfg.max_trials, state=state,
                        point_idx=pi, device=model.device, policy=policy,
                        pipelined=pipelined)
        kb = k_bits_fn(model)
        trials = max(1, int(tot.get("trials", 0)))
        rec = dict(
            kind="point", ebno_db=float(ebno),
            ber=tot.get("bit_errors", 0) / (trials * kb),
            fer=tot.get("frame_errors", 0) / trials,
            trials=trials,
            bit_errors=int(tot.get("bit_errors", 0)),
            bit_errors_sq=int(tot.get("bit_errors_sq", 0)),
            frame_errors=int(tot.get("frame_errors", 0)),
            mean_iters=tot.get("iters_sum", 0) / trials,
            wall_s=tot["wall_s"],
            first_block_s=tot.get("first_block_s"),
            bits_per_s=steady_bits_per_s(tot, cfg.batch, kb),
            blocks=int(tot["blocks"]),
            exec_blocks=int(tot.get("exec_blocks", 0)),
            **(meta or {}),
        )
        results.append(rec)
        if results_path and writer:
            iou.append_jsonl(results_path, rec)
        if verbose and writer:
            bps = rec["bits_per_s"]
            bps_s = f"{bps:,.0f} bits/s" if bps else "bits/s: n/a (<2 blocks)"
            print(f"  ebno={ebno:5.2f} dB  ber={rec['ber']:.3e}  "
                  f"fer={rec['fer']:.3e}  trials={trials}  ({bps_s})")
    return results
