"""Fused AMP under a (data, section) mesh (port of
sparc_ldpc_tpu/parallel/amp_sharded.py `amp_fused_sharded`).

- **Pure DP** (one section shard): each data shard runs the unchanged
  `amp_fused` (K1, or K6 at L <= 1024 under amp_kernel="fused") on its
  slice of the batch, on its device; encode indices, noise seeds and pins
  are sliced alike.  K1 and K6 compute each codeword alone, so the result
  is the single-device call's, bit for bit.  Every shard's tables are
  staged onto its device before the first launch
  (`ShardingPolicy.stage`).

- **Section-sharded** (S > 1, a power of two dividing L): a loop over the
  iterations in which device (d, s) holds the (B / D, L / S, M) slab of
  data shard d's state, in true scale.  Per iteration:

    bnorm2 = sum over the slabs of sum(beta^2)
    coef   = (P - bnorm2 / n) / tau2_prev            (0 at t = 0)
    w      = transform(beta)
    z      = mask y - mask w + coef z
    tau2   = sum over the slabs of sum(z^2) / n     (or the schedule)
    beta   = eta(transform(z) + beta; tau2), then the pins

  where transform is K3 (`fwht_tile`, H_{L/S} (x) H_M of each slab with
  the 1/sqrt(n) scale, bf16 operands as in the reference's tile kernel)
  followed by the log2(S) `hypercube` stages of H_S, and eta is the
  sectionwise softmax, local to a slab since sections are whole: K4
  (`denoise_kernel`) on a CUDA tensor, `denoise` on a CPU tensor.  Scalars
  are summed over the slabs in shard order, so the result does not depend
  on timing.  With tol > 0 the reference's freeze mask holds a converged
  codeword's state and trace but cannot skip its work.  The in-kernel
  encode and noise need a codeword's whole tile on one device, so the
  section-sharded route takes y with the codeword in it.

  Where the section axis spans the processes of a section group
  (parallel/mesh.py), each rank holds its own slabs of the group's rows:
  the hypercube stages between processes exchange slabs point to point,
  the per-codeword partial sums of the slabs are gathered over the group
  and added in shard order (the one-process sum, bit for bit: an
  all-reduce's order is not fixed), and beta is gathered over the group
  in shard order, so every rank of the group returns what one process
  returns.  The freeze mask and the iteration counts are per codeword on
  each rank, from the same sums.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..ops.amp_kernel import amp_fused, fwht_tile
from ..ops.denoiser import denoise_kernel
from ..utils.profiling import annotate
from .dist_fwht import hypercube
from .mesh import ShardingPolicy


def _to(t: Optional[torch.Tensor], dev: torch.device):
    return None if t is None else t.to(dev)


def amp_fused_sharded(
        y_n: Optional[torch.Tensor],      # (B, L, M) N-space embedded y
        mask: torch.Tensor,               # (L, M) 0/1 row support
        sq_npl: torch.Tensor,             # (L,)
        P: float, n: int, T: int,
        policy: ShardingPolicy,
        tau2_schedule: Optional[torch.Tensor] = None,  # (T,)
        pin_idx: Optional[torch.Tensor] = None,        # (B, L) int32, -1 off
        split: Optional[bool] = None,
        tol: float = 0.0,
        encode_idx: Optional[torch.Tensor] = None,     # (B, L), pure DP only
        noise_seed: Optional[torch.Tensor] = None,     # (B, 2), pure DP only
        noise_sigma: Optional[float] = None,
        split_support=None,                            # op.split_support
):
    """`amp_fused` over the policy's mesh: each data shard's (beta (B_d, L,
    M) true scale, tau2 trace (T, B_d), iterations used (B_d,) int32), in
    shard order, on the shard's first device; iterations are T when tol
    == 0.  A field stays there until a caller gathers it
    (`ShardingPolicy.gather`; the model's `AmpResult`).  split_support,
    the operator's cache of the split kernel's tables of mask
    (`amp_fused`'s support, per device), gives each data shard the tables
    on its device; the section-sharded loop does not read it."""
    if tol and tau2_schedule is not None:
        raise ValueError("a tau2 schedule has no online estimate for tol")
    if policy.section_shards == 1:
        return _data_parallel(y_n, mask, sq_npl, P, n, T, policy,
                              tau2_schedule, pin_idx, split, tol, encode_idx,
                              noise_seed, noise_sigma, split_support)
    return _section_sharded(y_n, mask, sq_npl, P, n, T, policy,
                            tau2_schedule, pin_idx, tol, encode_idx,
                            noise_seed)


def _section_sharded(y_n, mask, sq_npl, P, n, T, policy, tau2_schedule,
                     pin_idx, tol, encode_idx, noise_seed):
    """The section-sharded loop (module docstring): each data shard's
    (beta, trace, iterations) on its device (d, 0), beta gathered over
    the shard's slabs."""
    if encode_idx is not None or noise_seed is not None:
        raise ValueError("the in-kernel encode and noise need each "
                         "codeword's whole (L, M) state on one device; "
                         "section-sharded callers encode outside")
    S = policy.section_shards
    L = mask.shape[0]
    if L % S:
        raise ValueError(f"L = {L} is not divisible by {S} section shards")
    decodes = [_SectionShard(policy, d, y_d, mask, sq_npl, P, n, tol,
                             tau2_schedule, pin_d)
               for d, (y_d, pin_d) in enumerate(zip(policy.split_data(y_n),
                                                    policy.split_data(pin_idx)))]
    # iteration-major, so that the data shards of a multi-GPU mesh run
    # their iteration t side by side
    for t in range(T):
        for dec in decodes:
            dec.step(t)
    return [(dec.gathered_beta(), torch.stack(dec.trace), dec.iters)
            for dec in decodes]


def _data_parallel(y_n, mask, sq_npl, P, n, T, policy, tau2_schedule,
                   pin_idx, split, tol, encode_idx, noise_seed, noise_sigma,
                   split_support):
    """Each data shard's amp_fused on its device, in shard order: every
    shard's tables staged first (`ShardingPolicy.stage`), then the
    launches back to back.  Returns each shard's (beta, trace,
    iterations) on its device.  While tracing, a `mesh.shard` span a
    shard around its launch."""
    L, M = mask.shape
    tables = policy.stage(lambda dev: (
        mask.to(dev), sq_npl.to(dev), _to(tau2_schedule, dev),
        None if split_support is None else split_support(L, M, dev)))
    outs = []
    for (mask_d, sq_d, sched_d, support), y_d, enc_d, seed_d, pin_d in zip(
            tables, policy.split_data(y_n), policy.split_data(encode_idx),
            policy.split_data(noise_seed), policy.split_data(pin_idx)):
        with annotate("mesh.shard"):
            outs.append(amp_fused(
                y_d, mask_d, sq_d, P, n, T, encode_idx=enc_d, tol=tol,
                pin_idx=pin_d, tau2_schedule=sched_d, noise_seed=seed_d,
                noise_sigma=noise_sigma, split=split, support=support))
    return outs


def _sum_slabs(parts: List[torch.Tensor], dev: torch.device,
               policy: ShardingPolicy) -> torch.Tensor:
    """Per-codeword sums of the slabs' squares, added in shard order on
    dev: this process's slabs, or every slab of the section group (their
    partial sums gathered over it)."""
    sums = [(p * p).sum((1, 2)).to(dev) for p in parts]
    if policy.section_procs > 1:
        sums = list(policy.gather_sections(torch.stack(sums), 0))
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


class _SectionShard:
    """The state and one iteration of data shard d's section-sharded decode
    (module docstring); slab s of every (B_d, L, M) tensor lives on device
    (d, s), the per-codeword scalars on device (d, 0)."""

    def __init__(self, policy: ShardingPolicy, d: int, y_d, mask, sq_npl,
                 P: float, n: int, tol: float, tau2_schedule, pin_d):
        self.policy = policy
        self.devs = policy.mesh.devices[d]
        self.dev0 = self.devs[0]
        self.P, self.n, self.tol = P, n, tol
        self.scale = 1.0 / math.sqrt(n)
        self.sched = _to(tau2_schedule, self.dev0)
        self.mask = policy.split_sections(mask.to(torch.float32), d, 0)
        self.sq = policy.split_sections(sq_npl, d, 0)
        self.my = [m[None] * y for m, y in
                   zip(self.mask, policy.split_sections(y_d, d, 1))]
        self.pin = policy.split_sections(pin_d, d, 1)
        B = y_d.shape[0]
        self.beta = [torch.zeros_like(y) for y in self.my]
        self.z = [torch.zeros_like(y) for y in self.my]
        self.tau2_prev = torch.full((B,), math.inf, device=self.dev0)
        self.done = torch.zeros((B,), dtype=torch.bool, device=self.dev0)
        self.iters = torch.zeros((B,), dtype=torch.int32, device=self.dev0)
        self.trace: List[torch.Tensor] = []

    def transform(self, slabs):
        """H_L (x) H_M / sqrt(n) of the codewords: K3 on each slab, then
        H_S across the slabs."""
        return hypercube([fwht_tile(x, "bf16", self.scale) for x in slabs],
                         self.policy)

    def step(self, t: int) -> None:
        bnorm2 = _sum_slabs(self.beta, self.dev0, self.policy)
        coef = (self.P - bnorm2 / self.n) / self.tau2_prev    # 0 at t = 0
        w = self.transform(self.beta)
        z_new = [my - m[None] * wi + coef.to(wi.device)[:, None, None] * zi
                 for my, m, wi, zi in zip(self.my, self.mask, w, self.z)]
        del w
        if self.sched is None:
            tau2 = _sum_slabs(z_new, self.dev0, self.policy) / self.n
        else:
            tau2 = self.sched[t].expand(self.tau2_prev.shape[0])
        s = [a + b for a, b in zip(self.transform(z_new), self.beta)]
        beta_new = []
        for s_s, sq_s, pin_s in zip(s, self.sq, self.pin):
            b, _ = denoise_kernel(s_s, tau2.to(s_s.device).contiguous(),
                                  sq_s)
            if pin_s is not None:
                cols = torch.arange(b.shape[-1], device=b.device)
                pv = torch.where(cols == pin_s[..., None].to(torch.int64),
                                 sq_s[None, :, None], 0.0)
                b = torch.where((pin_s >= 0)[..., None], pv, b)
            beta_new.append(b)
        del s
        if not self.tol:
            self.beta, self.z, self.tau2_prev = beta_new, z_new, tau2
            self.iters += 1
            self.trace.append(tau2)
            return
        # the reference's freeze: `done` comes from the iteration that ran,
        # and the next iteration is the first whose state is held
        keep = self.done
        conv = (tau2 - self.tau2_prev).abs() < self.tol * tau2
        self.beta = [torch.where(keep.to(b.device)[:, None, None], b, bn)
                     for b, bn in zip(self.beta, beta_new)]
        self.z = [torch.where(keep.to(z.device)[:, None, None], z, zn)
                  for z, zn in zip(self.z, z_new)]
        self.tau2_prev = torch.where(keep, self.tau2_prev, tau2)
        self.iters += (~keep).to(torch.int32)
        self.done = keep | conv
        self.trace.append(self.tau2_prev)

    def gathered_beta(self) -> torch.Tensor:
        """beta (B_d, L, M) on device (d, 0), every slab of the section
        group in shard order."""
        return self.policy.gather_sections(
            torch.cat([b.to(self.dev0) for b in self.beta], 1), 1)
