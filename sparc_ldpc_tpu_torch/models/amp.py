"""AMP decode loop (port of sparc_ldpc_tpu/models/amp.py).

Per iteration: two transform matvecs and one sectionwise softmax, with the
Onsager correction and online tau tracking:

    z_t    = y - A beta_t + (z_{t-1} / tau2_{t-1}) (P - |beta_t|^2 / n)
    tau2_t = |z_t|^2 / n                      (or an SE schedule)
    s_t    = beta_t + A^T z_t
    beta_{t+1} = eta(s_t; tau2_t)             (ops.denoiser)

Two routes: the fused whole-trial route where `fused_route` allows it
(ops.amp_kernel.amp_fused: the CUDA kernel of the split, mono or slab form
on a GPU, its plain version on the CPU; with noise seeds the split form
also draws the channel noise) and the scan route, a Python loop, whose
denoiser is `denoise` or, with use_pallas_denoiser, the CUDA kernel
`denoise_kernel` (the reference's `denoise_pallas`).  Both have the
reference's per-codeword freeze: once
|tau2_t - tau2_{t-1}| < tol * tau2_t a codeword's state stops changing, and
`iters` counts the iterations it really ran.  Decision-feedback pinning
overrides the pinned sections with sqrt(n P_l) * one_hot after every
denoise (the fused route takes the pins as indices, -1 = unpinned).

Under a ShardingPolicy (parallel/mesh.py) the fused route runs
`amp_fused_sharded` (parallel/amp_sharded.py: the fused kernel per data
shard, or the section-sharded loop on K3).  As in the reference, a policy
takes fused_split but not fused_form: under a policy a "fused_slab" config
runs the form that L routes to (mono at L <= 1024, split above) per data
shard, or the section-sharded loop.  The scan route with one
section shard runs each data shard's slice of the batch on its device,
every shard's constants staged first (`ShardingPolicy.stage`);
with several, its operator's transforms are the collective `dist_fwht`
and the rest of the loop runs on the home device.  Under a data mesh the
AmpResult keeps each data shard's outputs on that shard's device
(`AmpResult.parts`): a caller that needs only the decisions takes them on
each card (`AmpResult.decide`), and beta is gathered only when read.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Optional, Tuple

import torch

from ..ops.amp_kernel import amp_fused
from ..ops.denoiser import denoise, denoise_kernel
from ..ops.operators import BatchedOperator
from ..parallel.amp_sharded import amp_fused_sharded
from ..parallel.mesh import ShardingPolicy
from ..utils.profiling import count


@dataclass(frozen=True)
class AmpResult:
    """Final AMP state: beta (B, L, M), the final posterior-mean estimate;
    tau2_trace (T, B); iters (B,), the iterations each codeword used; the
    posteriors derived from beta on demand.

    Held as `parts`, the (beta, tau2 trace, iters) of each data shard on
    that shard's first device, in shard order: one part without a policy
    or with one data shard, one a data shard on a data mesh (on the
    section-sharded route, beta gathered over each shard's slabs).  A
    field is gathered onto the home device by `policy.gather` when first
    read, and is the part's own tensor with one part.  Beta is 4 L M bytes
    a codeword: a caller that needs only the sectionwise decisions takes
    them with `decide`, on each card, and only (B, L) int32 crosses; while
    tracing, a gather of a whole beta over several parts counts into
    `mesh.beta_gathers`."""
    parts: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    sq_npl: torch.Tensor       # (L,) sqrt(n P_l)
    policy: Optional[ShardingPolicy] = None

    def _whole(self, field: int, dim: int) -> torch.Tensor:
        if len(self.parts) == 1:
            return self.parts[0][field]
        return self.policy.gather([p[field] for p in self.parts], dim)

    @cached_property
    def beta(self) -> torch.Tensor:
        if len(self.parts) > 1:
            count("mesh.beta_gathers", 1)
        return self._whole(0, 0)

    @cached_property
    def tau2_trace(self) -> torch.Tensor:
        return self._whole(1, 1)

    @cached_property
    def iters(self) -> torch.Tensor:
        return self._whole(2, 0)

    @property
    def posteriors(self) -> torch.Tensor:
        """(B, L, M) section posteriors (= beta / sqrt(n P_l))."""
        return self.beta / self.sq_npl[None, :, None]

    def decide(self, fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
        """fn(beta) (B, ...) on the home device, fn a rowwise decision such
        as `hard_indices`: fn of each part's beta on that part's device,
        queued for every part before any copy to the home device (for the
        reason `ShardingPolicy.stage` gives), then the results gathered in
        shard order.  With one part, fn(beta); while tracing, a call over
        several parts counts into `mesh.local_decisions`."""
        out = [fn(p[0]) for p in self.parts]
        if len(out) == 1:
            return out[0]
        count("mesh.local_decisions", 1)
        return self.policy.gather(out, 0)


def fused_route(op: BatchedOperator, L: int) -> bool:
    """Whether amp_decode's fused route (`amp_fused`) can decode with op at
    L sections: op has a row mask (the kernels' support), L <= 4096 and
    M <= 1024.  Only there can a decode take encode_idx or noise_seed."""
    return op.mask is not None and L <= 4096 and op.ML // L <= 1024


def amp_decode(
    y: torch.Tensor,              # (B, n)
    op: BatchedOperator,
    sq_npl: torch.Tensor,         # (L,)
    P: float,
    n: int,
    T: int,
    tol: float = 1e-6,
    tau2_schedule: Optional[torch.Tensor] = None,   # (T,) SE schedule
    pinned_onehot: Optional[torch.Tensor] = None,   # (B, L, M) one-hot targets
    pinned_mask: Optional[torch.Tensor] = None,     # (B, L) bool
    pinned_idx: Optional[torch.Tensor] = None,      # (B, L) int pin targets
                                                    # (instead of onehot)
    residual_space: str = "n",
    fused: bool = False,
    fused_split: Optional[bool] = None,             # amp_fused's split (None:
                                                    # route by L)
    fused_form: Optional[str] = None,               # amp_fused's form ("slab":
                                                    # the slab kernel)
    encode_idx: Optional[torch.Tensor] = None,      # (B, L) int32: y IS the
                                                    # noise, the fused route
                                                    # synthesizes the codeword
    noise_seed: Optional[torch.Tensor] = None,      # (B, 2) int32: the fused
                                                    # route draws the noise
                                                    # too; y is None
    noise_sigma: Optional[float] = None,
    use_pallas_denoiser: bool = False,
    policy: Optional[ShardingPolicy] = None,
) -> AmpResult:
    B = y.shape[0] if noise_seed is None else noise_seed.shape[0]
    L = sq_npl.shape[0]
    ML = op.ML
    M = ML // L

    if fused and fused_route(op, L):
        # schedule mode has no online tau to compare: no early stop there
        k_tol = tol if (tol > 0 and tau2_schedule is None) else 0.0
        pin_idx = None
        if pinned_mask is not None:
            src = (pinned_idx if pinned_idx is not None
                   else pinned_onehot.argmax(-1))
            pin_idx = torch.where(pinned_mask, src.to(torch.int32), -1)
        y_n = None if noise_seed is not None else op.embed_y(y).reshape(
            B, L, M)
        kw = dict(encode_idx=encode_idx, tol=k_tol, pin_idx=pin_idx,
                  tau2_schedule=tau2_schedule, noise_seed=noise_seed,
                  noise_sigma=noise_sigma, split=fused_split)
        if policy is None:
            data = y_n if y_n is not None else noise_seed
            support = (op.split_support(L, M, data.device)
                       if op.split_support is not None else None)
            parts = [amp_fused(
                y_n, op.mask.reshape(L, M), sq_npl, P, n, T, form=fused_form,
                support=support, **kw)]
        else:
            parts = amp_fused_sharded(
                y_n, op.mask.reshape(L, M), sq_npl, P, n, T, policy,
                split_support=op.split_support, **kw)
        return AmpResult(tuple(parts), sq_npl, policy)
    if encode_idx is not None or noise_seed is not None:
        raise ValueError("encode_idx/noise_seed need the fused route "
                         "(fused_route); encode outside amp_decode")
    if (policy is not None and policy.section_shards == 1
            and policy.data_shards > 1):
        # data-parallel scan: each data shard's slice on its device, every
        # shard's constants staged before the first shard's decode
        consts = policy.stage(lambda dev: (
            sq_npl.to(dev),
            None if tau2_schedule is None else tau2_schedule.to(dev)))
        pins = [policy.split_data(p) for p in
                (pinned_onehot, pinned_mask, pinned_idx)]
        parts = []
        for d, ((sq_d, sched_d), y_d) in enumerate(
                zip(consts, policy.split_data(y))):
            parts.append(amp_decode(
                y_d, op, sq_d, P, n, T, tol, sched_d, *(p[d] for p in pins),
                residual_space=residual_space,
                use_pallas_denoiser=use_pallas_denoiser).parts[0])
        return AmpResult(tuple(parts), sq_npl, policy)
    dn = denoise_kernel if use_pallas_denoiser else denoise

    def apply_pin(beta3):
        if pinned_mask is None:
            return beta3
        oh = (pinned_onehot if pinned_onehot is not None
              else torch.nn.functional.one_hot(pinned_idx.to(torch.int64),
                                               M).to(beta3.dtype))
        return torch.where(pinned_mask[:, :, None],
                           sq_npl[None, :, None] * oh, beta3)

    n_space = op.embed_y is not None and residual_space == "N"
    yN = op.embed_y(y) if n_space else None
    dev, dt = y.device, y.dtype
    beta = torch.zeros((B, ML), dtype=dt, device=dev)
    z = torch.zeros((B, op.N) if n_space else y.shape, dtype=dt, device=dev)
    tau2_prev = torch.full((B,), float("inf"), dtype=dt, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    trace = torch.empty((T, B), dtype=dt, device=dev)
    for t in range(T):
        bnorm2 = (beta * beta).sum(-1)
        coef = (P - bnorm2 / n) / tau2_prev            # 0 at t = 0 (inf)
        if n_space:
            z_new = op.resid_n(yN, beta, z, coef[:, None])
        else:
            z_new = y - op.Ax(beta) + z * coef[:, None]
        if tau2_schedule is None:
            tau2 = (z_new * z_new).sum(-1) / n
        else:
            tau2 = torch.full((B,), float(tau2_schedule[t]), dtype=dt,
                              device=dev)
        adj = op.adj_n(z_new) if n_space else op.Ay(z_new)
        beta3, _ = dn((beta + adj).reshape(B, L, M), tau2, sq_npl)
        beta3 = apply_pin(beta3)
        if tau2_schedule is None:
            conv = (tau2 - tau2_prev).abs() < tol * tau2
        else:
            conv = torch.zeros_like(done)
        keep = done[:, None]
        beta = torch.where(keep, beta, beta3.reshape(B, ML))
        z = torch.where(keep, z, z_new)
        tau2_prev = torch.where(done, tau2_prev, tau2)
        iters = iters + (~done).to(torch.int32)
        trace[t] = tau2_prev
        done = done | conv
    return AmpResult(((beta.reshape(B, L, M), trace, iters),), sq_npl)


def hard_indices(scores_or_beta: torch.Tensor) -> torch.Tensor:
    """Sectionwise argmax: (B, L, M) -> (B, L) int32, the first maximum of
    each section, so a row's decision does not depend on the rows beside
    it.  The decisions of an AmpResult that may live on several cards are
    `res.decide(hard_indices)`: each card's rows there, then only the
    indices gathered."""
    return scores_or_beta.argmax(-1).to(torch.int32)


def decision_flips(beta_a, beta_b, rel_margin: float = 2e-2
                   ) -> Tuple[int, int]:
    """Compare the hard decisions of two decodes of the same input.

    Returns (flips, decisive): the sections whose argmax differs, and those
    of them where both sides' top-2 relative margin exceeds rel_margin
    (the rule of the reference's tests/test_precision.py
    assert_decisions_match: bf16 rounding noise may flip near-ties only).
    Computed on beta_a's device."""
    a = torch.as_tensor(beta_a).detach()
    a = a.to(torch.float64)
    b = torch.as_tensor(beta_b).detach().to(a.device, torch.float64)
    mm = a.argmax(-1) != b.argmax(-1)

    def margin(x):
        top2 = x.topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]) / top2[..., 0].clamp(min=1e-30)

    decisive = mm & (margin(a) > rel_margin) & (margin(b) > rel_margin)
    return int(mm.sum()), int(decisive.sum())
