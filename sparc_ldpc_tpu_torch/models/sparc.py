"""SPARC codec pipeline: encode -> channel -> AMP decode -> error counters
(port of sparc_ldpc_tpu/models/sparc.py `SparcModel`).

A model is one SPARC codebook at one operating point, with its constants
on an explicit device.  The design constants (power allocation, the
SE-derived iteration budget, the operator's row set) come from the
port's copy of the reference's NumPy design code (design/), or from
`from_numpy`, which takes them as arrays so that the reference and the
port compute with the same constants.

A block draws its message bits and then either the channel noise
(torch.randn) or, with the config's in-kernel noise, one Philox key per
codeword, from which the fused AMP draws the noise itself (`draw`);
`received` makes its received word and `frame_counters` its counters, for
this model's blocks and the concat chain's (models/concat.py).  The gate
is the reference's, without its backend test: on the CPU the plain
version draws the same noise.  `use_pallas` is the reference's --pallas
route (ops/operators.py).

With a ShardingPolicy (parallel/mesh.py) the model's constants and draws
live on the mesh's home device.  A block's draws are the same whatever the
mesh and the number of processes: every process draws the whole block
from the block's generator and decodes its own rows (`process_rows`),
which `amp_decode` cuts over the data shards of the mesh; the counters are
this process's, which the campaign sums over the processes.  In-kernel
encode and noise need one section shard (a codeword whole on one device),
as in the reference; a section-sharded model encodes with `op.Ax` and
draws its noise with torch.randn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import check_device
from ..config import SparcConfig
from ..design.codebook import DctPlan, HadamardPlan
from ..design.power import power_allocation
from ..design.se import se_converged_iters, se_trajectory
from ..ops.amp_kernel import fused_form
from ..ops.operators import BatchedOperator, make_operator
from ..parallel.mesh import ShardingPolicy
from ..utils.bits import bits_to_indices, indices_to_bits
from ..utils.profiling import annotate
from .amp import AmpResult, amp_decode, fused_route, hard_indices


@dataclass(frozen=True)
class SparcModel:
    cfg: SparcConfig                     # amp_iters is the effective T
    ebno_db: float
    sigma2: float
    p_alloc: np.ndarray                  # (L,) design-time power allocation
    sq_npl: torch.Tensor                 # (L,) sqrt(n P_l), float32
    op: BatchedOperator
    tau2_schedule: Optional[torch.Tensor]  # (T,) when cfg.tau_mode == "se"
    device: torch.device                 # the policy's home device
    use_pallas: bool = False
    policy: Optional[ShardingPolicy] = None

    @staticmethod
    def build(cfg: SparcConfig, ebno_db: float, device,
              use_pallas: bool = False,
              policy: Optional[ShardingPolicy] = None) -> "SparcModel":
        """Design the code at `ebno_db` (as the reference's build does).
        With a policy, device may be None (the policy's home device)."""
        sigma2 = cfg.sigma2(ebno_db)
        p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2, cfg.n,
                             cfg.M, cfg.pa_a, cfg.pa_f)
        if cfg.amp_iters_auto:
            cfg = replace(cfg, amp_iters=se_converged_iters(
                p, cfg.n, cfg.M, sigma2, tol=cfg.amp_auto_tol,
                T_max=cfg.amp_iters, margin=cfg.amp_auto_margin))
        sq = np.sqrt(cfg.n * p).astype(np.float32)
        return SparcModel._make(cfg, ebno_db, sigma2, p, sq, None, device,
                                use_pallas, policy)

    @staticmethod
    def from_numpy(cfg: SparcConfig, ebno_db: float,
                   params: Mapping[str, np.ndarray], device,
                   policy: Optional[ShardingPolicy] = None) -> "SparcModel":
        """A model from constants computed elsewhere.

        params: p_alloc (L,), sq_npl (L,), sigma2 and the effective
        amp_iters; for a Hadamard or DCT operator its rows (n,) and its
        transform size, as the row support mask (N,) or as N, and, where
        the config has column signs (col_signs=True, or the DCT), the
        signs (ML,)."""
        cfg = replace(cfg, amp_iters=int(params["amp_iters"]))
        plan = None
        if cfg.op_kind in ("hadamard", "dct"):
            rows = np.asarray(params["rows"]).astype(np.int32)
            if "mask" in params:
                mask = np.asarray(params["mask"])
                if not np.array_equal(np.flatnonzero(mask), np.sort(rows)):
                    raise ValueError("params['mask'] is not the support of "
                                     "params['rows']")
                N = mask.size
            else:
                N = int(params["N"])
            has_signs = cfg.op_kind == "dct" or cfg.col_signs
            signs = (np.asarray(params["signs"], dtype=np.float64)
                     if has_signs else None)
            kind = HadamardPlan if cfg.op_kind == "hadamard" else DctPlan
            plan = kind(N=N, n=cfg.n, ML=cfg.ML, rows=rows, signs=signs)
        return SparcModel._make(
            cfg, ebno_db, float(params["sigma2"]),
            np.asarray(params["p_alloc"], dtype=np.float64),
            np.asarray(params["sq_npl"], dtype=np.float32), plan, device,
            policy=policy)

    @staticmethod
    def _make(cfg, ebno_db, sigma2, p, sq, plan, device,
              use_pallas=False, policy=None) -> "SparcModel":
        if policy is not None:
            if device is None:
                device = policy.home
            if torch.device(device) != policy.home:
                raise ValueError(f"device {device} is not the policy's home "
                                 f"device {policy.home}")
        device = check_device(device)
        sched = None
        if cfg.tau_mode == "se":
            tr = se_trajectory(p, cfg.n, cfg.M, sigma2, T=cfg.amp_iters)
            tr = np.pad(tr[1:], (0, max(0, cfg.amp_iters - len(tr) + 1)),
                        mode="edge")[: cfg.amp_iters]
            sched = torch.as_tensor(tr, dtype=torch.float32, device=device)
        return SparcModel(
            cfg=cfg, ebno_db=ebno_db, sigma2=sigma2, p_alloc=p,
            sq_npl=torch.tensor(sq, device=device),
            op=make_operator(cfg, device, plan, use_pallas, policy),
            tau2_schedule=sched, device=device, use_pallas=use_pallas,
            policy=policy)

    @property
    def fused(self) -> bool:
        return self.cfg.amp_kernel.startswith("fused")

    @property
    def fused_kw(self) -> dict:
        """amp_decode's fused_split and fused_form for this config, as the
        reference passes them (sparc_ldpc_tpu/models/sparc.py:111-112):
        "fused_split" forces the split form, "fused_slab" asks for the slab
        form, "fused" routes by L (mono at L <= 1024, split above)."""
        k = self.cfg.amp_kernel
        return dict(fused_split=True if k == "fused_split" else None,
                    fused_form="slab" if k == "fused_slab" else None)

    @property
    def enc_in_kernel(self) -> bool:
        """The trial paths encode inside the fused AMP: amp_decode takes
        the fused route (`fused_route`), on one section shard at most."""
        c = self.cfg
        return (self.fused and c.amp_encode_in_kernel
                and (self.policy is None or self.policy.section_shards == 1)
                and fused_route(self.op, c.L))

    @property
    def noise_in_kernel(self) -> bool:
        """The trial paths draw the channel noise inside the fused AMP: the
        in-kernel encode, on the form that takes the noise (`fused_form`
        routes the config's kernel choice; the reference's gate)."""
        k = self.fused_kw
        return (self.enc_in_kernel and self.cfg.amp_noise_in_kernel
                and fused_form(self.cfg.L, k["fused_split"],
                               k["fused_form"]) == "split")

    def draw_seeds(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """(batch, 2) int32 Philox keys (uint32 bit patterns) from gen."""
        return torch.randint(-2 ** 31, 2 ** 31, (batch, 2), generator=gen,
                             dtype=torch.int32, device=self.device)

    def draw(self, gen: torch.Generator, batch: int, width: int):
        """A block's draws from gen: bits (batch, width) {0,1}, then the
        channel noise (batch, n) standard normal or, with the in-kernel
        noise, one Philox key a codeword (`draw_seeds`).  Returns (bits,
        noise, seeds), the one not drawn None."""
        with annotate("block.draw"):
            bits = torch.randint(0, 2, (batch, width), generator=gen,
                                 dtype=torch.int32, device=self.device)
            if self.noise_in_kernel:
                return bits, None, self.draw_seeds(gen, batch)
            return bits, torch.randn((batch, self.cfg.n), generator=gen,
                                     dtype=torch.float32,
                                     device=self.device), None

    # ------------------------------------------------------------ encode

    def build_beta(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, L) indices -> (B, ML) beta = sqrt(n P_l) * one_hot."""
        onehot = torch.nn.functional.one_hot(indices.to(torch.int64),
                                             self.cfg.M).to(torch.float32)
        beta = self.sq_npl[None, :, None] * onehot
        return beta.reshape(indices.shape[0], self.cfg.ML)

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, k_bits) -> (B, n) codewords."""
        return self.op.Ax(self.build_beta(bits_to_indices(bits,
                                                          self.cfg.logM)))

    def channel(self, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        noise = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                            device=x.device)
        return x + noise * math.sqrt(self.sigma2)

    def received(self, idx: torch.Tensor, noise: Optional[torch.Tensor],
                 noise_seed: Optional[torch.Tensor] = None):
        """A block's received word from its true indices idx (B, L) and its
        draws, and the keywords `decode` takes it with: with noise_seed, y
        is None and the fused route synthesizes the codeword A beta0 from
        idx and draws the noise from the seeds; with the in-kernel encode,
        y is the scaled noise and the route synthesizes the codeword; else
        y = A beta0 + sigma noise."""
        sigma = math.sqrt(self.sigma2)
        if noise_seed is not None:
            return None, dict(encode_idx=idx, noise_seed=noise_seed,
                              noise_sigma=sigma)
        if self.enc_in_kernel:
            return noise * sigma, dict(encode_idx=idx)
        return self.op.Ax(self.build_beta(idx)) + noise * sigma, {}

    # ------------------------------------------------------------ decode

    def decode(self, y: Optional[torch.Tensor], T: Optional[int] = None,
               encode_idx: Optional[torch.Tensor] = None,
               pinned_idx: Optional[torch.Tensor] = None,
               pinned_mask: Optional[torch.Tensor] = None,
               pinned_onehot: Optional[torch.Tensor] = None,
               noise_seed: Optional[torch.Tensor] = None,
               noise_sigma: Optional[float] = None) -> AmpResult:
        """AMP decode of y (B, n); with encode_idx, y is the noise and the
        fused route synthesizes the codeword; with noise_seed too, y is None
        and the fused route draws noise_sigma * N(0, 1) itself.  The
        pinned_* arguments are amp_decode's decision-feedback pins."""
        return amp_decode(
            y, self.op, self.sq_npl, self.cfg.P, self.cfg.n,
            T=T or self.cfg.amp_iters, tol=self.cfg.amp_tol,
            tau2_schedule=self.tau2_schedule, pinned_onehot=pinned_onehot,
            pinned_mask=pinned_mask, pinned_idx=pinned_idx,
            residual_space=self.cfg.amp_residual_space, fused=self.fused,
            encode_idx=encode_idx, noise_seed=noise_seed,
            noise_sigma=noise_sigma, use_pallas_denoiser=self.use_pallas,
            policy=self.policy, **self.fused_kw)

    def decode_bits(self, y: torch.Tensor) -> torch.Tensor:
        return indices_to_bits(self.decode(y).decide(hard_indices),
                               self.cfg.logM)

    # ------------------------------------------------------------- trial

    def run_block(self, gen: torch.Generator, batch: int
                  ) -> Dict[str, torch.Tensor]:
        """One Monte-Carlo block of `batch` trials drawn from `gen`."""
        return self._block(*self.draw(gen, batch, self.cfg.k_bits))

    def run_block_from(self, bits, noise) -> Dict[str, torch.Tensor]:
        """run_block on given draws: bits (B, k_bits) {0,1} and standard
        normal noise (B, n), as arrays or tensors."""
        bits = torch.as_tensor(bits, dtype=torch.int32, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32,
                                device=self.device)
        return self._block(bits, noise)

    def _block(self, bits, noise, noise_seed=None
               ) -> Dict[str, torch.Tensor]:
        """One block on given draws: noise (B, n) standard normal, or None
        with noise_seed (B, 2) for the in-kernel noise.  Under a policy,
        this process's rows of them."""
        f = self.frame_counts(bits, noise, noise_seed)
        with annotate("block.counters"):
            return dict(frame_counters(f["bit_errors"]),
                        section_errors=f["section_errors"].sum(),
                        iters_sum=f["iters"].sum(),
                        tau2_final=f["tau2_final"].mean())

    def frame_counts(self, bits, noise, noise_seed=None
                     ) -> Dict[str, torch.Tensor]:
        """A block on given draws decoded as run_block decodes it, frame by
        frame: bit_errors, section_errors and iters (B,), tau2_final (B,).
        noise (B, n) standard normal, or None with noise_seed (B, 2) for
        the in-kernel noise.  Under a policy, this process's rows of
        them."""
        if self.policy is not None:
            bits, noise, noise_seed = self.policy.own_rows(
                bits, noise, noise_seed)
        idx_true = bits_to_indices(bits, self.cfg.logM)
        y, kw = self.received(idx_true, noise, noise_seed)
        res = self.decode(y, **kw)
        with annotate("block.counters"):
            # on each data shard's card: beta stays where AMP left it
            idx_hat = res.decide(hard_indices)
            bits_hat = indices_to_bits(idx_hat, self.cfg.logM)
            return dict(bit_errors=(bits != bits_hat).sum(-1),
                        section_errors=(idx_true != idx_hat).sum(-1),
                        iters=res.iters, tau2_final=res.tau2_trace[-1])


def frame_counters(bit_errors: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A block's frame counters from its per-frame bit errors (B,): their
    sum and sum of squares, the frames with errors, the trials."""
    return dict(
        bit_errors=bit_errors.sum(),
        # bit errors cluster within frames: the frame-level second moment
        # gives honest BER confidence intervals
        bit_errors_sq=(bit_errors.to(torch.float32) ** 2).sum(),
        frame_errors=(bit_errors > 0).sum(),
        # a fill, not a host-to-device copy, which would wait for the
        # stream and stall the campaign's pipelined dispatch
        trials=torch.full((), bit_errors.shape[0], dtype=torch.int32,
                          device=bit_errors.device))


class SparcSweep:
    """A model per Eb/N0 point of a campaign (the reference's SparcSweep).

    The reference shares one jit compilation across points; PyTorch runs
    eagerly, so there is nothing to share and each point builds its own
    model (design constants and operator)."""

    def __init__(self, cfg: SparcConfig, use_pallas: bool = False,
                 device=None, policy: Optional[ShardingPolicy] = None):
        self.cfg = cfg
        self.use_pallas = use_pallas
        self.policy = policy
        self.device = check_device(policy.home if device is None
                                   and policy is not None else device)

    def model_for_point(self, ebno_db: float) -> SparcModel:
        return SparcModel.build(self.cfg, ebno_db, self.device,
                                use_pallas=self.use_pallas,
                                policy=self.policy)
