"""Concatenated SPARC + LDPC pipeline (port of
sparc_ldpc_tpu/models/concat.py `ConcatModel`).

Section partition: the first Lu sections are unprotected; the last Lp carry
LDPC codeword bits (num_cw codewords back to back), with
num_cw * ldpc.n == Lp * logM exactly.

Decode chain:
  1. AMP -> final beta (= sq_npl * section posteriors);
  2. bitwise LLRs over the protected sections by pair-fold sums over beta
     (the per-section scale cancels);
  3. BP (models.ldpc: on the GPU, layered min-sum on the hand-written
     kernel); a codeword whose syndrome fails falls back to the channel
     hard decision;
  4. decision feedback: AMP again with the sections of syndrome-verified
     codewords pinned to their decoded indices;
  5. user bits: the unprotected sections' argmax from the feedback pass
     and the LDPC message bits.

A block's draws, its received word and its frame counters are the inner
SPARC model's (`SparcModel.draw`, `SparcModel.received`,
`frame_counters`).  Both AMP passes take the received word with the same
keywords: with the config's in-kernel noise the same Philox key per frame,
so the pinned feedback pass's kernel regenerates exactly the noise the
main pass decoded (as it re-synthesizes the same codeword from the same
true indices).
`ConcatSweep` builds a model per Eb/N0 point; the reference's staged
s1/s2/s3 runner exists for its JIT compile times and has no counterpart
here (the campaign takes `run_block`).

Under a ShardingPolicy the inner SPARC model carries it: both AMP passes
run over the mesh (per data shard, or section-sharded with the pins cut
by section), each process decodes its rows of the block (the inner
model's `process_rows`), and the fold and BP run on the gathered beta on
the home device (sections are whole on every shard, so the fold is the
same function per slab or gathered).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import check_device
from ..config import ConcatConfig
from ..utils.bits import bits_to_indices, indices_to_bits
from ..utils.profiling import annotate, count
from .amp import hard_indices
from .ldpc import LdpcModel
from .sparc import SparcModel, frame_counters


def _derive_partition(L: int, logM: int, ldpc_n: int, f_prot: float
                      ) -> Tuple[int, int, int]:
    """(Lu, Lp, num_cw) with num_cw * ldpc_n == Lp * logM exactly."""
    target_bits = int(round(f_prot * L)) * logM
    num_cw = target_bits // ldpc_n
    while num_cw > 0 and (num_cw * ldpc_n) % logM != 0:
        num_cw -= 1
    if num_cw == 0:
        raise ValueError(
            f"cannot fit an LDPC codeword (n={ldpc_n}) into "
            f"{target_bits} protected bits with logM={logM}")
    Lp = (num_cw * ldpc_n) // logM
    return L - Lp, Lp, num_cw


@dataclass(frozen=True)
class ConcatModel:
    """SPARC inner code + LDPC outer code at one operating point."""
    cfg: ConcatConfig
    sparc: SparcModel
    ldpc: LdpcModel
    Lu: int                  # unprotected sections
    Lp: int                  # protected sections
    num_cw: int              # LDPC codewords per SPARC frame

    @staticmethod
    def build(cfg: ConcatConfig, ebno_db: float, device,
              use_pallas: bool = False, policy=None) -> "ConcatModel":
        return ConcatModel._make(cfg, SparcModel.build(
            cfg.sparc, ebno_db, device, use_pallas=use_pallas,
            policy=policy))

    @staticmethod
    def from_numpy(cfg: ConcatConfig, ebno_db: float,
                   sparc_params: Mapping[str, np.ndarray],
                   device) -> "ConcatModel":
        """A model whose inner code takes constants computed elsewhere
        (SparcModel.from_numpy); the LDPC code is built from the config by
        the design code (design/ldpc_codes.py)."""
        return ConcatModel._make(cfg, SparcModel.from_numpy(
            cfg.sparc, ebno_db, sparc_params, device))

    @staticmethod
    def _make(cfg: ConcatConfig, sparc: SparcModel) -> "ConcatModel":
        ldpc = LdpcModel.build(cfg.ldpc, sparc.device)
        Lu, Lp, num_cw = _derive_partition(
            cfg.sparc.L, cfg.sparc.logM, ldpc.n, cfg.f_prot)
        return ConcatModel(cfg=cfg, sparc=sparc, ldpc=ldpc, Lu=Lu, Lp=Lp,
                           num_cw=num_cw)

    @property
    def device(self) -> torch.device:
        return self.sparc.device

    @property
    def k_user(self) -> int:
        """User payload bits per frame (unprotected + LDPC messages)."""
        return self.Lu * self.cfg.sparc.logM + self.num_cw * self.ldpc.k

    @property
    def overall_rate(self) -> float:
        return self.k_user / self.sparc.cfg.n

    # ------------------------------------------------------------ encode

    def encode(self, user_bits: torch.Tensor) -> torch.Tensor:
        """(B, k_user) -> (B, n) channel codewords."""
        idx = self._true_indices(user_bits)
        return self.sparc.op.Ax(self.sparc.build_beta(idx))

    def _true_indices(self, user_bits: torch.Tensor) -> torch.Tensor:
        """(B, k_user) -> (B, L) true section indices: the unprotected bits,
        then the LDPC codewords of the message bits, packed MSB first."""
        B = user_bits.shape[0]
        logM = self.cfg.sparc.logM
        nu = self.Lu * logM
        unprot = user_bits[:, :nu].to(torch.int32)
        msgs = user_bits[:, nu:].reshape(B * self.num_cw, self.ldpc.k)
        cw = self.ldpc.encode(msgs).reshape(B, self.num_cw * self.ldpc.n)
        return bits_to_indices(torch.cat([unprot, cw], dim=1), logM)

    # ------------------------------------------------------------ decode

    def _protected_llrs(self, scores: torch.Tensor) -> torch.Tensor:
        """Log-posterior scores (B, L, M) -> bitwise LLRs (B, Lp*logM) of
        the protected sections (exp once, then the pair fold)."""
        a = scores[:, self.Lu:, :]
        return self._llr_fold(torch.exp(a - a.amax(-1, keepdim=True)))

    def _llr_fold(self, w: torch.Tensor) -> torch.Tensor:
        """(B, Lp, M) nonnegative section weights -> (B, Lp*logM) LLRs.

        llr_b = log sum_{bit_b(j)=0} w_j - log sum_{bit_b(j)=1} w_j; any
        per-section scale cancels.  Folding index pairs level by level (LSB
        first) gives every bit's two sums in about 3M adds; bit b of the
        MSB-first convention is LSB level logM-1-b.  Sums are floored at
        float32 tiny before the log.  The reference's TPU flushes
        subnormals, so a bit-set whose whole mass is subnormal sums to 0
        there; a GPU keeps the subnormal, and the same floor takes both to
        tiny, so the two agree."""
        B = w.shape[0]
        logM = self.cfg.sparc.logM
        s0 = [None] * logM
        s1 = [None] * logM
        cur = w
        for k in range(logM):                               # fold LSB up
            cur = cur.reshape(B, self.Lp, -1, 2)
            p0, p1 = cur[..., 0], cur[..., 1]
            s0[logM - 1 - k] = p0.sum(-1)
            s1[logM - 1 - k] = p1.sum(-1)
            cur = p0 + p1
        tiny = torch.finfo(torch.float32).tiny
        llr = (torch.log(torch.stack(s0, -1).clamp_min(tiny))
               - torch.log(torch.stack(s1, -1).clamp_min(tiny)))
        return llr.reshape(B, self.Lp * logM)

    def _protected_llrs_from_beta(self, beta: torch.Tensor) -> torch.Tensor:
        """(B, L, M) final AMP beta -> (B, Lp*logM) LLRs: beta_l is
        sq_npl[l] * posterior_l and the scale cancels in the fold."""
        with annotate("concat.fold"):
            return self._llr_fold(beta[:, self.Lu:, :])

    def _bp_from_beta(self, beta: torch.Tensor):
        return self._bp_from_llr(self._protected_llrs_from_beta(beta))

    def _bp_from_llr(self, llr: torch.Tensor):
        """LLRs (B, Lp*logM) -> (cw_hat (B, num_cw*n) uint8, ok
        (B, num_cw) bool, BP iterations (B, num_cw))."""
        B = llr.shape[0]
        llr = llr.reshape(B * self.num_cw, self.ldpc.n)
        bp = self.ldpc.decode(llr)
        # BP that fails the syndrome check can be worse than the channel:
        # fall back to the channel hard decision per codeword
        chan_hard = (llr < 0).to(torch.uint8)
        cw_bits = torch.where(bp.ok[:, None], bp.hard, chan_hard)
        cw_hat = cw_bits.reshape(B, self.num_cw * self.ldpc.n)
        return cw_hat, bp.ok.reshape(B, self.num_cw), bp.iters.reshape(B, -1)

    def _feedback_user_bits(self, y: Optional[torch.Tensor],
                            cw_hat: torch.Tensor, ok: torch.Tensor,
                            enc_idx: Optional[torch.Tensor] = None,
                            noise_kw: Optional[dict] = None
                            ) -> torch.Tensor:
        """Pinned AMP again -> assembled user bits (B, k_user) int32.

        Only sections whose bits all come from syndrome-verified codewords
        are pinned: pinning a wrongly decoded codeword poisons the second
        pass.  noise_kw (noise_seed, noise_sigma) must be the main pass's,
        so that the kernel draws the same noise again (y is then None).
        While tracing, the pass's iterations count into
        `concat.feedback_iters`."""
        with annotate("concat.feedback"):
            B = cw_hat.shape[0]
            logM = self.cfg.sparc.logM
            dev = cw_hat.device
            prot_idx = bits_to_indices(cw_hat, logM)             # (B, Lp)
            bit_ok = ok.repeat_interleave(self.ldpc.n, dim=1)  # (B, Lp*logM)
            sec_ok = bit_ok.reshape(B, self.Lp, logM).all(-1)
            pin_mask = torch.cat(
                [torch.zeros((B, self.Lu), dtype=torch.bool, device=dev),
                 sec_ok], dim=1)
            full_idx = torch.cat(
                [torch.zeros((B, self.Lu), dtype=torch.int32, device=dev),
                 prot_idx], dim=1)
            res2 = self.sparc.decode(
                y, T=self.cfg.feedback_iters, pinned_idx=full_idx,
                pinned_mask=pin_mask, encode_idx=enc_idx, **(noise_kw or {}))
            count("concat.feedback_iters", res2.iters)
            unprot_bits = indices_to_bits(
                hard_indices(res2.beta)[:, :self.Lu], logM)
            msg_bits = self.ldpc.extract_message(
                cw_hat.reshape(B * self.num_cw, self.ldpc.n)
            ).reshape(B, self.num_cw * self.ldpc.k)
            return torch.cat([unprot_bits, msg_bits.to(torch.int32)], dim=1)

    def decode(self, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full concatenated decode of observations y (B, n)."""
        res, out = self._decode(y)
        return dict(out, tau2_final=res.tau2_trace[-1])

    def _decode(self, y: Optional[torch.Tensor],
                encode_idx: Optional[torch.Tensor] = None, **noise_kw):
        """The chain on a received word and its decode keywords
        (`SparcModel.received`): AMP, the fold and BP, then the pinned pass
        with the same keywords.  Returns the first pass's AmpResult and
        dict(user_bits, bp_ok, amp_iters, bp_iters)."""
        res = self.sparc.decode(y, encode_idx=encode_idx, **noise_kw)
        cw_hat, ok, bp_iters = self._bp_from_beta(res.beta)
        user_hat = self._feedback_user_bits(y, cw_hat, ok, enc_idx=encode_idx,
                                            noise_kw=noise_kw)
        return res, dict(user_bits=user_hat, bp_ok=ok, amp_iters=res.iters,
                         bp_iters=bp_iters)

    # ------------------------------------------------------------- trial

    def run_block(self, gen: torch.Generator, batch: int
                  ) -> Dict[str, torch.Tensor]:
        """One Monte-Carlo block of `batch` frames drawn from `gen`."""
        return self._block(*self.sparc.draw(gen, batch, self.k_user))

    def run_block_from(self, bits, noise) -> Dict[str, torch.Tensor]:
        """run_block on given draws: user bits (B, k_user) {0,1} and
        standard normal noise (B, n), as arrays or tensors."""
        bits = torch.as_tensor(bits, dtype=torch.int32, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32,
                                device=self.device)
        return self._block(bits, noise)

    def _block(self, bits, noise, noise_seed=None
               ) -> Dict[str, torch.Tensor]:
        """One block on given draws: noise (B, n) standard normal, or None
        with noise_seed (B, 2) for the in-kernel noise.  Under a policy,
        this process's rows of them."""
        if self.sparc.policy is not None:
            bits, noise, noise_seed = self.sparc.policy.own_rows(
                bits, noise, noise_seed)
        y, kw = self.sparc.received(self._true_indices(bits), noise,
                                    noise_seed)
        _, out = self._decode(y, **kw)
        with annotate("block.counters"):
            return dict(frame_counters((bits != out["user_bits"]).sum(-1)),
                        bp_ok=out["bp_ok"].sum(),
                        iters_sum=out["amp_iters"].sum())


class ConcatSweep:
    """A model per Eb/N0 point of a campaign (the reference's ConcatSweep,
    which shares its staged jit compilations across points; PyTorch runs
    eagerly, so each point builds its own model)."""

    def __init__(self, cfg: ConcatConfig, use_pallas: bool = False,
                 device=None, policy=None):
        self.cfg = cfg
        self.use_pallas = use_pallas
        self.policy = policy
        self.device = check_device(policy.home if device is None
                                   and policy is not None else device)

    def model_for_point(self, ebno_db: float) -> ConcatModel:
        return ConcatModel.build(self.cfg, ebno_db, self.device,
                                 use_pallas=self.use_pallas,
                                 policy=self.policy)
