"""QC-LDPC belief propagation on circulant-structured message tensors
(port of sparc_ldpc_tpu/ops/bp_qc.py: `QcBpTables`, `_check_rule`,
`_syndrome_ok`, `bp_decode_qc`).

For a QC code with base matrix S in {-1, 0..Z-1}^{J x K} (-1 = zero block,
s >= 0 = identity circulant shifted by s) messages live on a dense
(B, J, K, Z) tensor and all edge routing is two gathers along the Z axis:
check coordinate zc <-> variable coordinate zv = (zc + s) mod Z.

Two schedules, as in the reference:
  - "flooding": all check rows update at once (the edge engine's
    messages on the same graph);
  - "layered": block rows one after the other within an iteration, the
    variable totals updated after each layer.  Zero blocks go through a
    zero-message identity round trip, so the totals are clipped at every
    (layer, zero block).

The layered engine is the plain version of the hand-written kernel
(ops/bp_qc_kernel.py, csrc/bp_qc_layered.cu).  For min-sum and offset
min-sum it is bitwise the reference's XLA engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bp import BpResult, _check_rule, _f32, _sum_slots


class QcBpTables(NamedTuple):
    """Static circulant structure on one device.

    gather_cv (J, K, Z) int64: variable z-index seen from check slot zc,
      i.e. (zc + shift) mod Z (identity for zero blocks).
    gather_vc (J, K, Z) int64: inverse map, (zv - shift) mod Z.
    block_mask (J, K) bool: active circulant blocks.
    """
    gather_cv: torch.Tensor
    gather_vc: torch.Tensor
    block_mask: torch.Tensor
    Z: int
    J: int
    K: int

    @staticmethod
    def build(shifts: np.ndarray, Z: int, device="cpu") -> "QcBpTables":
        shifts = np.asarray(shifts, dtype=np.int64)
        J, K = shifts.shape
        active = shifts >= 0
        s = np.where(active, shifts, 0)
        zc = np.arange(Z)
        gcv = (zc[None, None, :] + s[:, :, None]) % Z
        gvc = (zc[None, None, :] - s[:, :, None]) % Z
        return QcBpTables(
            gather_cv=torch.as_tensor(gcv, device=device),
            gather_vc=torch.as_tensor(gvc, device=device),
            block_mask=torch.as_tensor(active, device=device),
            Z=int(Z), J=int(J), K=int(K))

    @property
    def n(self) -> int:
        return self.K * self.Z

    @property
    def m(self) -> int:
        return self.J * self.Z


def _gather_z(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x gathered at idx along the last (Z) axis; x and idx broadcast."""
    return torch.take_along_dim(x, idx, dim=-1)


def _syndrome_ok(tot: torch.Tensor, t: QcBpTables) -> torch.Tensor:
    hard = (tot < 0).to(torch.int32)                      # (B, K, Z)
    bits_at = _gather_z(hard[:, None], t.gather_cv[None])  # (B, J, K, Z)
    bits_at = torch.where(t.block_mask[None, :, :, None], bits_at, 0)
    syn = bits_at.sum(2) & 1                              # (B, J, Z)
    return ~(syn != 0).any(-1).any(-1)


def bp_decode_qc(
    llr: torch.Tensor,              # (B, n), n = K*Z, variable order k*Z+zv
    tables: QcBpTables,
    iters: int = 64,
    method: str = "minsum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    clip: float = 20.0,
    schedule: str = "flooding",
) -> BpResult:
    t = tables
    B = llr.shape[0]
    c = _f32(clip, llr)
    llr = torch.clamp(llr, -c, c).reshape(B, t.K, t.Z)
    bmask4 = t.block_mask[None, :, :, None]               # (1, J, K, 1)
    zero = _f32(0.0, llr)

    if schedule == "flooding":
        def step(m_cv, tot):
            m_vc = torch.clamp(_gather_z(tot[:, None], t.gather_cv[None])
                               - m_cv, -c, c)              # (B, J, K, Z)
            new_cv = _check_rule(m_vc, bmask4, method, alpha, beta, clip,
                                 dim=2)
            incoming = torch.where(bmask4, _gather_z(new_cv,
                                                     t.gather_vc[None]), zero)
            return new_cv, llr + _sum_slots(incoming, 1)  # (B, K, Z)
    elif schedule == "layered":
        # per block row j: read the current totals at the layer's check
        # coordinates, form the extrinsic messages, update the layer's
        # check messages and write the refreshed totals straight back
        # (each circulant is a permutation, so the write is the inverse
        # gather)
        def step(m_cv, tot):
            m_cv = m_cv.clone()
            for j in range(t.J):
                bm = bmask4[:, j]                          # (1, K, 1)
                tot_at = _gather_z(tot, t.gather_cv[None, j])
                m_vc = torch.clamp(tot_at - m_cv[:, j], -c, c)
                new_cv = _check_rule(m_vc, bm, method, alpha, beta, clip,
                                     dim=1)
                tot = _gather_z(m_vc + new_cv, t.gather_vc[None, j])
                m_cv[:, j] = new_cv
            return m_cv, tot
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    m_cv = torch.zeros((B, t.J, t.K, t.Z), dtype=llr.dtype,
                       device=llr.device)
    tot = llr
    done = torch.zeros((B,), dtype=torch.bool, device=llr.device)
    it = torch.zeros((B,), dtype=torch.int32, device=llr.device)
    for _ in range(iters):
        new_cv, new_tot = step(m_cv, tot)
        ok = _syndrome_ok(new_tot, t)
        m_cv = torch.where(done[:, None, None, None], m_cv, new_cv)
        tot = torch.where(done[:, None, None], tot, new_tot)
        it = it + (~done).to(torch.int32)
        done = done | ok
    tot_flat = tot.reshape(B, t.n)
    return BpResult(hard=(tot_flat < 0).to(torch.uint8), posterior=tot_flat,
                    iters=it, ok=done)
