"""LDPC belief propagation on padded adjacency tables (port of
sparc_ldpc_tpu/ops/bp.py: `BpTables`, `BpResult`, `_phi`, `bp_decode`).

The Tanner graph is stored as padded dense tables (shared
design.ldpc_codes.adjacency):

    check_nbr (m, max_dc): variable index per check slot (+ validity mask)
    var_edge  (n, max_dv): flat check-slot edge id per variable (+ mask)

Flooding schedule; normalized min-sum ("minsum"), offset min-sum ("oms")
or sum-product ("spa"); syndrome early stop as a per-codeword freeze.
For min-sum and offset min-sum every operation is the reference's in the
reference's order (exclusive min from the (min1, min2) pair, sign product
from the parity of the negative count, the incoming messages summed slot
by slot), so the results are bitwise the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..design.ldpc_codes import Adjacency, adjacency


class BpTables(NamedTuple):
    """Static graph tables on one device."""
    check_nbr: torch.Tensor    # (m, max_dc) int64
    check_mask: torch.Tensor   # (m, max_dc) bool
    var_edge: torch.Tensor     # (n, max_dv) int64
    var_mask: torch.Tensor     # (n, max_dv) bool
    n: int
    m: int

    @staticmethod
    def build(code_or_adj, device="cpu") -> "BpTables":
        adj = (code_or_adj if isinstance(code_or_adj, Adjacency)
               else adjacency(code_or_adj.H))

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return BpTables(
            check_nbr=dev(adj.check_nbr, torch.int64),
            check_mask=dev(adj.check_mask, torch.bool),
            var_edge=dev(adj.var_edge, torch.int64),
            var_mask=dev(adj.var_mask, torch.bool),
            n=adj.var_edge.shape[0], m=adj.check_nbr.shape[0])


class BpResult(NamedTuple):
    hard: torch.Tensor        # (B, n) uint8 hard decisions
    posterior: torch.Tensor   # (B, n) total LLRs
    iters: torch.Tensor       # (B,) int32 iterations used
    ok: torch.Tensor          # (B,) bool syndrome satisfied


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor: constants enter the arithmetic rounded to
    float32 once, as the reference's weakly typed scalars do."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log tanh(x/2), self-inverse; clipped for float32."""
    x = x.clamp(1e-7, 40.0)
    return -torch.log(torch.tanh(x * 0.5))


def _sum_slots(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` slot by slot, from zero, in index order."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _check_rule(m_vc, valid, method, alpha, beta, clip, dim):
    """Extrinsic check-node update over the slots on `dim` (valid marks
    the real slots, broadcastable to m_vc): the messages a check sends
    back, clipped, with 0 at the padding slots.  Shared by the edge and
    the QC engines."""
    K = m_vc.shape[dim]
    inf = _f32(float("inf"), m_vc)
    mag = torch.where(valid, m_vc.abs(), inf)
    neg = valid & (m_vc < 0)
    sgn = torch.where(neg, _f32(-1.0, m_vc), _f32(1.0, m_vc))
    n_neg = neg.to(torch.int32).sum(dim, keepdim=True)
    sign_prod = (1 - 2 * (n_neg & 1)).to(m_vc.dtype)
    if method in ("minsum", "oms"):
        min1 = mag.amin(dim, keepdim=True)
        arg1 = mag.argmin(dim, keepdim=True)
        slots = torch.arange(K, device=m_vc.device).reshape(
            [K if d == dim % m_vc.dim() else 1 for d in range(m_vc.dim())])
        min2 = torch.where(slots == arg1, inf, mag).amin(dim, keepdim=True)
        exc = torch.where(mag == min1, min2, min1)
        if method == "oms":
            new_cv = (sign_prod * sgn) * torch.maximum(
                exc - _f32(beta, m_vc), _f32(0.0, m_vc))
        else:
            new_cv = _f32(alpha, m_vc) * (sign_prod * sgn) * exc
    elif method == "spa":
        ph = torch.where(valid, _phi(mag), _f32(0.0, m_vc))
        ph_sum = _sum_slots(ph, dim).unsqueeze(dim)
        new_cv = (sign_prod * sgn) * _phi(torch.maximum(
            ph_sum - ph, _f32(1e-7, m_vc)))
    else:
        raise ValueError(method)
    c = _f32(clip, m_vc)
    return torch.where(valid, torch.clamp(new_cv, -c, c), _f32(0.0, m_vc))


def bp_decode(
    llr: torch.Tensor,              # (B, n) float32
    tables: BpTables,
    iters: int = 64,
    method: str = "minsum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    clip: float = 20.0,
) -> BpResult:
    """Flooding BP over the edge tables (the reference's edge engine)."""
    B = llr.shape[0]
    cn, cmask = tables.check_nbr, tables.check_mask
    ve, vmask = tables.var_edge, tables.var_mask
    m, max_dc = cn.shape
    c = _f32(clip, llr)
    llr = torch.clamp(llr, -c, c)

    def syndrome_ok(tot):
        bits_at = (tot < 0)[:, cn] & cmask[None]            # (B, m, max_dc)
        syn = bits_at.to(torch.int32).sum(-1) % 2            # (B, m)
        return ~(syn != 0).any(-1)

    m_cv = torch.zeros((B, m, max_dc), dtype=llr.dtype, device=llr.device)
    tot = llr
    done = torch.zeros((B,), dtype=torch.bool, device=llr.device)
    it = torch.zeros((B,), dtype=torch.int32, device=llr.device)
    for _ in range(iters):
        # variable -> check (extrinsic): totals gathered at check slots
        m_vc = torch.clamp(tot[:, cn] - m_cv, -c, c)
        new_cv = _check_rule(m_vc, cmask[None], method, alpha, beta, clip,
                             dim=-1)
        # variable totals: check -> variable messages by flat edge id
        incoming = torch.where(vmask[None], new_cv.reshape(B, -1)[:, ve],
                               _f32(0.0, llr))               # (B, n, max_dv)
        new_tot = llr + _sum_slots(incoming, -1)
        ok = syndrome_ok(new_tot)
        m_cv = torch.where(done[:, None, None], m_cv, new_cv)
        tot = torch.where(done[:, None], tot, new_tot)
        it = it + (~done).to(torch.int32)
        done = done | ok
    return BpResult(hard=(tot < 0).to(torch.uint8), posterior=tot, iters=it,
                    ok=done)
