"""The outer LDPC code and its decoder, worked out again.

Frozen copies of the code's definition and of the layered min-sum decoder:

- a QC code: a (J, K) base of circulant shifts, -1 for a zero block; block
  (j, l) of H is the Z x Z identity rolled right by its shift.  The base is
  the configuration's `qc_base` (Z and the shifts, as the standard's table
  gives them), or for the array code (a prime Z) the shift j l mod Z;
- its systematic encoder: Gauss-Jordan over GF(2) walking the columns in
  order, the first row at or below the current one as pivot, rows swapped,
  the pivot column swapped into place (columns and permutation alike);
  G = [P^T | I_k] in the permuted order, placed back in the original
  column order; the message bits sit at the original columns perm[rank:];
- normalized min-sum, row-layered: LLRs clipped to +-clip; per iteration
  each block row j in turn reads the variable totals at its check
  coordinates (variable zv = (zc + s) mod Z of check zc), forms
  m_vc = clip(total - m_cv), the check rule alpha * sign * (the least
  magnitude but one's own: min2 where |m_vc| equals min1, else min1; the
  first slot holding min1 is the one whose min2 excludes itself), over the
  layer's nonzero blocks alone, clipped, zero on its zero blocks (which
  read and write the totals through the identity, so they only clip
  them), and writes total = m_vc + m_cv_new back; a codeword whose hard
  decisions satisfy every check stops (its iterations counted up to and
  including that one).
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch


def qc_H(shifts: np.ndarray, Z: int) -> np.ndarray:
    eye = np.eye(Z, dtype=np.uint8)
    zero = np.zeros((Z, Z), dtype=np.uint8)
    return np.block([[np.roll(eye, int(s), axis=1) if s >= 0 else zero
                      for s in row] for row in shifts]).astype(np.uint8)


def base(cfg: Dict) -> Tuple[np.ndarray, int]:
    """(shifts (J, K), Z) of the configured code."""
    if cfg["kind"] == "array":
        J, K, Z = cfg["rows_b"], cfg["cols_b"], cfg["z"]
        return (np.arange(J)[:, None] * np.arange(K)[None, :]) % Z, Z
    if cfg["kind"] == "qc":
        q = cfg["qc_base"]
        return np.asarray(q["shifts"], dtype=np.int64), int(q["Z"])
    raise ValueError("the reference holds QC codes only")


def systematic(H: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(G (k, n) uint8, message positions (k,)) of H."""
    Hr = H.copy().astype(np.uint8)
    m, n = Hr.shape
    perm = np.arange(n)
    r = 0
    for col in range(n):
        if r >= m:
            break
        pivs = np.nonzero(Hr[r:, col])[0]
        if pivs.size == 0:
            continue
        p = pivs[0] + r
        if p != r:
            Hr[[r, p]] = Hr[[p, r]]
        rows = Hr[:, col].astype(bool)
        rows[r] = False
        Hr[rows] ^= Hr[r]
        if col != r:
            Hr[:, [r, col]] = Hr[:, [col, r]]
            perm[[r, col]] = perm[[col, r]]
        r += 1
    k = n - r
    G_perm = np.concatenate([Hr[:r, r:].T, np.eye(k, dtype=np.uint8)], 1)
    G = np.zeros((k, n), dtype=np.uint8)
    G[:, perm] = G_perm
    if np.any((G.astype(np.int64) @ H.T.astype(np.int64)) % 2):
        raise AssertionError("G H^T != 0")
    return G, perm[r:].copy()


class Code:
    """The code on a device: encoder and the decoder's circulant tables."""

    def __init__(self, cfg: Dict, device):
        shifts, Z = base(cfg)
        J, K = shifts.shape
        H = qc_H(shifts, Z)
        G, msg = systematic(H)
        self.J, self.K, self.Z = J, K, Z
        self.n, self.k = H.shape[1], G.shape[0]
        self.G = torch.as_tensor(G, dtype=torch.float64, device=device)
        self.msg = torch.as_tensor(msg, dtype=torch.int64, device=device)
        active = shifts >= 0
        s = torch.as_tensor(np.where(active, shifts, 0), device=device)
        self.active = torch.as_tensor(active, device=device)   # (J, K)
        zc = torch.arange(Z, device=device)
        self.fwd = (zc[None, None, :] + s[:, :, None]) % Z     # (J, K, Z)
        self.back = (zc[None, None, :] - s[:, :, None]) % Z
        self.alpha = float(cfg["alpha"])
        self.clip = float(cfg["llr_clip"])
        self.iters = int(cfg["bp_iters"])
        if cfg["decoder"] != "minsum" or cfg["schedule"] != "layered":
            raise ValueError("the reference decodes layered min-sum only")

    def on(self, device) -> "Code":
        other = copy.copy(self)
        for name in ("G", "msg", "fwd", "back", "active"):
            setattr(other, name, getattr(self, name).to(device))
        return other

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """(N, k) {0,1} -> (N, n) int32 codewords (exact in float64)."""
        return (torch.matmul(u.to(torch.float64), self.G).to(torch.int64)
                % 2).to(torch.int32)

    def _syndrome_ok(self, tot: torch.Tensor) -> torch.Tensor:
        hard = (tot < 0).to(torch.int32)                         # (N, K, Z)
        at = torch.take_along_dim(hard[:, None], self.fwd[None], -1)
        at = at * self.active[None, :, :, None]
        return ~((at.sum(2) & 1) != 0).any(-1).any(-1)

    def _check(self, m_vc: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
        """Normalized min-sum over the K slots (dim 1) of (N, K, Z), over
        the slots `on` (K,) alone, zero on the others."""
        K = m_vc.shape[1]
        on = on.reshape(1, K, 1)
        mag = torch.where(on, m_vc.abs(), torch.inf)
        neg = on & (m_vc < 0)
        par = (neg.to(torch.int32).sum(1, keepdim=True) & 1)
        sign = (1 - 2 * par).to(torch.float32) * torch.where(neg, -1.0, 1.0)
        min1 = mag.amin(1, keepdim=True)
        arg1 = mag.argmin(1, keepdim=True)
        slots = torch.arange(K, device=m_vc.device).reshape(1, K, 1)
        min2 = torch.where(slots == arg1, torch.inf, mag).amin(1,
                                                               keepdim=True)
        exc = torch.where(mag == min1, min2, min1)
        new = torch.tensor(self.alpha, dtype=torch.float32) * sign * exc
        return torch.where(on, torch.clamp(new, -self.clip, self.clip), 0.0)

    def decode(self, llr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """llr (N, n) float32 -> hard (N, n) uint8, ok (N,) bool, iters
        (N,) int32."""
        N = llr.shape[0]
        c = self.clip
        tot = torch.clamp(llr, -c, c).reshape(N, self.K, self.Z)
        m_cv = torch.zeros((N, self.J, self.K, self.Z), dtype=torch.float32,
                           device=llr.device)
        done = torch.zeros((N,), dtype=torch.bool, device=llr.device)
        it = torch.zeros((N,), dtype=torch.int32, device=llr.device)
        for _ in range(self.iters):
            new_cv = m_cv.clone()
            new_tot = tot
            for j in range(self.J):
                at = torch.take_along_dim(new_tot, self.fwd[None, j], -1)
                m_vc = torch.clamp(at - new_cv[:, j], -c, c)
                upd = self._check(m_vc, self.active[j])
                new_tot = torch.take_along_dim(m_vc + upd, self.back[None, j],
                                               -1)
                new_cv[:, j] = upd
            ok = self._syndrome_ok(new_tot)
            m_cv = torch.where(done[:, None, None, None], m_cv, new_cv)
            tot = torch.where(done[:, None, None], tot, new_tot)
            it += (~done).to(torch.int32)
            done = done | ok
        flat = tot.reshape(N, self.n)
        return dict(hard=(flat < 0).to(torch.uint8), ok=done, iters=it)
