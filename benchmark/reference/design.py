"""The code's design constants, worked out again from the configuration
(host-side NumPy, float64).

Frozen copies of the definitions the program builds its code from:

- n = round(L log2(M) / R) channel uses; sigma2 = P / (2 (L log2 M / n)
  Eb/N0);
- the operator's rows: N = 2^ceil(log2(max(n + 1, M L))), n distinct rows
  of [1, N) drawn by numpy's default_rng(SeedSequence([0x51A2C, op_seed]))
  `choice(N - 1, n, replace=False) + 1`, sorted; row r is element
  (r // M, r % M) of the (L, M) tile, and the transform is H_L (x) H_M;
- the "iterative" power allocation (Greig & Venkataramanan, arXiv:
  1705.02091, in the program's greedy block form): 32 blocks of sections,
  each given margin 1.12 times 2 ln(2) log2(M) tau2 / n at the tau2 that
  state evolution predicts when its turn comes, a flat tail once the
  remaining power spread flat suffices;
- state evolution, by Monte-Carlo on common draws (the allocation) and by
  the Laplace-transform quadrature (the iteration budget);
- the SE-derived iteration budget: the first plateau within tol 1e-4 of
  the quadrature recursion, plus a margin of 2, capped at T.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def code_length(cfg: Dict) -> int:
    logM = int(cfg["M"]).bit_length() - 1
    return int(round(cfg["L"] * logM / cfg["R"]))


def sigma2(cfg: Dict, ebno_db: float) -> float:
    logM = int(cfg["M"]).bit_length() - 1
    rate = cfg["L"] * logM / code_length(cfg)
    return cfg["P"] / (2.0 * rate * 10.0 ** (ebno_db / 10.0))


def operator_rows(n: int, ML: int, seed: int) -> np.ndarray:
    N = 1 << max(int(np.ceil(np.log2(max(n + 1, ML)))), 1)
    rng = np.random.default_rng(np.random.SeedSequence([0x51A2C, seed]))
    return np.sort(rng.choice(N - 1, size=n, replace=False).astype(np.int64)
                   + 1)


def row_mask(cfg: Dict) -> np.ndarray:
    """(L, M) float32 0/1: the operator's rows on the (L, M) tile."""
    L, M = cfg["L"], cfg["M"]
    rows = operator_rows(code_length(cfg), L * M, cfg["op_seed"])
    if rows.max() >= L * M:
        raise ValueError("the reference takes codes whose transform size is "
                         "M L")
    mask = np.zeros(L * M, dtype=np.float32)
    mask[rows] = 1.0
    return mask.reshape(L, M)


# ------------------------------------------------------- state evolution

def _logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(a - m), axis=axis,
                              keepdims=True))).squeeze(axis)


def success_mc(nu: np.ndarray, U: np.ndarray) -> np.ndarray:
    """Mean softmax mass on the true column at each nu, on draws U (S, M)."""
    nu = np.atleast_1d(np.asarray(nu, dtype=np.float64))
    out = np.empty(nu.shape[0], dtype=np.float64)
    U1, rest = U[:, 0], U[:, 1:]
    chunk = max(1, int(2e7 // max(1, U.size)))
    for i in range(0, nu.shape[0], chunk):
        v = nu[i:i + chunk][:, None]
        d = v * (U1[None, :] + v) - _logsumexp(
            v[:, :, None] * rest[None, :, :], axis=2)
        out[i:i + chunk] = np.mean(np.where(d > 0, 1.0 / (1.0 + np.exp(-d)),
                                            np.exp(d) / (1.0 + np.exp(d))),
                                   axis=1)
    return out


def _hermite(n_nodes: int):
    x, w = np.polynomial.hermite.hermgauss(n_nodes)
    return x * np.sqrt(2.0), w / np.sqrt(np.pi)


def success_quad(nu: np.ndarray, M: int, n_nodes: int = 96) -> np.ndarray:
    """The same mass by E[e^A / (e^A + S)] = int t g(t) phi(t)^(M-1)
    d(log t), each inner expectation a Hermite rule, the outer integral a
    trapezoid in log t."""
    nu = np.atleast_1d(np.asarray(nu, dtype=np.float64))
    x1, w1 = _hermite(n_nodes)
    out = np.empty(nu.shape[0], dtype=np.float64)
    for i, v in enumerate(nu):
        if v < 1e-12:
            out[i] = 1.0 / M
            continue
        a = v * (x1 + v)
        b = v * x1
        u_c = -np.log(max(M - 1, 1)) - v * v / 2.0
        u_lo = -float(np.max(a)) - 12.0
        u_hi = max(min(-float(np.min(a)), u_c), u_lo) + 15.0
        u = np.linspace(u_lo, u_hi, max(400, int((u_hi - u_lo) / 0.15)))
        wa = np.minimum(a[:, None] + u[None, :], 50.0)
        tg = w1 @ np.exp(wa - np.exp(wa))
        wb = np.minimum(b[:, None] + u[None, :], 50.0)
        phi = np.clip(w1 @ np.exp(-np.exp(wb)), 1e-300, 1.0)
        out[i] = float(np.trapezoid(tg * np.exp((M - 1) * np.log(phi)), u))
    return out


def decoded_fraction(tau2: float, p: np.ndarray, n: int, M: int,
                     U=None) -> float:
    """x(tau2): the power-weighted mean success mass (Monte-Carlo on U, or
    the quadrature when U is None)."""
    nu = np.sqrt(n * p) / np.sqrt(tau2)
    uniq, inv = np.unique(nu, return_inverse=True)
    succ = (success_mc(uniq, U) if U is not None
            else success_quad(uniq, M))[inv]
    return float(np.sum((p / np.sum(p)) * succ))


def se_plateau(p: np.ndarray, n: int, M: int, s2: float, T: int,
               tol: float) -> int:
    """Steps of the quadrature recursion tau2 <- s2 + P (1 - x(tau2)) until
    the first step that moves tau2 by less than tol tau2 (at most T)."""
    P = float(np.sum(p))
    tau2 = s2 + P
    for t in range(1, T + 1):
        new = s2 + P * (1.0 - decoded_fraction(tau2, p, n, M))
        if abs(new - tau2) < tol * tau2:
            return t
        tau2 = new
    return T


def iterative_power(L: int, P: float, s2: float, n: int, M: int,
                    n_blocks: int = 32, margin: float = 1.12,
                    n_samples: int = 2048, seed: int = 0) -> np.ndarray:
    U = np.random.default_rng(seed).standard_normal((n_samples, M))
    logM = int(round(math.log2(M)))
    edges = np.linspace(0, L, n_blocks + 1).astype(int)
    p = np.zeros(L, dtype=np.float64)
    remaining = P
    tau2 = s2 + P
    for b in range(n_blocks):
        lo, hi = edges[b], edges[b + 1]
        if hi <= lo:
            continue
        flat_share = remaining / (L - lo)
        req = margin * 2.0 * math.log(2.0) * logM * tau2 / n
        if flat_share >= req:
            p[lo:] = flat_share
            remaining = 0.0
            break
        take = min(req, remaining / (hi - lo))
        p[lo:hi] = take
        remaining -= take * (hi - lo)
        preview = p.copy()
        if hi < L and remaining > 0:
            preview[hi:] = remaining / (L - hi)
        tau2 = s2 + P * (1.0 - decoded_fraction(tau2, preview, n, M, U))
    if remaining > 1e-12:
        p += remaining / L
    return p * (P / p.sum())


def power(cfg: Dict, s2: float) -> np.ndarray:
    L, P = cfg["L"], cfg["P"]
    if cfg["power_alloc"] == "flat":
        return np.full(L, P / L, dtype=np.float64)
    if cfg["power_alloc"] != "iterative":
        raise ValueError(f"the reference has no {cfg['power_alloc']!r} "
                         f"power allocation")
    return iterative_power(L, P, s2, code_length(cfg), cfg["M"])


def iterations(cfg: Dict, p: np.ndarray, s2: float) -> int:
    """The AMP iterations a codeword may run: the SE-derived budget where
    the configuration asks for one, else amp_iters."""
    T = int(cfg["amp_iters"])
    if not cfg.get("amp_iters_auto", False):
        return T
    t = se_plateau(p, code_length(cfg), cfg["M"], s2, T,
                   cfg.get("amp_auto_tol", 1e-4))
    return min(t + cfg.get("amp_auto_margin", 2), T)
