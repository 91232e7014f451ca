"""The port's own copy of sparc_ldpc_tpu/design/se.py, identical in
classes, defaults and numerics (tests/test_torch_config.py holds the
two equal).

State evolution for SPARC-AMP (SURVEY.md App. A.5, §2 #7).

The scalar recursion predicting the AMP effective-noise trajectory:

    tau2_0    = sigma2 + P
    tau2_{t+1} = sigma2 + P * (1 - x(tau2_t))

with the expected fraction of power decoded

    x(tau2) = sum_l (P_l / P) * E[ exp(nu_l (U_1 + nu_l))
                / ( exp(nu_l (U_1 + nu_l)) + sum_{j=2}^M exp(nu_l U_j) ) ],
    nu_l = sqrt(n P_l) / tau,   U_j iid N(0,1).

Two evaluation backends (SURVEY.md App. A.5 names both):

  - "mc":   vectorized Monte-Carlo with common random numbers (same U draws
    shared across sections and across tau values within one design run),
    which makes the PA search in power.py smooth.  Exact in expectation.
  - "quad": deterministic quadrature via the exact Laplace-transform
    identity  E[e^A/(e^A+S)] = int_0^inf E[e^A e^{-t e^A}] * phi(t)^{M-1} dt
    with A = nu(U_1+nu) independent of S = sum_{j>=2} exp(nu U_j) and
    phi(t) = E[exp(-t e^{nu U})]; both inner expectations are 1D Hermite
    rules and the t-integral is a trapezoid in u = log t.  No distributional
    approximation of S (a log-normal moment match was tried first and is off
    by ~0.17 at mid nu).  Sample-noise-free, so PA searches are perfectly
    smooth; agreement vs MC is tested to within MC sampling error
    (tests/test_design.py).

Also provides the deterministic hard-decision section-error predictor
P[argmax wrong] = 1 - E[Phi(U + nu)^{M-1}] (1D Hermite rule, exact up to
quadrature error) — the SE-based BER prediction used to sanity-check
campaign curves without Monte-Carlo.

float64 host-side NumPy.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erf

__all__ = ["se_section_success", "se_x", "se_trajectory",
           "se_section_success_quad", "se_section_error_rate"]


def _phi_cdf(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + erf(x / np.sqrt(2.0)))


def _hermgauss_prob(n_nodes: int):
    """Hermite nodes/weights recast for E_{U~N(0,1)}[f(U)] = sum w f(x)."""
    x, w = np.polynomial.hermite.hermgauss(n_nodes)
    return x * np.sqrt(2.0), w / np.sqrt(np.pi)


def _logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))).squeeze(axis)


def se_section_success(nu: np.ndarray, U: np.ndarray) -> np.ndarray:
    """E-hat[success prob] per nu value, sharing the sample matrix U.

    Args:
      nu: (K,) array of nu = sqrt(n P_l)/tau values.
      U: (S, M) standard-normal samples (S Monte-Carlo draws).
    Returns: (K,) estimated posterior mass on the true column.
    """
    nu = np.atleast_1d(np.asarray(nu, dtype=np.float64))
    out = np.empty(nu.shape[0], dtype=np.float64)
    U1 = U[:, 0]          # (S,)
    Urest = U[:, 1:]      # (S, M-1)
    # chunk over nu to bound memory at (chunk, S, M-1)
    chunk = max(1, int(2e7 // max(1, U.size)))
    for i in range(0, nu.shape[0], chunk):
        nv = nu[i:i + chunk][:, None]                       # (c, 1)
        true_score = nv * (U1[None, :] + nv)                # (c, S)
        rest = _logsumexp(nv[:, :, None] * Urest[None, :, :], axis=2)  # (c, S)
        # success = sigmoid(true_score - logsumexp(rest))
        d = true_score - rest
        out[i:i + chunk] = np.mean(np.where(d > 0,
                                            1.0 / (1.0 + np.exp(-d)),
                                            np.exp(d) / (1.0 + np.exp(d))),
                                   axis=1)
    return out


def se_section_success_quad(nu: np.ndarray, M: int,
                            n_nodes: int = 96) -> np.ndarray:
    """Deterministic Gauss-Hermite evaluation of the softmax success mass.

    Uses 1/(e^A+S) = int_0^inf e^{-t(e^A+S)} dt with A = nu(U1+nu)
    independent of S = sum_{j=2}^M exp(nu U_j), so

      E[e^A/(e^A+S)] = int  t*g(t) * phi(t)^(M-1)  d(log t),
      t*g(t) = E_U[ exp(w - e^w) ],  w = nu(U+nu) + log t      (Gumbel bump)
      phi(t) = E_U[ exp(-t e^{nu U}) ]

    — exact up to Hermite (inner) and trapezoid (outer) quadrature error.
    Degenerates to 1/M at nu -> 0 and to ~1 at nu -> inf.
    """
    nu = np.atleast_1d(np.asarray(nu, dtype=np.float64))
    x1, w1 = _hermgauss_prob(n_nodes)
    out = np.empty(nu.shape[0], dtype=np.float64)
    for i, v in enumerate(nu):
        if v < 1e-12:
            out[i] = 1.0 / M
            continue
        a = v * (x1 + v)                 # (Q,) true-column log scores
        b = v * x1                       # (Q,) rival-column exponents
        # t*g(t) has Gumbel bumps at u = -a_i (width O(1)); phi^{M-1} cuts
        # the integrand above u_c ~ -log(M-1) - v^2/2 + O(1).
        u_c = -np.log(max(M - 1, 1)) - v * v / 2.0
        u_lo = -float(np.max(a)) - 12.0
        u_hi = max(min(-float(np.min(a)), u_c), u_lo) + 15.0
        n_u = max(400, int((u_hi - u_lo) / 0.15))
        u = np.linspace(u_lo, u_hi, n_u)                 # (Nu,)
        wa = np.minimum(a[:, None] + u[None, :], 50.0)   # (Q, Nu)
        tg = w1 @ np.exp(wa - np.exp(wa))                # (Nu,)
        wb = np.minimum(b[:, None] + u[None, :], 50.0)
        phi = np.clip(w1 @ np.exp(-np.exp(wb)), 1e-300, 1.0)
        out[i] = float(np.trapezoid(tg * np.exp((M - 1) * np.log(phi)), u))
    return out


def se_x(tau2: float, p_alloc: np.ndarray, n: int, M: int,
         U: np.ndarray = None, method: str = "mc",
         n_nodes: int = 96) -> float:
    """x(tau2): expected decoded power fraction (SURVEY.md App. A.5)."""
    P = float(np.sum(p_alloc))
    nu = np.sqrt(n * p_alloc) / np.sqrt(tau2)
    # dedupe nu values (flat PA -> 1 unique; exp PA -> many but cheap anyway)
    uniq, inv = np.unique(nu, return_inverse=True)
    if method == "mc":
        succ = se_section_success(uniq, U)[inv]
    elif method == "quad":
        succ = se_section_success_quad(uniq, M, n_nodes=n_nodes)[inv]
    else:
        raise ValueError(f"unknown se method {method!r}")
    return float(np.sum((p_alloc / P) * succ))


def se_section_error_rate(p_alloc: np.ndarray, n: int, tau2: float, M: int,
                          n_nodes: int = 128) -> np.ndarray:
    """Per-section hard-decision error probability at effective noise tau2.

    P[argmax wrong] = 1 - E_U[ Phi(U + nu_l)^{M-1} ],  nu_l = sqrt(n P_l)/tau
    (the true column's score nu(U+nu) must beat M-1 iid nu*N(0,1) rivals;
    scale-invariant in nu, so reduces to the unit-variance form).  Exact up
    to Hermite quadrature error — the deterministic SE-based BER predictor
    for campaign sanity checks (SURVEY.md §4.3).
    """
    nu = np.sqrt(n * np.asarray(p_alloc, dtype=np.float64) / tau2)
    x1, w1 = _hermgauss_prob(n_nodes)
    cdf = _phi_cdf(x1[None, :] + nu[:, None])            # (L, Q)
    # log-domain power for numerical safety at large M
    succ = np.exp(np.log(np.clip(cdf, 1e-300, 1.0)) * (M - 1)) @ w1
    return 1.0 - succ


def se_trajectory(p_alloc: np.ndarray, n: int, M: int, sigma2: float,
                  T: int = 64, tol: float = 1e-7, n_samples: int = 4096,
                  seed: int = 0, method: str = "mc") -> np.ndarray:
    """Iterate SE; returns the tau2 trace (length <= T+1, includes tau2_0).

    Stops early when |tau2_{t+1} - tau2_t| < tol * tau2_t.
    method: "mc" (common-random-numbers Monte-Carlo) or "quad"
    (deterministic Gauss-Hermite, see se_section_success_quad).
    """
    U = None
    if method == "mc":
        rng = np.random.default_rng(seed)
        U = rng.standard_normal((n_samples, M))
    P = float(np.sum(p_alloc))
    tau2 = sigma2 + P
    trace = [tau2]
    for _ in range(T):
        x = se_x(tau2, p_alloc, n, M, U, method=method)
        new = sigma2 + P * (1.0 - x)
        trace.append(new)
        if abs(new - tau2) < tol * tau2:
            break
        tau2 = new
    return np.asarray(trace)


def se_converged_iters(p_alloc: np.ndarray, n: int, M: int, sigma2: float,
                       tol: float = 1e-4, T_max: int = 64, margin: int = 2,
                       method: str = "quad") -> int:
    """SE-predicted AMP iteration budget for one operating point
    (SURVEY.md §7 hard-part 4: sweep batches are SNR-homogeneous, so the
    per-point budget can come from the deterministic SE recursion instead
    of a global worst-case T).

    Returns the first t with |tau2_t - tau2_{t-1}| < tol * tau2_t, plus a
    safety margin, capped at T_max.  At the flagship point (L=1024, M=512,
    R=1, 2 dB) SE plateaus at t~20 (tol 1e-4) and on-chip section-error
    counts are flat from T=20 through T=32 (docs/PERF.md round-2 table),
    so tol=1e-4 + margin 2 is conservative.  method="quad" (the exact
    Laplace-transform quadrature) is the default: deterministic and ~20x
    cheaper than MC (1.5 s vs 30 s per point at L=1024 — the host-side SE
    cost lands on every sweep point when amp_iters_auto is on); plateau
    indices agree with MC to +-1 across the pa_l1024 grid.
    """
    trace = se_trajectory(p_alloc, n, M, sigma2, T=T_max, tol=tol,
                          method=method)
    # se_trajectory stops at the first plateau step; its length already is
    # the convergence index + 1 (trace includes tau2_0).
    return min(int(len(trace) - 1 + margin), T_max)
