"""The port's own copy of sparc_ldpc_tpu/design/power.py, identical in
classes, defaults and numerics (tests/test_torch_config.py holds the
two equal).

Power allocation across SPARC sections (SURVEY.md App. A.2, §2 #4-5).

Kinds:
  flat:       P_l = P / L.
  exp:        P_l ∝ 2^{-2 C l / L}  (capacity-achieving asymptotically).
  modified:   P_l ∝ 2^{-2 a C l / L} for l <= f L, constant for l > f L;
              (a, f) either given or grid-searched to minimize the
              SE-predicted residual power (equivalently maximize decoded
              fraction at the SE fixed point).
  iterative:  greedy SE-driven allocation: walking the sections in blocks,
              each block gets the minimum power that keeps state evolution
              progressing past it; leftover power is spread flat
              (Greig-Venkataramanan-style finite-length design; validated
              against SE decodability rather than the unreadable reference —
              SURVEY.md §0.4, App. A.2).

All functions return a (L,) float64 array summing exactly to P.
"""

from __future__ import annotations

import math

import numpy as np

from .se import se_trajectory, se_x

__all__ = ["power_allocation", "flat_alloc", "exp_alloc", "modified_alloc",
           "iterative_alloc"]


def _capacity(P: float, sigma2: float) -> float:
    return 0.5 * math.log2(1.0 + P / sigma2)


def flat_alloc(L: int, P: float) -> np.ndarray:
    return np.full(L, P / L, dtype=np.float64)


def exp_alloc(L: int, P: float, sigma2: float) -> np.ndarray:
    C = _capacity(P, sigma2)
    l = np.arange(L, dtype=np.float64)
    p = np.power(2.0, -2.0 * C * l / L)
    return P * p / p.sum()


def modified_alloc(L: int, P: float, sigma2: float, a: float, f: float) -> np.ndarray:
    C = _capacity(P, sigma2)
    l = np.arange(L, dtype=np.float64)
    cut = int(round(f * L))
    p = np.empty(L, dtype=np.float64)
    p[:cut] = np.power(2.0, -2.0 * a * C * l[:cut] / L)
    p[cut:] = np.power(2.0, -2.0 * a * C * cut / L) if cut > 0 else 1.0
    return P * p / p.sum()


def _se_residual(p: np.ndarray, n: int, M: int, sigma2: float,
                 n_samples: int, seed: int) -> float:
    """SE fixed-point residual power P*(1-x) — lower is better decodability."""
    trace = se_trajectory(p, n, M, sigma2, T=64, n_samples=n_samples, seed=seed)
    return float(trace[-1] - sigma2)


def optimize_modified(L: int, P: float, sigma2: float, n: int, M: int,
                      n_samples: int = 2048, seed: int = 0,
                      na: int = 8, nf: int = 7):
    """Grid-search (a, f) minimizing the SE residual (App. A.2 'tuned')."""
    best = (None, None, np.inf)
    for a in np.linspace(0.5, 1.2, na):
        for f in np.linspace(0.4, 1.0, nf):
            p = modified_alloc(L, P, sigma2, float(a), float(f))
            r = _se_residual(p, n, M, sigma2, n_samples, seed)
            if r < best[2]:
                best = (float(a), float(f), r)
    a, f, _ = best
    return modified_alloc(L, P, sigma2, a, f), a, f


def iterative_alloc(L: int, P: float, sigma2: float, n: int, M: int,
                    n_blocks: int = 32, margin: float = 1.12,
                    n_samples: int = 2048, seed: int = 0) -> np.ndarray:
    """Greedy SE-driven allocation (App. A.2 'iterative').

    Blocks of sections are visited in order.  Under AMP, a section with power
    P_l decodes once nu^2 = n P_l / tau2 exceeds ~2 ln M; each block is
    assigned that minimum power (x margin) at the tau2 the SE predicts when
    the block's turn comes.  If the remaining budget spread flat over the
    remaining sections already exceeds the requirement, everything left is
    allocated flat and the loop stops (the flat tail decodes on its own).
    """
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_samples, M))
    logM = int(round(math.log2(M)))
    edges = np.linspace(0, L, n_blocks + 1).astype(int)
    p = np.zeros(L, dtype=np.float64)
    remaining = P
    tau2 = sigma2 + P
    for b in range(n_blocks):
        lo, hi = edges[b], edges[b + 1]
        if hi <= lo:
            continue
        n_left = L - lo
        flat_share = remaining / n_left
        req = margin * 2.0 * math.log(2.0) * logM * tau2 / n
        if flat_share >= req:
            # flat tail suffices for all remaining sections
            p[lo:] = flat_share
            remaining = 0.0
            break
        take = min(req, remaining / (hi - lo))
        p[lo:hi] = take
        remaining -= take * (hi - lo)
        # advance SE one step with the partial allocation (unallocated tail
        # treated as flat-share of what is left, an optimistic preview)
        preview = p.copy()
        if hi < L and remaining > 0:
            preview[hi:] = remaining / (L - hi)
        x = se_x(tau2, preview, n, M, U)
        tau2 = sigma2 + P * (1.0 - x)
    if remaining > 1e-12:
        p += remaining / L
    # normalize away float drift; the sum must be exactly P
    p *= P / p.sum()
    return p


_PA_CACHE: dict = {}


def power_allocation(kind: str, L: int, P: float, sigma2: float, n: int,
                     M: int, a=None, f=None, seed: int = 0) -> np.ndarray:
    """Dispatch per SparcConfig.power_alloc (SURVEY.md §2 #4-5).

    Results are memoized: the SE-driven kinds cost seconds at L=1024+ and
    campaigns rebuild the model per sweep point.
    """
    key = (kind, L, P, round(float(sigma2), 14), n, M, a, f, seed)
    hit = _PA_CACHE.get(key)
    if hit is not None:
        return hit
    out = _power_allocation(kind, L, P, sigma2, n, M, a, f, seed)
    _PA_CACHE[key] = out
    return out


def _power_allocation(kind: str, L: int, P: float, sigma2: float, n: int,
                      M: int, a=None, f=None, seed: int = 0) -> np.ndarray:
    if kind == "flat":
        return flat_alloc(L, P)
    if kind == "exp":
        return exp_alloc(L, P, sigma2)
    if kind == "modified":
        if a is not None and f is not None:
            return modified_alloc(L, P, sigma2, a, f)
        p, _, _ = optimize_modified(L, P, sigma2, n, M, seed=seed)
        return p
    if kind == "iterative":
        return iterative_alloc(L, P, sigma2, n, M, seed=seed)
    raise ValueError(f"unknown power allocation kind {kind!r}")
