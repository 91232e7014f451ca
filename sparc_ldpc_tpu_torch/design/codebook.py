"""The port's own copy of sparc_ldpc_tpu/design/codebook.py, identical in
classes, defaults and numerics (tests/test_torch_config.py holds the
two equal).

Measurement-operator index sets derived from SparcConfig (host-side).

The operator *definition* — transform size N, the seeded random row subset,
optional column sign flips — is part of the code, so the NumPy oracle and the
TPU path must derive identical sets from the same config (SURVEY.md App. A.3;
§4.1 parity requires it).  Only the *application* of the operator differs per
backend.

Construction (pyfht-lineage shape, SURVEY.md §2 #9):
  N    = 2^ceil(log2(max(n + 1, M*L)))         (power-of-two transform size)
  rows = seeded uniform random distinct subset of [1, N), |rows| = n, sorted
         (row 0 — the all-ones Walsh row — excluded; sorting is part of the
         definition and improves gather locality on TPU).
  cols = the first M*L natural columns (identity embedding when ML == N).
         With a random row subset, restricted Walsh columns are
         exchangeable, so a random column subset adds nothing while a natural
         one keeps the TPU embedding gather-free and sharding-friendly.
  signs (optional) = seeded Rademacher diagonal applied to columns.

Scaling: A = H_N[rows, :ML] / sqrt(n) gives exactly unit-norm columns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class HadamardPlan(NamedTuple):
    N: int
    n: int
    ML: int
    rows: np.ndarray            # (n,) int32, sorted, in [1, N)
    signs: Optional[np.ndarray]  # (ML,) float {-1,+1} or None


def hadamard_plan(n: int, ML: int, seed: int, col_signs: bool = False) -> HadamardPlan:
    N = 1 << max(int(np.ceil(np.log2(max(n + 1, ML)))), 1)
    rng = np.random.default_rng(np.random.SeedSequence([0x51A2C, seed]))
    rows = np.sort(rng.choice(N - 1, size=n, replace=False).astype(np.int64) + 1)
    signs = None
    if col_signs:
        signs = rng.integers(0, 2, size=ML).astype(np.float64) * 2.0 - 1.0
    return HadamardPlan(N=N, n=n, ML=ML, rows=rows.astype(np.int32), signs=signs)


class DctPlan(NamedTuple):
    N: int
    n: int
    ML: int
    rows: np.ndarray
    signs: Optional[np.ndarray]


def dct_plan(n: int, ML: int, seed: int, col_signs: bool = True) -> DctPlan:
    """Subsampled orthonormal DCT-II plan (SURVEY.md App. A.3).

    Row 0 (the DC row, ∝ all-ones) is excluded like the Hadamard case.  For
    the DCT, column sign randomization defaults ON: unlike restricted Walsh
    columns, natural DCT columns restricted to fixed rows are not
    exchangeable, and the Rademacher diagonal restores the sub-Gaussian
    column ensemble AMP assumes.
    """
    N = 1 << max(int(np.ceil(np.log2(max(n + 1, ML)))), 1)
    rng = np.random.default_rng(np.random.SeedSequence([0xDC7, seed]))
    rows = np.sort(rng.choice(N - 1, size=n, replace=False).astype(np.int64) + 1)
    signs = None
    if col_signs:
        signs = rng.integers(0, 2, size=ML).astype(np.float64) * 2.0 - 1.0
    return DctPlan(N=N, n=n, ML=ML, rows=rows.astype(np.int32), signs=signs)
