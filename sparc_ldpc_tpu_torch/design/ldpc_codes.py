"""The port's own copy of sparc_ldpc_tpu/design/ldpc_codes.py, identical in
classes, defaults and numerics (tests/test_torch_config.py holds the
two equal).

LDPC code construction + systematic encoder derivation (host-side NumPy).

SURVEY.md §2 #16-17, App. A.6.  The reference's exact code identity is
unverifiable (SURVEY.md §0, K-low), so codes are pluggable:

  - "array":   deterministic array-code QC-LDPC: for prime circulant size Z
               and base shape (J, K), block (j, l) is the identity circulant
               shifted by (j*l mod Z).  Girth >= 6, fully parameterized,
               reproducible with no data files.
  - "regular": seeded (dv, dc)-regular Gallager-style construction with
               column-permuted stacked blocks, 4-cycle reduction pass.
  - "alist":   standard alist text format loader.
  - "qc":      generic QC-LDPC from a base-matrix text file (first line Z,
               then J rows of K shifts, -1 = zero block) — the format
               standard codes (802.11n/802.16e families, SURVEY.md §2 #16)
               are published in.

Codes with circulant structure ("array", "qc") additionally expose their
(J, K) shift matrix via `qc_structure`, enabling the roll-based BP engine
(ops.bp_qc) and its layered schedule.

The parity-check matrix H is reduced host-side (GF(2) Gauss-Jordan with
column pivoting) to derive a systematic generator G; both the NumPy oracle
and the TPU path encode with the same G and decode on the same H.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import LdpcConfig


@dataclass
class LdpcCode:
    """A concrete binary LDPC code.

    Attributes:
      H: (m, n) uint8 parity-check matrix.
      G: (k, n) uint8 systematic-form generator with G H^T = 0; the first k
        positions of a codeword (after `perm`) are the message bits.
      perm: (n,) column permutation applied to H to reach systematic form;
        codewords produced by G are in the *original* column order.
      k, n, m: dimensions (k = n - rank(H)).
    """
    H: np.ndarray
    G: np.ndarray
    perm: np.ndarray
    k: int
    n: int
    m: int

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """(..., k) -> (..., n) systematic encode in the original order."""
        return (bits.astype(np.uint8) @ self.G) % 2

    def syndrome(self, word: np.ndarray) -> np.ndarray:
        return (word.astype(np.uint8) @ self.H.T) % 2

    @property
    def message_positions(self) -> np.ndarray:
        """Indices (into original column order) carrying the message bits."""
        return self.perm[: self.k]


def _gf2_row_reduce(H: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Gauss-Jordan over GF(2) with column swaps.

    Returns (Hr, perm, rank) with Hr[:, perm] in reduced form
    [I_rank | X] over the pivot rows.
    """
    H = H.copy().astype(np.uint8)
    m, n = H.shape
    perm = np.arange(n)
    r = 0
    for col in range(n):
        if r >= m:
            break
        # find pivot in column `col` (after current perm) at/below row r
        pivs = np.nonzero(H[r:, col])[0]
        if pivs.size == 0:
            continue
        p = pivs[0] + r
        if p != r:
            H[[r, p]] = H[[p, r]]
        # eliminate all other rows
        mask = H[:, col].astype(bool)
        mask[r] = False
        H[mask] ^= H[r]
        # move pivot column into position r via permutation bookkeeping
        if col != r:
            H[:, [r, col]] = H[:, [col, r]]
            perm[[r, col]] = perm[[col, r]]
        r += 1
    return H, perm, r


def systematize(H: np.ndarray) -> LdpcCode:
    """Derive a systematic generator from H (App. A.6 encoder).

    After reduction, H_perm = [I_m' | P] (m' = rank); codewords satisfy
    H_perm c_perm = 0, so with message u in the last k coords,
    c_perm = [P u ; u].  We place message bits at perm[m':] and parity at
    perm[:m'], then undo the permutation.
    """
    Hr, perm, rank = _gf2_row_reduce(H)
    m, n = H.shape
    k = n - rank
    P = Hr[:rank, rank:]                      # (rank, k)
    # G_perm = [P^T | I_k] : (k, n) in permuted order
    G_perm = np.concatenate([P.T, np.eye(k, dtype=np.uint8)], axis=1)
    G = np.zeros((k, n), dtype=np.uint8)
    G[:, perm] = G_perm
    # message bits live at original columns perm[rank:]
    msg_perm = np.concatenate([perm[rank:], perm[:rank]])
    code = LdpcCode(H=H.astype(np.uint8), G=G, perm=msg_perm, k=k, n=n, m=m)
    assert not np.any((G @ H.T) % 2), "G H^T != 0"
    return code


# ------------------------------------------------------------ constructions

def array_code_H(J: int, K: int, Z: int) -> np.ndarray:
    """Array/QC-LDPC: H = [[ I^{jl mod Z} ]] for j<J, l<K; Z prime."""
    for d in range(2, int(Z ** 0.5) + 1):
        if Z % d == 0:
            raise ValueError(f"Z={Z} must be prime for the array construction")
    I = np.eye(Z, dtype=np.uint8)
    blocks = [[np.roll(I, (j * l) % Z, axis=1) for l in range(K)]
              for j in range(J)]
    return np.block(blocks).astype(np.uint8)


def regular_code_H(n: int, dv: int, dc: int, seed: int = 0) -> np.ndarray:
    """Seeded Gallager-style (dv, dc)-regular H with a 4-cycle reduction pass."""
    assert (n * dv) % dc == 0, "n*dv must be divisible by dc"
    m = n * dv // dc
    rng = np.random.default_rng(np.random.SeedSequence([0x1D9C, seed]))
    # Gallager construction: dv stacked permuted copies of a base partition
    base = np.zeros((m // dv, n), dtype=np.uint8)
    for i in range(m // dv):
        base[i, i * dc:(i + 1) * dc] = 1
    rows = [base]
    for _ in range(dv - 1):
        rows.append(base[:, rng.permutation(n)])
    H = np.concatenate(rows, axis=0)
    # 4-cycle reduction: re-draw columns involved in length-4 cycles
    for _ in range(10):
        corr = (H @ H.T)
        np.fill_diagonal(corr, 0)
        bad = np.argwhere(corr >= 2)
        if bad.size == 0:
            break
        for r1, r2 in bad[: len(bad) // 2]:
            cols = np.nonzero(H[r1] & H[r2])[0]
            if cols.size >= 2:
                c = cols[0]
                # move one edge of (r2, c) to a random low-degree column
                H[r2, c] = 0
                tgt = rng.integers(0, n)
                H[r2, tgt] ^= 1
    return H


def qc_base_H(shifts: np.ndarray, Z: int) -> np.ndarray:
    """Expand a (J, K) circulant-shift base matrix into dense binary H.

    shift s >= 0 -> np.roll(I_Z, s, axis=1) (row zc has its one at column
    (zc + s) mod Z, matching ops.bp_qc's gather convention); s == -1 ->
    zero block.
    """
    shifts = np.asarray(shifts, dtype=np.int64)
    J, K = shifts.shape
    I = np.eye(Z, dtype=np.uint8)
    zero = np.zeros((Z, Z), dtype=np.uint8)
    blocks = [[np.roll(I, int(s), axis=1) if s >= 0 else zero
               for s in row] for row in shifts]
    return np.block(blocks).astype(np.uint8)


# Checked-in standard base matrices (SURVEY.md §2 #16: "default to a
# standard QC-LDPC (e.g. 802.11n/802.16e family)").  Resolved by name via
# LdpcConfig(kind="qc", path="wifi_n648_r12") — bare names map into the
# package data dir; real filesystem paths still work.
STANDARD_CODES = ("wifi_n648_r12", "wifi_n1296_r12", "wifi_n1944_r12")
# Higher-rate codes in the same 802.11n structure (dual-diagonal parity +
# anchor column) with CONSTRUCTED girth-aware shifts — not standard-table
# transcriptions (scripts/gen_qc_codes.py documents why and what is
# verified instead).
CONSTRUCTED_CODES = ("qc_n648_r23", "qc_n648_r34", "qc_n648_r56")


def _resolve_qc_path(path: str) -> str:
    import os
    if os.path.exists(path):
        return path
    name = path[:-3] if path.endswith(".qc") else path
    cand = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "data", name + ".qc")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(
        f"QC base matrix {path!r} not found (known codes: "
        f"{', '.join(STANDARD_CODES + CONSTRUCTED_CODES)})")


def load_qc_base(path: str) -> Tuple[np.ndarray, int]:
    """Parse a QC base-matrix file: line 1 = Z, then J rows of K shifts.

    `path` may be a filesystem path or the bare name of a checked-in
    standard code (STANDARD_CODES)."""
    path = _resolve_qc_path(path)
    with open(path) as f:
        lines = [ln.split() for ln in f
                 if ln.strip() and not ln.lstrip().startswith("#")]
    Z = int(lines[0][0])
    shifts = np.array([[int(t) for t in row] for row in lines[1:]],
                      dtype=np.int64)
    if np.any(shifts >= Z):
        raise ValueError(f"shift >= Z={Z} in {path}")
    return shifts, Z


def qc_structure(cfg: LdpcConfig) -> Optional[Tuple[np.ndarray, int]]:
    """(shifts, Z) when the configured code is quasi-cyclic, else None."""
    if cfg.kind == "array":
        j = np.arange(cfg.rows_b)[:, None]
        l = np.arange(cfg.cols_b)[None, :]
        return (j * l) % cfg.z, cfg.z
    if cfg.kind == "qc":
        return load_qc_base(cfg.path)
    return None


def load_alist(path: str) -> np.ndarray:
    """Standard alist format -> dense uint8 H.

    Handles both padded (every column line carries max_dv entries, zeros as
    filler — the MacKay convention) and unpadded per-line variants by
    parsing line-wise rather than as a flat token stream.
    """
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    n, m = int(lines[0][0]), int(lines[0][1])
    H = np.zeros((m, n), dtype=np.uint8)
    # lines[1] = max degrees, lines[2] = per-col degs, lines[3] = per-row degs
    col_lines = lines[4:4 + n]
    for v, toks in enumerate(col_lines):
        for t in toks:
            c = int(t)
            if c > 0:
                H[c - 1, v] = 1
    return H


def build_code(cfg: LdpcConfig) -> LdpcCode:
    if cfg.kind == "array":
        H = array_code_H(cfg.rows_b, cfg.cols_b, cfg.z)
    elif cfg.kind == "regular":
        H = regular_code_H(cfg.n_bits, cfg.dv, cfg.dc, cfg.seed)
    elif cfg.kind == "alist":
        H = load_alist(cfg.path)
    elif cfg.kind == "qc":
        H = qc_base_H(*load_qc_base(cfg.path))
    else:
        raise ValueError(cfg.kind)
    return systematize(H)


# ------------------------------------------------- adjacency (decoder-side)

@dataclass
class Adjacency:
    """Padded dense adjacency for TPU-friendly flooding BP (SURVEY.md §7
    hard-part 3: static-shape gathers instead of irregular segment ops).

    check_nbr: (m, max_dc) variable index per check slot, padded with 0.
    check_mask: (m, max_dc) validity.
    var_edge: (n, max_dv) flat edge id (= c*max_dc + slot) of each variable's
      incident edges, padded with 0.
    var_mask: (n, max_dv) validity.
    """
    check_nbr: np.ndarray
    check_mask: np.ndarray
    var_edge: np.ndarray
    var_mask: np.ndarray
    max_dc: int
    max_dv: int


def adjacency(H: np.ndarray) -> Adjacency:
    m, n = H.shape
    dc = H.sum(axis=1).astype(int)
    dv = H.sum(axis=0).astype(int)
    max_dc, max_dv = int(dc.max()), int(dv.max())
    check_nbr = np.zeros((m, max_dc), dtype=np.int32)
    check_mask = np.zeros((m, max_dc), dtype=bool)
    var_edge = np.zeros((n, max_dv), dtype=np.int32)
    var_mask = np.zeros((n, max_dv), dtype=bool)
    vslot = np.zeros(n, dtype=int)
    for c in range(m):
        vs = np.nonzero(H[c])[0]
        check_nbr[c, : len(vs)] = vs
        check_mask[c, : len(vs)] = True
        for s, v in enumerate(vs):
            var_edge[v, vslot[v]] = c * max_dc + s
            var_mask[v, vslot[v]] = True
            vslot[v] += 1
    return Adjacency(check_nbr=check_nbr, check_mask=check_mask,
                     var_edge=var_edge, var_mask=var_mask,
                     max_dc=max_dc, max_dv=max_dv)
