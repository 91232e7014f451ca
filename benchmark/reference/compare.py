"""The numbers that hold a block's outputs to the reference's.

Both sides decode the same draws; the program computes with its own
rounding, so frames near the decoding threshold may end apart, and each
number is a share that sound runs keep small and a broken or lower-
precision decode does not.  All are over the frames of the checked blocks:

- frame_flips: frames that one side decodes without error and the other
  not, over the frames;
- bit_error_l1: sum over frames of |program's - reference's bit errors| /
  reference's bit errors;
- bit_error_gap: |program's bit errors - reference's| / reference's, the
  sums over the frames;
- bit_error_capped_gap: bit_error_gap with each frame's count capped at
  CAP bits (about eleven sections): the few frames whose decode fails
  outright (over 1 000 bit errors where the typical frame has 27)
  swing with rounding and would drown the rest;
- iters_gap: |program's AMP iterations - reference's| / reference's (the
  first pass's, in a concatenated code);
- bp_ok_gap (concatenated code): sum over frames of |program's verified
  LDPC codewords - reference's| / the reference's verified codewords;
- section_error_gap (SPARC): |program's section errors - reference's| /
  reference's;
- tau2_gap (SPARC): |mean last tau2 - reference's| / reference's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


CAP = 100


def _gap(p: float, r: float, floor: float = 1.0) -> float:
    return abs(p - r) / max(abs(r), floor)


def numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """prog: the program's per-frame outputs; ref: the reference's, with
    `sent` (the message bits) where the program delivers bits."""
    if "bits" in prog:
        prog = dict(prog, bit_errors=(prog["bits"] != ref["sent"]).sum(-1))
    bp, br = (np.asarray(prog["bit_errors"], np.int64),
              np.asarray(ref["bit_errors"], np.int64))
    if bp.shape != br.shape:
        raise ValueError(f"{bp.shape[0]} frames against the reference's "
                         f"{br.shape[0]}")
    out = dict(
        frame_flips=float(np.mean((bp > 0) != (br > 0))),
        bit_error_l1=float(np.abs(bp - br).sum()) / max(br.sum(), 1),
        bit_error_gap=_gap(bp.sum(), br.sum()),
        bit_error_capped_gap=_gap(np.minimum(bp, CAP).sum(),
                                  np.minimum(br, CAP).sum()),
        iters_gap=_gap(np.sum(prog["iters"], dtype=np.int64),
                       np.sum(ref["iters"], dtype=np.int64)),
    )
    if "bp_ok" in prog:
        okp, okr = (np.asarray(prog["bp_ok"], np.int64),
                    np.asarray(ref["bp_ok"], np.int64))
        out["bp_ok_gap"] = float(np.abs(okp - okr).sum()) / max(okr.sum(), 1)
    if "section_errors" in prog:
        out["section_error_gap"] = _gap(
            np.sum(prog["section_errors"], dtype=np.int64),
            np.sum(ref["section_errors"], dtype=np.int64))
        out["tau2_gap"] = _gap(float(np.mean(prog["tau2"])),
                               float(np.mean(ref["tau2"])), 1e-30)
    return {k: float(v) for k, v in out.items()}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number with a limit is within it."""
    return all(values[k] <= lim for k, lim in limits.items())
