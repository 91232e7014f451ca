"""K2, the layered QC-LDPC min-sum kernel (csrc/bp_qc_layered.cu): its name
in the trace, the call that launches it and the frozen count of the work
of one call.

For N codewords of length n on a QC code with E edges (Z times the active
circulant blocks) that ran `its` iterations in all:

- bytes: the LLRs (N n float32) read once; the hard decisions (N n uint8),
  the posteriors (N n float32), the iteration counts (N int32) and the
  syndrome flags (N bool) written once;
- float32 operations: EDGE_OPS an edge and iteration.

The least time is the larger of bytes over HBM_BYTES_PER_S and operations
over the float32 peak.  At the concat block (12 288 codewords of the
n = 744 array code, 1.18 iterations each) it is 0.025 ms, bound by bytes;
at the concat_wifi block (6 144 codewords of the 802.11n n = 648 code,
88 circulants) about 0.011 ms, by bytes too.
"""

from __future__ import annotations

from typing import Dict

NAMES = ("bp_qc_layered_kernel",)
CALLS = (("sparc_ldpc_tpu_torch.models.ldpc", "bp_decode_qc_kernel"),)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
EDGE_OPS = 8


def least_seconds(N: int, n: int, edges: int, its: float) -> float:
    nbytes = N * n * (4 + 1 + 4) + N * (4 + 1)
    return max(nbytes / HBM_BYTES_PER_S,
               EDGE_OPS * edges * its / FP32_OPS_PER_S)


def record(args, kwargs, result) -> Dict:
    """A call bp_decode_qc_kernel(llr, shifts, Z, ...)."""
    llr, shifts, Z = args[0], args[1], args[2]
    active = sum(1 for row in shifts for s in row if s >= 0)
    return dict(N=int(llr.shape[0]), n=int(llr.shape[1]),
                edges=int(Z) * active, iters=result.iters)


def least(rec: Dict) -> float:
    return least_seconds(rec["N"], rec["n"], rec["edges"],
                         float(rec["iters"].sum()))
