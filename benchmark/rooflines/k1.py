"""K1, the split form of the whole-trial AMP kernel (csrc/amp_split.cu,
csrc/amp_k1.cuh): its names in the trace, the call that launches it and the
frozen count of the work of one call.

The count is of the function, not of the kernel's design: for B codewords
of an (L, M) tile that ran `its` iterations in all,

- bytes: the received words (B L M float32, none when the noise is drawn
  in the kernel), the row support (L M), the amplitudes (L), the true
  indices (B L), the tau2 trace (T B) and the iteration counts (B), read or
  written once each, and beta (B L M float32) written once;
- float32 operations: each transform H_L (x) H_M costs log2(L M) adds an
  element, two transforms an iteration but the first (which has no forward
  transform), ELEM_OPS more an element and iteration (residual, Onsager
  term, softmax, freeze), and the encode's H_L, log2(L) an element.

The least time is the larger of bytes over HBM_BYTES_PER_S and operations
over the float32 peak (67 TFLOP/s, the H100 SXM data sheet's rate outside
the tensor cores at 700 W).  At the headline call (B = 2048, L = 1024,
M = 512, T = 22 iterations each, the noise given as input) it is 17.5 ms,
bound by operations.
"""

from __future__ import annotations

import math
from typing import Dict

NAMES = ("k1_encode_kernel", "k1_col_kernel", "k1_row_kernel")
CALLS = (("sparc_ldpc_tpu_torch.models.amp", "amp_fused"),
         ("sparc_ldpc_tpu_torch.parallel.amp_sharded", "amp_fused"))
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ELEM_OPS = 12


def least_seconds(B: int, L: int, M: int, T: int, its: float,
                  noise_drawn: bool) -> float:
    el = L * M
    nbytes = 4 * (B * el * (1 if noise_drawn else 2) + el + L + B * L
                  + T * B + B)
    ops = ((2 * its - B) * el * math.log2(el) + its * el * ELEM_OPS
           + B * el * math.log2(L))
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def record(args, kwargs, result) -> Dict:
    """What a call into amp_fused(y_n, mask, sq_npl, P, n, T, ...) needs
    for its count, None when the call runs another form than K1's (the
    split form: split=True, or L > 1024 with no form asked for)."""
    L, M = args[1].shape
    split, form = kwargs.get("split"), kwargs.get("form")
    if not (form in (None, "split") and (split or (split is None
                                                  and L > 1024))):
        return None
    iters = result[2]
    return dict(B=int(iters.shape[0]), L=int(L), M=int(M), T=int(args[5]),
                iters=iters, noise_drawn=kwargs.get("noise_seed") is not None)


def least(rec: Dict) -> float:
    return least_seconds(rec["B"], rec["L"], rec["M"], rec["T"],
                         float(rec["iters"].sum()), rec["noise_drawn"])
