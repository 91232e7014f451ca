"""Row-layered QC-LDPC min-sum / offset min-sum with the whole decode of
each codeword on chip (counterpart of sparc_ldpc_tpu/ops/bp_qc_pallas.py
`bp_decode_qc_pallas`).

On a CUDA tensor `bp_decode_qc_kernel` launches the hand-written kernel
(csrc/bp_qc_layered.cu) or raises; on a CPU tensor it runs the plain
layered engine `ops.bp_qc.bp_decode_qc(schedule="layered")`, to which the
kernel is bitwise equal (hard decisions, ok flags, iteration counts and
float32 posteriors).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .bp import BpResult
from .bp_qc import QcBpTables, bp_decode_qc

_METHODS = ("minsum", "oms")


def layer_table(shifts: Tuple[Tuple[int, ...], ...]
                ) -> Tuple[np.ndarray, int, int]:
    """The kernel's int32 table of a (J, K) base matrix: layer_start
    (J + 1), the active blocks' columns and shifts layer by layer in
    increasing column order, zero_start (J + 1) and the zero blocks'
    columns.  Returns (table, number active, number zero)."""
    s = np.asarray(shifts, dtype=np.int64)
    J = s.shape[0]
    act = [np.flatnonzero(s[j] >= 0) for j in range(J)]
    zero = [np.flatnonzero(s[j] < 0) for j in range(J)]
    act_k = np.concatenate(act)
    act_s = np.concatenate([s[j, a] for j, a in enumerate(act)])
    layer_start = np.cumsum([0] + [len(a) for a in act])
    zero_start = np.cumsum([0] + [len(z) for z in zero])
    table = np.concatenate([layer_start, act_k, act_s, zero_start,
                            np.concatenate(zero)]).astype(np.int32)
    return table, int(act_k.size), int(zero_start[-1])


@functools.lru_cache(maxsize=None)
def _device_table(shifts, device: torch.device):
    table, n_act, n_zero = layer_table(shifts)
    return torch.as_tensor(table, device=device), n_act, n_zero


@functools.lru_cache(maxsize=None)
def _plain_tables(shifts, Z: int) -> QcBpTables:
    return QcBpTables.build(np.asarray(shifts), Z)


def bp_decode_qc_kernel(
    llr: torch.Tensor,                      # (B, n), n = K*Z, order k*Z+zv
    shifts: Tuple[Tuple[int, ...], ...],    # (J, K) base matrix, -1 = zero
    Z: int,
    iters: int = 32,
    method: str = "minsum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    clip: float = 20.0,
) -> BpResult:
    """Layered min-sum ("minsum") or offset min-sum ("oms") BP."""
    if method not in _METHODS:
        raise ValueError(f"the layered kernel runs {_METHODS}, got "
                         f"{method!r}")
    J, K = len(shifts), len(shifts[0])
    if llr.dim() != 2 or llr.shape[1] != K * Z:
        raise ValueError(f"llr has shape {tuple(llr.shape)}, expected "
                         f"(B, {K * Z})")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr has dtype {llr.dtype}, expected float32")
    if llr.device.type == "cpu":
        return bp_decode_qc(llr, _plain_tables(shifts, Z), iters, method,
                            alpha, beta, clip, schedule="layered")
    if llr.device.type != "cuda":
        raise ValueError(f"bp_decode_qc_kernel runs on cpu or cuda, not "
                         f"{llr.device}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    from ._build import run

    B = llr.shape[0]
    table, n_act, n_zero = _device_table(shifts, llr.device)
    tot = torch.empty_like(llr)
    it = torch.empty((B,), dtype=torch.int32, device=llr.device)
    ok = torch.empty((B,), dtype=torch.int32, device=llr.device)
    run("bp_qc_layered", "bp_qc_layered_run", llr.device,
        llr.data_ptr(), table.data_ptr(), tot.data_ptr(), it.data_ptr(),
        ok.data_ptr(), B, J, K, Z, n_act, n_zero, iters,
        _METHODS.index(method), float(alpha), float(beta), float(clip))
    bp_decode_qc_kernel.launches += 1
    return BpResult(hard=(tot < 0).to(torch.uint8), posterior=tot, iters=it,
                    ok=ok.to(torch.bool))


# kernel launches (one per call on a CUDA tensor); never counted on the
# CPU route
bp_decode_qc_kernel.launches = 0
