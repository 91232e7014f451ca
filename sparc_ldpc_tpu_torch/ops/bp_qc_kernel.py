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
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .bp import BpResult
from .bp_qc import QcBpTables, bp_decode_qc

_METHODS = ("minsum", "oms")
# (lanes a check, edge slots a lane) the kernel is compiled for
# (csrc/bp_qc_layered.cu `dispatch`); a code takes the first that holds
# its largest layer: one lane a check up to 12 edges, two above, which
# halves a layer's chain of dependent operations.  A check's sign and
# min1-tie bits are one 32-bit word each: 32 edges at most.
EDGE_LAYOUTS = ((1, 8), (1, 12), (2, 8), (2, 12), (2, 16))


class LayerTable(NamedTuple):
    """The kernel's view of a (J, K) base matrix.

    table: int32, layer_start (J + 1), zero_start (J + 1) and every zero
      block's column (the pass of iteration 0), red_start (J + 1) and the
      reduced zero blocks' columns (the pass of every later iteration).
    degrees: active blocks of each layer.
    reduced: the (layer, column) zero blocks whose column the previous
      layer, cyclically, writes: after iteration 0 the others hold values
      that clip(y) + 0 returns unchanged.
    lanes, slots: the edge layout, EDGE_LAYOUTS' first that holds the
      largest degree.
    """
    table: np.ndarray
    n_act: int
    n_zero: int
    degrees: Tuple[int, ...]
    reduced: Tuple[Tuple[int, int], ...]
    lanes: int
    slots: int

    @property
    def max_degree(self) -> int:
        return max(self.degrees)


def layer_table(shifts: Tuple[Tuple[int, ...], ...]) -> LayerTable:
    """The kernel's table of a (J, K) base matrix (-1 a zero block).
    Raises ValueError if a layer has more active blocks than the largest
    layout of EDGE_LAYOUTS holds."""
    s = np.asarray(shifts, dtype=np.int64)
    J = s.shape[0]
    active = s >= 0
    degrees = tuple(int(d) for d in active.sum(1))
    fits = [(lanes, slots) for lanes, slots in EDGE_LAYOUTS
            if lanes * slots >= max(degrees)]
    if not fits:
        most = max(lanes * slots for lanes, slots in EDGE_LAYOUTS)
        raise ValueError(f"a layer has {max(degrees)} active blocks; the "
                         f"layered kernel takes at most {most}")
    zero = [np.flatnonzero(~active[j]) for j in range(J)]
    red = [np.flatnonzero(~active[j] & active[j - 1]) for j in range(J)]
    layer_start, zero_start, red_start = (
        np.cumsum([0] + [len(a) for a in lists])
        for lists in ([np.flatnonzero(a) for a in active], zero, red))
    table = np.concatenate([layer_start, zero_start, *zero, red_start,
                            *red]).astype(np.int32)
    reduced = tuple((j, int(k)) for j in range(J) for k in red[j])
    return LayerTable(table, int(layer_start[-1]), int(zero_start[-1]),
                      degrees, reduced, *fits[0])


def address_table(shifts: Tuple[Tuple[int, ...], ...], Z: int
                  ) -> np.ndarray:
    """(J, slots / 4, Z lanes, 4) int32: the word of the totals (order
    k Z + zv) that lane r of check t reads in slot m of layer j, at
    [j, m // 4, t lanes + r, m % 4]: for the layer's i-th active block in
    increasing column order, i = r slots + m, k Z + (t + s) % Z; past the
    layer's degree n + t, a scratch word of check t's own."""
    lt = layer_table(shifts)
    s = np.asarray(shifts, dtype=np.int64)
    J, K = s.shape
    L, S = lt.lanes, lt.slots
    t = np.arange(Z)
    addr = np.tile(K * Z + t, (J, L * S, 1))             # (J, edge i, Z)
    for j in range(J):
        for i, k in enumerate(np.flatnonzero(s[j] >= 0)):
            addr[j, i] = k * Z + (t + s[j, k]) % Z
    # edge i = r S + m of check t -> [j, m // 4, t L + r, m % 4]
    addr = addr.reshape(J, L, S // 4, 4, Z).transpose(0, 2, 4, 1, 3)
    return np.ascontiguousarray(addr.reshape(J, S // 4, Z * L, 4)
                                ).astype(np.int32)


def design_traffic(shifts: Tuple[Tuple[int, ...], ...], Z: int, B: int,
                   iters_sum: int) -> dict:
    """The bytes the kernel's design moves for B codewords that ran
    iters_sum iterations in all (each runs iteration 0 once iters >= 1).

    Device memory: each codeword's LLRs read and its posterior, hard
    decisions, iteration count and ok flag written.  On chip (shared
    memory and the L1 cache, one SRAM an SM): the LLRs stored and the
    posterior read once; an iteration reads each layer's edge slots'
    addresses and totals (padding included) and writes its active edges'
    totals, reads (not in iteration 0) and writes each (layer, check)'s
    16-byte state, and reads and writes Z totals at each zero block of the
    pass (every one in iteration 0, the reduced list after); the syndrome
    reads addresses and totals of every layer in a codeword's last
    iteration and of its first layer in the others (a warp stops at its
    first failing layer: the least it reads)."""
    lt = layer_table(shifts)
    J, n = len(shifts), len(shifts[0]) * Z
    first = B if iters_sum > 0 else 0        # codewords that ran iteration 0
    later = iters_sum - first
    slot_bytes = 8 * lt.lanes * lt.slots * Z  # a layer's addresses, totals
    chip = (8 * n * B
            + iters_sum * (J * slot_bytes + 4 * lt.n_act * Z)
            + 16 * J * Z * (iters_sum + later)
            + 8 * Z * (lt.n_zero * first + len(lt.reduced) * later)
            + slot_bytes * (later + J * first))
    return dict(device_bytes=B * (9 * n + 5), chip_bytes=chip)


@functools.lru_cache(maxsize=None)
def _device_tables(shifts, Z: int, device: torch.device):
    lt = layer_table(shifts)
    return (torch.as_tensor(lt.table, device=device),
            torch.as_tensor(address_table(shifts, Z), device=device), lt)


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
    table, addr, lt = _device_tables(shifts, Z, llr.device)
    tot = torch.empty_like(llr)
    hard = torch.empty(llr.shape, dtype=torch.uint8, device=llr.device)
    it = torch.empty((B,), dtype=torch.int32, device=llr.device)
    ok = torch.empty((B,), dtype=torch.bool, device=llr.device)
    # the work queue's counter, zeroed on the stream by the entry point
    counter = torch.empty((1,), dtype=torch.int32, device=llr.device)
    run("bp_qc_layered", "bp_qc_layered_run", llr.device,
        llr.data_ptr(), table.data_ptr(), addr.data_ptr(), tot.data_ptr(),
        hard.data_ptr(), it.data_ptr(), ok.data_ptr(), counter.data_ptr(),
        B, J, K, Z, lt.n_act, lt.n_zero, len(lt.reduced), lt.slots,
        lt.lanes, iters,
        _METHODS.index(method), float(alpha), float(beta), float(clip))
    bp_decode_qc_kernel.launches += 1
    return BpResult(hard=hard, posterior=tot, iters=it, ok=ok)


# kernel launches (one per call on a CUDA tensor); never counted on the
# CPU route
bp_decode_qc_kernel.launches = 0
