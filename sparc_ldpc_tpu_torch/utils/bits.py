"""Message bit <-> section index packing (port of sparc_ldpc_tpu/utils/bits.py).

Each section carries logM bits, MSB first:

    c_l = sum_{b=0}^{logM-1}  bits[l*logM + b] << (logM - 1 - b)
"""

from __future__ import annotations

import torch


def bits_to_indices(bits: torch.Tensor, logM: int) -> torch.Tensor:
    """(..., L*logM) {0,1} -> (..., L) int32 section indices."""
    b = bits.to(torch.int32)
    b = b.reshape(b.shape[:-1] + (b.shape[-1] // logM, logM))
    weights = 1 << torch.arange(logM - 1, -1, -1, dtype=torch.int32,
                                device=b.device)
    return (b * weights).sum(-1, dtype=torch.int32)


def indices_to_bits(indices: torch.Tensor, logM: int) -> torch.Tensor:
    """(..., L) int -> (..., L*logM) int32 {0,1}, MSB first."""
    idx = indices.to(torch.int32)
    shifts = torch.arange(logM - 1, -1, -1, dtype=torch.int32,
                          device=idx.device)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(idx.shape[:-1] + (idx.shape[-1] * logM,))
