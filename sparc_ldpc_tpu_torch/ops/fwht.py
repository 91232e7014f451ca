"""Fast Walsh-Hadamard transform, plain PyTorch (port of
sparc_ldpc_tpu/ops/fwht.py: `factorize_pow2`, `hadamard_factor`,
`fwht_mxu`, `fwht_butterfly`).

`fwht_kron` uses the Kronecker factorization H_N = H_f1 (x) ... (x) H_fk:
one small +-1 matrix product per mode.  Precision follows
SparcConfig.transform_precision: "bf16" rounds the data operand to
bfloat16 before every factor and accumulates in float32 (what the
reference does on the TPU's matrix unit; the +-1 entries are exact);
every other mode computes in float32.  The reference's "high"/"highest"
are its accurate float32 modes, and "default" is float32 on the reference's
CPU backend, so all three map to float32 here (TF32 is never used: callers
on the GPU set torch.backends.cuda.matmul.allow_tf32 = False).

Natural (Sylvester) ordering: H[i, j] = (-1)^popcount(i & j).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def factorize_pow2(N: int, max_log: int = 8) -> Tuple[int, ...]:
    """Split N = 2^k into the fewest balanced factors each <= 2^max_log."""
    if N <= 0 or N & (N - 1):
        raise ValueError(f"N must be a power of two, got {N}")
    k = N.bit_length() - 1
    if k == 0:
        return (1,)
    nf = -(-k // max_log)
    base, rem = divmod(k, nf)
    logs = [base + 1] * rem + [base] * (nf - rem)
    return tuple(1 << e for e in logs)


@functools.lru_cache(maxsize=None)
def _hadamard_np(f: int) -> np.ndarray:
    H = np.array([[1.0]])
    while H.shape[0] < f:
        H = np.block([[H, H], [H, -H]])
    return H


def hadamard_factor(f: int, device="cpu", dtype=torch.float32
                    ) -> torch.Tensor:
    """Dense +-1 Sylvester Hadamard matrix H_f, float32 (or dtype)."""
    return torch.as_tensor(_hadamard_np(f), dtype=dtype, device=device)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round values to the nearest bfloat16, keep x's dtype (float32, or
    float64 for a plain version run with float64 sums)."""
    return x.to(torch.bfloat16).to(x.dtype)


def fwht_kron(x: torch.Tensor, precision: str = "highest",
              dim: int = -1) -> torch.Tensor:
    """Unnormalized FWHT of `x` along `dim` by mode contractions, in x's
    dtype (float32; float64 sums for a float64 x)."""
    bf16 = precision == "bf16"
    y = x.movedim(dim, -1)
    N = y.shape[-1]
    fs = factorize_pow2(N)
    lead = y.shape[:-1]
    nb = len(lead)
    y = y.reshape(lead + fs)
    for i, f in enumerate(fs):
        if f == 1:
            continue
        if bf16:
            y = round_bf16(y)
        H = hadamard_factor(f, device=y.device, dtype=y.dtype)
        y = torch.tensordot(y, H, dims=([nb + i], [0])).movedim(-1, nb + i)
    return y.reshape(lead + (N,)).movedim(-1, dim)


def fwht_butterfly(x: torch.Tensor) -> torch.Tensor:
    """Radix-2 butterfly FWHT over the last axis; for tests and tiny sizes."""
    N = x.shape[-1]
    lead = x.shape[:-1]
    y = x
    h = 1
    while h < N:
        y = y.reshape(lead + (N // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack((a + b, a - b), dim=-2)
        h *= 2
    return y.reshape(lead + (N,))
