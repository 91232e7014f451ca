"""Length-N FWHT as one (f1, f2) tile transform (port of
sparc_ldpc_tpu/ops/fwht.py `fwht_pallas`, TPU kernel `_fwht2_kernel`).

N = f1 * f2 with the reference's balanced split `factorize_pow2(N,
max_log=10)`; each row of x, viewed as an (f1, f2) row-major tile X, maps
to H_f1 X H_f2, which is H_N x in natural (Sylvester) order.  The
reference computes it as two matrix products on the TPU's matrix unit.
Here the CUDA route is `fwht2_run` in csrc/amp_split.cu: the AMP kernel's
row stage (H_f2 along each tile row: butterflies in registers, warp
shuffles and shared memory) into the output, then its column stage (H_f1
down 32-column strips held in registers and shared memory) in place.  It
is bound by device-memory bytes: two read-and-write passes over the
(B, N) tensor, with no +-1 matrix read at all.

Routing is the reference's: where the split is not two factors of at
least 8 (`len(fs) != 2 or min(fs) < 8`), `fwht2` is the plain `fwht_kron`,
as `fwht_pallas` falls back to `fwht_mxu`.  The split is two factors
exactly for N = 2^11 .. 2^20, each factor then in [32, 1024], which is
what the kernel's stages take.  There a CPU tensor takes the plain version
`fwht2_reference` and a CUDA tensor the kernel, which raises for what it
cannot take (not float32, not contiguous, more than 65535 rows).
`bf16=True` rounds the input to bfloat16 (the reference's bf16 operand,
float32 sums); the intermediate stays float32, as in the reference.
"""

from __future__ import annotations

import torch

from .fwht import factorize_pow2, fwht_kron, round_bf16


def _factors(N: int):
    fs = factorize_pow2(N, max_log=10)
    if len(fs) != 2 or min(fs) < 8:
        return None
    return fs


def fwht2_reference(x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `fwht2` (TF32 is never used: fwht_kron
    multiplies in float32 with matmul TF32 off on the card)."""
    N = x.shape[-1]
    fs = _factors(N)
    if fs is None:
        return fwht_kron(x, "bf16" if bf16 else "high")
    t = x.reshape(x.shape[:-1] + fs)
    if bf16:
        t = round_bf16(t)
    t = fwht_kron(fwht_kron(t, "highest", -1), "highest", -2)
    return t.reshape(x.shape)


def fwht2(x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Unnormalized FWHT of float32 x (..., N) along the last axis."""
    fs = _factors(x.shape[-1])
    if fs is None or x.device.type == "cpu":
        return fwht2_reference(x, bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fwht2 runs on cpu or cuda, not {x.device}")
    from ._build import run

    f1, f2 = fs
    B = x.numel() // x.shape[-1]
    if not (x.dtype == torch.float32 and x.is_contiguous()
            and 1 <= B <= 65535):
        raise ValueError(f"the CUDA fwht2 takes contiguous float32 rows, at "
                         f"most 65535 of them; got {x.dtype} "
                         f"{tuple(x.shape)}, contiguous={x.is_contiguous()}")
    out = torch.empty_like(x)
    run("amp_split", "fwht2_run", x.device, x.data_ptr(), out.data_ptr(), B,
        f1, f2, int(bf16))
    fwht2.launches += 1
    return out


# kernel runs (one per fwht2 call on a CUDA tensor: a row-stage and a
# column-stage launch); never counted on the CPU route or the plain route
fwht2.launches = 0
