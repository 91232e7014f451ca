"""Whole-trial AMP decode on the (L, M) section tile (port of
sparc_ldpc_tpu/ops/amp_kernel.py `amp_fused` with the split kernel
`_amp_kernel_split`: optional in-kernel encode, per-codeword early stop,
decision-feedback pinning and an SE tau2 schedule).

With the Kronecker split N = L * M and ML == N, the transform of a
codeword is H_L @ X @ H_M on its (L, M) tile, the same tile the sectionwise
softmax works on.  `amp_fused` runs all T iterations:

    z     = y - mask/n * H(beta') + coef * z,   coef = (P - |beta'|^2/n^2) / tau2_prev
    tau2  = |z|^2 / n
    beta' = sqo * softmax_row((sqi / tau2) * (H(z) + beta'))

(tau2 from an SE schedule when one is given; pinned rows overridden after
the softmax; a codeword frozen once its tau2 plateaus within tol) in the
reference's scale-free form (beta' = beta * sqrt(n), sqi = sq /
sqrt(n), sqo = sq * sqrt(n)).  As in the reference kernel, the data operand
of each transform stage is rounded to bfloat16 and the sums are float32;
the encode transform is float32, so codeword power is exact to float32.

On a CUDA tensor `amp_fused` launches the hand-written kernel
(csrc/amp_split.cu) or raises; on a CPU tensor it runs
`amp_fused_reference`, the plain PyTorch version of the same function.
The plain version rounds where the reference kernel does: before the H_M
stage and before the H_L stage of both transforms.  The CUDA kernel's
adjoint transform applies H_L first (its column stage feeds the row-wise
softmax), so its second rounding falls after H_L instead.  In float32
(precision="highest") the two agree to summation order; with bf16
rounding they draw different rounding noise, which T iterations amplify
at near-tie sections, so they agree in distribution.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .fwht import fwht_kron, round_bf16

_PRECISIONS = ("highest", "high", "default", "bf16")


# ------------------------------------------------------------- transform

def _axis_stage(x: torch.Tensor, dim: int, bf16: bool) -> torch.Tensor:
    return fwht_kron(round_bf16(x) if bf16 else x, "highest", dim)


def fwht_tile_reference(x: torch.Tensor, precision: str = "highest"
                        ) -> torch.Tensor:
    """Plain H_L (x) H_M of each (L, M) tile of x (..., L, M): H_M along the
    rows, then H_L down the columns; "bf16" rounds each stage's input."""
    bf16 = precision == "bf16"
    return _axis_stage(_axis_stage(x, -1, bf16), -2, bf16)


def _check_cuda_tensor(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _supported_dim(d: int) -> bool:
    return 32 <= d <= 1024 and d & (d - 1) == 0


def _check_cuda_shape(B: int, L: int, M: int):
    if not (_supported_dim(L) and _supported_dim(M) and 1 <= B <= 65535):
        raise ValueError(f"the CUDA kernel takes L, M powers of two in "
                         f"[32, 1024] and B <= 65535; got B={B}, L={L}, "
                         f"M={M}")


def fwht_tile(x: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """H_L (x) H_M of each tile of x (B, L, M) float32 (H_M first).

    The transform stage of the AMP kernel, alone: on a CUDA tensor it runs
    the kernel's row and column stages, on a CPU tensor
    `fwht_tile_reference`."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if x.device.type == "cpu":
        return fwht_tile_reference(x, precision)
    if x.device.type != "cuda":
        raise ValueError(f"fwht_tile runs on cpu or cuda, not {x.device}")
    from ._build import check, load_library

    B, L, M = x.shape
    _check_cuda_shape(B, L, M)
    _check_cuda_tensor("x", x, torch.float32, (B, L, M), x.device)
    lib = load_library("amp_split")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check("amp_split", lib.amp_fwht_tile(x.data_ptr(), out.data_ptr(), B, L, M,
                                 int(precision == "bf16"), stream),
          "amp_fwht_tile")
    fwht_tile.launches += 1
    return out


fwht_tile.launches = 0


# ------------------------------------------------------------------- AMP

def _constants(mask, sq_npl, n):
    """Scale-free constants: mask/n, sq/sqrt(n) and sq*sqrt(n) (as (L, 1))."""
    L = sq_npl.shape[0]
    mask_n = mask.to(torch.float32) / n
    sqi = (sq_npl * (1.0 / math.sqrt(n))).reshape(L, 1)
    sqo = (sq_npl * math.sqrt(n)).reshape(L, 1)
    return mask_n, sqi, sqo


def _pin_rows(beta, pin_idx, sqo):
    """Pinned rows (pin_idx >= 0) become sqo * one_hot(pin_idx); -1 rows
    keep beta.  beta (B, L, M) in beta*sqrt(n) scale, sqo (L, 1)."""
    cols = torch.arange(beta.shape[-1], device=beta.device)
    pin = pin_idx[..., None].to(torch.int64)
    pinned = torch.where(cols == pin, sqo, 0.0)
    return torch.where(pin >= 0, pinned, beta)


def amp_fused_reference(y_n: torch.Tensor, mask: torch.Tensor,
                        sq_npl: torch.Tensor, P: float, n: int, T: int,
                        encode_idx: Optional[torch.Tensor] = None,
                        precision: str = "bf16",
                        tol: float = 0.0,
                        pin_idx: Optional[torch.Tensor] = None,
                        tau2_schedule: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `amp_fused` (same arguments and results)."""
    B, L, M = y_n.shape
    mask_n, sqi, sqo = _constants(mask, sq_npl, n)
    y = torch.where(mask_n > 0, y_n, 0.0)
    if encode_idx is not None:
        b0 = torch.zeros_like(y)
        b0.scatter_(2, encode_idx.to(torch.int64)[..., None],
                    sqo.expand(B, L, 1).contiguous())
        y = y + mask_n * fwht_tile_reference(b0, "highest")
    beta = torch.zeros_like(y)
    z = y
    trace = torch.empty((T, B), dtype=torch.float32, device=y.device)
    tau2_prev = torch.full((B,), math.inf, device=y.device)
    active = torch.ones((B,), dtype=torch.bool, device=y.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=y.device)
    for t in range(T):
        z_new = y
        if t > 0:
            bnorm2 = (beta * beta).sum((1, 2))
            coef = (P - bnorm2 / (n * n)) / tau2_prev
            w = fwht_tile_reference(beta, precision)
            z_new = y - mask_n * w + coef[:, None, None] * z
        if tau2_schedule is None:
            tau2 = (z_new * z_new).sum((1, 2)) / n
        else:
            tau2 = tau2_schedule[t].to(torch.float32).expand(B)
        s = fwht_tile_reference(z_new, precision) + beta
        a = (sqi / tau2[:, None, None]) * s
        a = a - a.amax(-1, keepdim=True)
        e = torch.exp(a)
        beta_new = (sqo / e.sum(-1, keepdim=True)) * e
        if pin_idx is not None:
            beta_new = _pin_rows(beta_new, pin_idx, sqo)
        # per-codeword freeze (the reference's early stop): a codeword
        # whose tau2 plateaued within tol stops from the next iteration
        # on, and its frozen trace entries repeat the last tau2
        conv = (tau2 - tau2_prev).abs() < tol * tau2
        act3 = active[:, None, None]
        beta = torch.where(act3, beta_new, beta)
        z = torch.where(act3, z_new, z)
        tau2_prev = torch.where(active, tau2, tau2_prev)
        trace[t] = tau2_prev
        iters += active.to(torch.int32)
        active = active & ~conv
    return beta * (1.0 / math.sqrt(n)), trace, iters


def amp_fused(y_n: torch.Tensor,            # (B, L, M) N-space embedded y
              mask: torch.Tensor,           # (L, M) 0/1 row support
              sq_npl: torch.Tensor,         # (L,) sqrt(n P_l)
              P: float, n: int, T: int,
              encode_idx: Optional[torch.Tensor] = None,   # (B, L) int32
              precision: str = "bf16",
              tol: float = 0.0,
              pin_idx: Optional[torch.Tensor] = None,      # (B, L) int32
              tau2_schedule: Optional[torch.Tensor] = None,  # (T,) f32
              noise_seed: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-trial AMP: returns (beta (B, L, M), tau2 trace (T, B),
    iterations used (B,) int32).

    encode_idx (B, L) turns on the in-kernel encode: y_n then holds the
    channel noise on the row support, and the codeword
    mask o (A beta0) is synthesized from the true section indices.

    precision "bf16" is the reference kernel's arithmetic (each transform
    stage's operand rounded to bf16, float32 sums); the other modes keep
    float32 operands, in which the kernel and its plain version differ
    only in summation order.

    tol > 0 is the reference's per-codeword early stop: once
    |tau2_t - tau2_{t-1}| < tol * tau2_t a codeword is frozen from
    iteration t + 1 on, its frozen trace entries repeat tau2_t, and its
    iteration count stops.  pin_idx (B, L), -1 = unpinned, overrides each
    pinned row with sq * one_hot(pin_idx) after every softmax (decision
    feedback).  tau2_schedule (T,) replaces |z|^2 / n with a state-
    evolution schedule; the Onsager term then divides by the schedule's
    previous entry.  The in-kernel noise (noise_seed) is not ported yet
    and raises NotImplementedError."""
    if noise_seed is not None:
        raise NotImplementedError(
            "amp_fused: the in-kernel noise (noise_seed) is not ported yet")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if tol < 0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if y_n.device.type == "cpu":
        return amp_fused_reference(y_n, mask, sq_npl, P, n, T, encode_idx,
                                   precision, tol, pin_idx, tau2_schedule)
    if y_n.device.type != "cuda":
        raise ValueError(f"amp_fused runs on cpu or cuda, not {y_n.device}")
    from ._build import check, load_library

    dev = y_n.device
    B, L, M = y_n.shape
    _check_cuda_shape(B, L, M)
    _check_cuda_tensor("y_n", y_n, torch.float32, (B, L, M), dev)
    _check_cuda_tensor("mask", mask, torch.float32, (L, M), dev)
    _check_cuda_tensor("sq_npl", sq_npl, torch.float32, (L,), dev)
    for name, idx in (("encode_idx", encode_idx), ("pin_idx", pin_idx)):
        if idx is not None:
            _check_cuda_tensor(name, idx, torch.int32, (B, L), dev)
    if tau2_schedule is not None:
        _check_cuda_tensor("tau2_schedule", tau2_schedule, torch.float32,
                           (T,), dev)
    mask_n, sqi, sqo = _constants(mask, sq_npl, n)
    lib = load_library("amp_split")
    beta = torch.empty_like(y_n)
    trace = torch.empty((T, B), dtype=torch.float32, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    # active[t, b]: codeword b runs iteration t.  Row 0 is all ones; the
    # row stage of iteration t writes row t + 1, which only the launches
    # of iteration t + 1 read.
    active = torch.ones((T + 1, B), dtype=torch.int32, device=dev)
    y = torch.empty_like(y_n)
    z = torch.empty_like(y_n)
    # the transform stages round the work tile to bf16 when they read it:
    # in bf16 mode it is stored in bf16 (same values, half the bytes)
    bf16 = precision == "bf16"
    work = torch.empty_like(y_n, dtype=torch.bfloat16 if bf16 else None)
    zpart = torch.empty((B, M // 32), dtype=torch.float32, device=dev)
    bpart = torch.empty((B, L), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = lib.amp_split_run(
        y_n.data_ptr(), mask_n.data_ptr(), sqi.data_ptr(), sqo.data_ptr(),
        ptr(encode_idx), ptr(pin_idx), ptr(tau2_schedule),
        beta.data_ptr(), trace.data_ptr(), iters.data_ptr(),
        active.data_ptr(), y.data_ptr(), z.data_ptr(),
        work.data_ptr(), zpart.data_ptr(), bpart.data_ptr(),
        B, L, M, T, float(P), float(n), 1.0 / math.sqrt(n), float(tol),
        int(bf16), stream)
    check("amp_split", rc, "amp_split_run")
    amp_fused.launches += 1
    return beta, trace, iters


# kernel runs (one per amp_fused call on a CUDA tensor: the encode launch
# plus 2 T iteration launches); never counted on the CPU route
amp_fused.launches = 0
