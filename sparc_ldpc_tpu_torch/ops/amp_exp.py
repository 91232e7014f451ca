"""The split AMP kernel's experiments: stage ablation (S2), other factorings
of H_L (S3) and two codewords per block (S1) (port of the TPU kernels of
scripts/kernel_ablation.py `make_kernel`, scripts/lstage_exp.py
`make_kernel` and scripts/pair_kernel_exp.py `_amp_kernel_split_pair`).

Each experiment is the split fused AMP decode at a fixed T on an
observation y given (no encode, no noise, no early stop, no pins), with
one thing changed.  `amp_exp(mode, ...)` runs one variant; the modes are

  S2 (kernel_ablation): "full", and, for timing only (their decodes are
      garbage), "no_softmax" (beta = s (sq / tau2) 1e-3), "no_max" (the
      softmax without the row max: exp overflows to inf and NaN),
      "no_transform" (the transform is the identity), "m_stage_only"
      (the transform is H_M alone), "no_norms" (coef = 0.1, tau2 = 0.5);
  S3 (lstage_exp), every one a real decode: "slab_loop", "slab_unroll",
      "slab_batched" (H_L = H_8 (x) H_128, both factors as products),
      "f512_vpu2", "f256_vpu4", "f128_vpu8" (H_L = H_{f_a} (x) H_{f_b},
      H_{f_b} a product, H_{f_a} float32 butterflies), "l256_m128" (as
      f256_vpu4, and H_M = H_4 (x) H_128 with H_128 a product; M = 512);
  S1 (pair_kernel_exp): "pair", the "full" decode two codewords at a time;
      its trace holds the first codeword of each pair.

The arithmetic is the scripts' (not K1's scale-free form): beta in true
scale, a 0/1 mask, and per iteration

    coef  = (P - |beta|^2 / n) / tau2_prev   (0 at t = 0)
    z     = mask (y - H(beta) / sqrt(n)) + coef z
    tau2  = |z|^2 / n
    beta  = sq softmax_row((sq / tau2) (H(z) / sqrt(n) + beta))

with H(x) = H_{f_a} H_{f_b} (x H_M), H_M along each section row first,
then H_{f_b} down each slab of f_b rows, then H_{f_a} across the slabs.
`amp_exp_reference` is that arithmetic in plain PyTorch, rounding where
the scripts round: the data operand of every product is rounded to
bfloat16 (the H_M product, each slab's H_{f_b} product and, where H_{f_a}
is a product, that one), the sums are float32, and the butterflies of S3's
radix factors are float32 on unrounded values.

The CUDA kernels (csrc/amp_exp.cu) are K1's two launches an iteration
with one thing changed (the source's header says what).  Their adjoint
transform applies H_L first, in the column stage, and H_M after it, in the
row stage, so they round the adjoint at other places than the scripts
(ops/amp_kernel.py says the same of K1): the decoding modes agree with
their plain version in distribution (decisions and tau2, the bf16 decode
contract).  The ablated modes' garbage decodes amplify that difference,
so `amp_exp_reference(order="kernel")` rounds where the K1-style kernels
round, forward H_L rnd(H_M rnd(beta)) and adjoint H_M rnd(H_L rnd(z)),
with H_L float32, and is what they are held to in bf16.  The kernels take
the scripts' shape only, L = 1024 and M = 512.

On a CPU tensor `amp_exp` runs `amp_exp_reference`; on a CUDA tensor it
launches the mode's kernel or raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .fwht import hadamard_factor, round_bf16

S2_MODES = ("full", "no_softmax", "no_max", "no_transform", "m_stage_only",
            "no_norms")
S3_MODES = ("slab_loop", "slab_unroll", "slab_batched", "f512_vpu2",
            "f256_vpu4", "f128_vpu8", "l256_m128")
S1_MODES = ("pair",)
MODES = S2_MODES + S3_MODES + S1_MODES
# the timing-only modes of S2, whose decodes are garbage
ABLATED = ("no_softmax", "no_max", "no_transform", "m_stage_only",
           "no_norms")
# the radix factor f_a = L / f_b of each mode (at L = 1024 the scripts'
# f_b: 128, and 512, 256, 256 for f512_vpu2, f256_vpu4, l256_m128)
_RADIX = {"f512_vpu2": 2, "f256_vpu4": 4, "l256_m128": 4}
# the shape the kernels take (the scripts')
KERNEL_L, KERNEL_M = 1024, 512


def mode_f_b(mode: str, L: int) -> int:
    """The slab height f_b of `mode` at L: L / 8, or L / 2, L / 4, L / 4 for
    f512_vpu2, f256_vpu4 and l256_m128 (the scripts' values at L = 1024)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return L // _RADIX.get(mode, 8)


def _check_mode(mode: str, L: int, M: int, f_b: int, B: int, pair: bool):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if f_b < 1 or L % f_b or f_b & (f_b - 1):
        raise ValueError(f"f_b = {f_b} must be a power of two dividing "
                         f"L = {L}")
    if mode == "l256_m128" and M != 512:
        raise ValueError(f"l256_m128 factors H_M as H_4 (x) H_128: M must "
                         f"be 512, got {M}")
    if pair and B % 2:
        raise ValueError(f"two codewords a block need an even B, got {B}")


# ------------------------------------------------------------ plain version

def _rows_product(x: torch.Tensor, f: int, rnd) -> torch.Tensor:
    """rnd(x) H_f on the last axis in blocks of f (float32 sums)."""
    H = hadamard_factor(f, device=x.device)
    sh = x.shape
    y = torch.matmul(rnd(x).reshape(sh[:-1] + (sh[-1] // f, f)), H)
    return y.reshape(sh)


def _slab_product(x: torch.Tensor, f_b: int, rnd) -> torch.Tensor:
    """H_{f_b} rnd(slab) for every slab of f_b rows of x (B, L, M)."""
    B, L, M = x.shape
    H = hadamard_factor(f_b, device=x.device)
    y = torch.matmul(H, rnd(x).reshape(B, L // f_b, f_b, M))
    return y.reshape(B, L, M)


def _radix_product(x: torch.Tensor, f_a: int, rnd) -> torch.Tensor:
    """H_{f_a} rnd(x) across the f_a slabs of x (B, L, M)."""
    B, L, M = x.shape
    H = hadamard_factor(f_a, device=x.device)
    return torch.matmul(H, rnd(x).reshape(B, f_a, -1)).reshape(B, L, M)


def _butterflies(x: torch.Tensor, dim: int, f: int) -> torch.Tensor:
    """H_f in float32 butterflies (stride 1 first, the scripts'
    `_fwht_blocks` order) across f equal blocks of axis `dim`."""
    sh = x.shape
    d = dim % x.dim()
    y = x.reshape(sh[:d] + (f, sh[d] // f) + sh[d + 1:])
    h = 1
    while h < f:
        y = y.reshape(sh[:d] + (f // (2 * h), 2, h, sh[d] // f) + sh[d + 1:])
        a, b = y.select(d + 1, 0), y.select(d + 1, 1)
        y = torch.stack((a + b, a - b), d + 1)
        h *= 2
    return y.reshape(sh)


def exp_transform(mode: str, x: torch.Tensor, f_b: int,
                  rnd=round_bf16) -> torch.Tensor:
    """The transform H(x) of `mode` on x (B, L, M), each product's data
    operand passed through rnd (round_bf16 where the script of the mode
    rounds, the identity for float32)."""
    B, L, M = x.shape
    f_a = L // f_b
    if mode == "no_transform":
        return x
    if mode == "l256_m128":
        t = _butterflies(_rows_product(x, 128, rnd), -1, M // 128)
        return _butterflies(_slab_product(t, f_b, rnd), -2, f_a)
    w = _rows_product(x, M, rnd)
    if mode == "m_stage_only":
        return w
    w = _slab_product(w, f_b, rnd)
    if mode in ("f512_vpu2", "f256_vpu4", "f128_vpu8"):
        return _butterflies(w, -2, f_a)
    return _radix_product(w, f_a, rnd)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def kernel_transform(mode: str, x: torch.Tensor, adjoint: bool,
                     f_b: int = 128, rnd=round_bf16) -> torch.Tensor:
    """The transform of S2's modes and the pair on x (B, L, M), rounded
    through rnd where the K1-style kernels round: forward
    H_L rnd(H_M rnd(x)), adjoint H_M rnd(H_L rnd(x)), H_L = H_{L / f_b}
    (x) H_{f_b} in float32 (the identity for m_stage_only; no_transform
    is the identity and rounds nothing)."""
    if mode == "no_transform":
        return x
    B, L, M = x.shape

    def h_l(v):
        if mode == "m_stage_only":
            return v
        return _radix_product(_slab_product(v, f_b, _same), L // f_b, _same)

    if adjoint:
        return _rows_product(rnd(h_l(rnd(x))), M, _same)
    return h_l(rnd(_rows_product(rnd(x), M, _same)))


def amp_exp_reference(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
                      sq_npl: torch.Tensor, P: float, n: int, T: int,
                      f_b: int = 128, pair: bool = False,
                      precision: str = "bf16", order: str = "script"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the experiments: returns (beta (B, L, M),
    tau2 trace (T, B), or (T, B / 2) with pair=True, the first codeword of
    each pair).  y_n (B, L, M) is the observation embedded on the row
    support, mask (L, M) the 0/1 support, sq_npl (L,) sqrt(n P_l); f_b the
    slab height of H_L = H_{L / f_b} (x) H_{f_b}.  precision "bf16" rounds
    as the scripts do, or with order="kernel" (S2's modes and the pair)
    as the K1-style kernels do (`kernel_transform`); "highest"
    rounds nothing.  Runs on any device (TF32 is never used: callers on
    the GPU turn matmul TF32 off)."""
    B, L, M = y_n.shape
    _check_mode(mode, L, M, f_b, B, pair)
    if precision not in ("bf16", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    if order not in ("script", "kernel"):
        raise ValueError(f"unknown order {order!r}")
    if order == "kernel" and mode in S3_MODES:
        raise ValueError(f"order='kernel' is the K1-style variants' (S2 and "
                         f"the pair), not {mode!r}'s")
    rnd = round_bf16 if precision == "bf16" else _same
    if order == "kernel":
        def transform(x, adjoint):
            return kernel_transform(mode, x, adjoint, f_b, rnd)
    else:
        def transform(x, adjoint):
            return exp_transform(mode, x, f_b, rnd)
    inv_sqrt_n = 1.0 / math.sqrt(n)
    mask = mask.to(torch.float32)
    sq = sq_npl.to(torch.float32).reshape(L, 1)
    beta = torch.zeros_like(y_n)
    z = torch.zeros_like(y_n)
    trace = torch.empty((T, B), dtype=torch.float32, device=y_n.device)
    tau2_prev = torch.full((B,), math.inf, device=y_n.device)
    for t in range(T):
        if mode == "no_norms":
            coef = torch.full((B,), 0.1, device=y_n.device)
        elif t == 0:
            coef = torch.zeros((B,), device=y_n.device)
        else:
            coef = (P - (beta * beta).sum((1, 2)) / n) / tau2_prev
        w = transform(beta, False)
        z = mask * (y_n - w * inv_sqrt_n) + coef[:, None, None] * z
        if mode == "no_norms":
            tau2 = torch.full((B,), 0.5, device=y_n.device)
        else:
            tau2 = (z * z).sum((1, 2)) / n
        s = transform(z, True) * inv_sqrt_n + beta
        ai = sq / tau2[:, None, None]
        if mode == "no_softmax":
            beta = s * ai * 1e-3
        else:
            a = ai * s
            if mode != "no_max":
                a = a - a.amax(-1, keepdim=True)
            e = torch.exp(a)
            beta = (sq / e.sum(-1, keepdim=True)) * e
        trace[t] = tau2
        tau2_prev = tau2
    return beta, (trace[:, 0::2] if pair else trace)


# ------------------------------------------------------------ the kernels

def amp_exp(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
            sq_npl: torch.Tensor, P: float, n: int, T: int,
            precision: str = "bf16") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run variant `mode` of the experiments on y_n (B, L, M): returns
    (beta (B, L, M), tau2 trace (T, B), or (T, B / 2) for "pair").

    On a CPU tensor `amp_exp_reference` with the mode's f_b
    (`mode_f_b`); on a CUDA tensor the mode's kernel in csrc/amp_exp.cu,
    which takes L = 1024 and M = 512 (the scripts' shape), float32
    contiguous y_n, and raises on anything else.  precision "bf16" rounds
    the transforms' operands to bf16; "highest" rounds nothing (S2's
    variants and the pair only: S3's factors run on the bf16 tensor
    cores)."""
    B, L, M = y_n.shape
    pair = mode in S1_MODES
    f_b = mode_f_b(mode, L)
    _check_mode(mode, L, M, f_b, B, pair)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if precision not in ("bf16", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision != "bf16" and mode in S3_MODES:
        raise ValueError(f"{mode} runs its factors on the bf16 tensor "
                         f"cores: precision must be 'bf16'")
    if y_n.device.type == "cpu":
        return amp_exp_reference(mode, y_n, mask, sq_npl, P, n, T, f_b, pair,
                                 precision)
    if y_n.device.type != "cuda":
        raise ValueError(f"amp_exp runs on cpu or cuda, not {y_n.device}")
    return _launch(mode, y_n, mask, sq_npl, P, n, T, precision == "bf16")


def _full_runtime_m(y_n: torch.Tensor, mask: torch.Tensor,
                    sq_npl: torch.Tensor, P: float, n: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """"full" in bf16 on the card with its column stage taking the row
    length M at run time, as K1's dense column stage did before K1 was
    redesigned on the row support, in place of the compile-time 512: the
    same decode bit for bit, a diagnostic of what a compile-time M gives
    this dense design (its time against full's) for chip_smoke.py's phase
    27.  Nothing of K1 runs it now; it goes with its switch in amp_exp.cu
    (ROADMAP.md, Queue B)."""
    if y_n.device.type != "cuda":
        raise ValueError(f"the diagnostic runs on cuda, not {y_n.device}")
    return _launch("full", y_n, mask, sq_npl, P, n, T, True, runtime_m=True)


def _launch(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
            sq_npl: torch.Tensor, P: float, n: int, T: int, bf16: bool,
            runtime_m: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    from ._build import run
    from .amp_kernel import _check_cuda_tensor

    B, L, M = y_n.shape
    if (L, M) != (KERNEL_L, KERNEL_M) or not 1 <= B <= 65535:
        raise ValueError(f"the experiment kernels take L = {KERNEL_L}, "
                         f"M = {KERNEL_M} and B <= 65535; got B={B}, L={L}, "
                         f"M={M}")
    dev = y_n.device
    _check_cuda_tensor("y_n", y_n, torch.float32, (B, L, M), dev)
    _check_cuda_tensor("mask", mask, torch.float32, (L, M), dev)
    _check_cuda_tensor("sq_npl", sq_npl, torch.float32, (L,), dev)
    mask_k = mask.to(torch.bfloat16)
    beta = torch.empty((B, L, M), dtype=torch.float32, device=dev)
    trace = torch.empty((T, B), dtype=torch.float32, device=dev)
    z = torch.empty_like(beta)
    # the work tile between the stages: H_M of beta (forward) and H_L of z
    # (adjoint), in bf16 as K1's bf16 mode keeps it
    work = torch.empty_like(beta, dtype=torch.bfloat16 if bf16 else None)
    zpart = torch.empty((B, M // 32), dtype=torch.float32, device=dev)
    bpart = torch.empty((B, L), dtype=torch.float32, device=dev)
    run("amp_exp", "amp_exp_run", dev, MODES.index(mode), y_n.data_ptr(),
        mask_k.data_ptr(), sq_npl.data_ptr(), beta.data_ptr(),
        trace.data_ptr(), z.data_ptr(), work.data_ptr(), zpart.data_ptr(),
        bpart.data_ptr(), B, L, M, T, float(P), float(n),
        1.0 / math.sqrt(n), int(bf16), int(runtime_m))
    amp_exp.launches[mode] += 1
    return beta, (trace[:, 0::2] if mode in S1_MODES else trace)


# kernel runs by mode, one per amp_exp call on a CUDA tensor (each call
# is 2 T launches), never counted on the CPU route
amp_exp.launches = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    """Set every mode's count of kernel runs to 0."""
    amp_exp.launches = dict.fromkeys(MODES, 0)
