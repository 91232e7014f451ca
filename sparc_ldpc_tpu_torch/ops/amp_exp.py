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
  S1 (pair_kernel_exp): "pair", the "full" decode two codewords at a time
      (on the card: in the row stage); its trace holds the first codeword
      of each pair.

The plain version's arithmetic is the scripts' (`amp_exp_reference`,
order="script"): beta in true scale, a 0/1 mask, and per iteration

    coef  = (P - |beta|^2 / n) / tau2_prev   (0 at t = 0)
    z     = mask (y - H(beta) / sqrt(n)) + coef z
    tau2  = |z|^2 / n
    beta  = sq softmax_row((sq / tau2) (H(z) / sqrt(n) + beta))

with H(x) = H_{f_a} H_{f_b} (x H_M), H_M along each section row first,
then H_{f_b} down each slab of f_b rows, then H_{f_a} across the slabs.
It rounds where the scripts round: the data operand of every product is
rounded to bfloat16 (the H_M product, each slab's H_{f_b} product and,
where H_{f_a} is a product, that one), the sums are float32, and the
butterflies of S3's radix factors are float32 on unrounded values.

The CUDA kernels (csrc/amp_exp.cu) run on K1's own design
(csrc/amp_k1.cuh, its row-support design): K1's compact encode of y on
the row support, a column stage walking (codeword, strip) items and K1's
row stage, in K1's scale-free form (ops/amp_kernel.py: beta' = beta
sqrt(n), mask / n, sq / sqrt(n) and sq sqrt(n)). S2's variants are K1's
column and row kernels at a compile-time variant, "full" K1's own
instantiation, so its decode is `amp_fused(..., split=True)` at fixed T
with y given, bit for bit; the pair is K1's column stage and K1's row
stage at its paired variant (a warp takes a section row of two
codewords), so its bits are full's too; S3's have a column stage of
their own (H_{f_b} on the tensor cores) beside K1's row stage
(l256_m128: its own). Every kernel's adjoint applies H_L first, in the
column stage, and H_M after it, in the row stage, so it rounds the
adjoint at other places than the scripts (ops/amp_kernel.py says the
same of K1): the decoding modes agree with their plain version in
distribution (decisions and tau2, the bf16 decode contract). The ablated
modes' garbage decodes amplify that difference, so
`amp_exp_reference(order="kernel")` computes S2's modes and the pair as
the kernels do, forward H_L rnd(H_M rnd(x)) and adjoint H_M rnd(H_L
rnd(z)), in K1's scale-free form and K1's float32 arithmetic step for
step (`k1_form_reference`: its butterflies' order, its reductions'
order, its contracted multiply-adds; the pair's is full's). The kernels
take the scripts' shape only, L = 1024 and M = 512.

On a CPU tensor `amp_exp` runs `amp_exp_reference`; on a CUDA tensor it
launches the mode's kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .amp_kernel import _constants
from .fwht import hadamard_factor, round_bf16
from .split_support import (SplitSupport, split_geometry,
                            split_support_from_mask)

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


# ------------------------------------------------- K1's float32 arithmetic
#
# S2's kernels are K1's own (csrc/amp_k1.cuh), and their garbage decodes
# amplify any float32 difference through the next bf16 rounding.  So the
# plain version of their order repeats K1's float32 arithmetic step for
# step: the butterflies in K1's stage order, every reduction in K1's order
# (a thread's partial, the warp's xor tree, the block's warps in turn, the
# strips in turn), and each contracted multiply-add (fmaf, one rounding)
# as one.  Left: exp, which may differ in its last bit off the card.


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once, as the kernels' contracted multiply-adds: for
    float32 through float64, where the product is exact."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def _bfly(x: torch.Tensor, dim: int, bits) -> torch.Tensor:
    """Radix-2 butterflies (a + b, a - b) over the given bits of the index
    along `dim`, one stage a bit in the order given."""
    y = x.movedim(dim, -1)
    lead, N = y.shape[:-1], y.shape[-1]
    for b in bits:
        h = 1 << b
        y = y.reshape(lead + (N // (2 * h), 2, h))
        lo, hi = y[..., 0, :], y[..., 1, :]
        y = torch.stack((lo + hi, lo - hi), -2).reshape(lead + (N,))
    return y.movedim(-1, dim)


def _k1_h(x: torch.Tensor, axis: str, adjoint: bool) -> torch.Tensor:
    """K1's H_M (each row, its column bits ascending: warp_row_fwht) or
    H_L (each column: layout A's register bits, the high log2(L / W) row
    bits, then layout B's low log2(W); the adjoint in the other order)."""
    B, L, M = x.shape
    if axis == "m":
        return _bfly(x, -1, range(M.bit_length() - 1))
    W = split_geometry(L)[0]
    lo, hi = range(W.bit_length() - 1), range(W.bit_length() - 1,
                                               L.bit_length() - 1)
    return _bfly(x, -2, (*lo, *hi) if adjoint else (*hi, *lo))


def _pairs(x: torch.Tensor) -> torch.Tensor:
    """The xor tree over the last axis, adjacent pairs first (a row's
    lanes, warp_row_reduce)."""
    while x.shape[-1] > 1:
        x = x.reshape(x.shape[:-1] + (-1, 2))
        x = x[..., 0] + x[..., 1]
    return x[..., 0]


def _halves(x: torch.Tensor) -> torch.Tensor:
    """The xor tree over the last axis, halves first (warp_sum)."""
    h = x.shape[-1] // 2
    while h >= 1:
        x = x[..., :h] + x[..., h:2 * h]
        h //= 2
    return x[..., 0]


def _in_turn(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` one term after another, from the first."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _k1_row_sum(x: torch.Tensor, square: bool = False) -> torch.Tensor:
    """Each row's sum of x (B, L, M), or of x^2 with contracted
    multiply-adds, in K1's row-stage order (RowShape, warp_row_reduce):
    lane j holds columns C j + C TPR (i / C) + i % C, each group of 4 is
    summed in turn, then the groups' xor tree (M <= 128), or per chunk of
    8 columns the tree over lanes 0-15 and over 16-31, and those in column
    order."""
    B, L, M = x.shape
    VPL = max(4, M // 32)
    TPR, C = M // VPL, min(VPL, 8)
    j = torch.arange(TPR)[:, None]
    i = torch.arange(VPL)[None, :]
    cols = (C * j + C * TPR * (i // C) + i % C).to(x.device)
    v = x[..., cols].reshape(B, L, TPR, VPL // 4, 4)
    if square:
        p = torch.zeros_like(v[..., 0])
        for q in range(4):
            p = _fma(v[..., q], v[..., q], p)
    else:
        p = _in_turn(v, -1)
    if C == 4:
        return _pairs(p[..., 0])
    cs = p[..., 0::2] + p[..., 1::2]          # (B, L, 32 lanes, chunks)
    half = _pairs(cs.reshape(B, L, 2, 16, -1).movedim(3, -1))
    acc = half[:, :, 0, 0] + half[:, :, 1, 0]
    for c in range(1, half.shape[-1]):
        acc = acc + half[:, :, 0, c]
        acc = acc + half[:, :, 1, c]
    return acc


def _k1_tau2(z: torch.Tensor, n: int) -> torch.Tensor:
    """|z|^2 / n as K1 takes it: each column-stage thread (w, c) of strip s
    adds its rows R w + k in turn (contracted), the warp's lanes by its
    xor tree, the block's W warps in turn, then the strips in turn."""
    B, L, M = z.shape
    W, R, _ = split_geometry(L)
    zz = z.reshape(B, W, R, M // 32, 32)
    acc = torch.zeros_like(zz[:, :, 0])
    for k in range(R):
        acc = _fma(zz[:, :, k], zz[:, :, k], acc)
    zpart = _in_turn(_halves(acc), 1)          # (B, M / 32)
    return _in_turn(zpart, 1) / n


def _k1_bnorm2(bpart: torch.Tensor) -> torch.Tensor:
    """|beta'|^2 from the rows' partials (B, L) as K1's column stage takes
    it: thread t holds row t, the warp's lanes by its xor tree, the block's
    W warps in turn."""
    B, L = bpart.shape
    W = split_geometry(L)[0]
    pad = torch.zeros((B, 32 * W - L), dtype=bpart.dtype,
                      device=bpart.device)
    return _in_turn(_halves(torch.cat((bpart, pad), 1).reshape(B, W, 32)), 1)


def k1_form_reference(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
                      sq_npl: torch.Tensor, P: float, n: int, T: int,
                      rnd=round_bf16) -> Tuple[torch.Tensor, torch.Tensor]:
    """S2's mode `mode` as its kernel computes it (csrc/amp_k1.cuh): K1's
    scale-free form (`amp_fused_reference`'s, fixed T, y given) in K1's
    float32 arithmetic (above), the transforms' inputs rounded through rnd
    where K1 rounds them (forward H_L rnd(H_M rnd(beta')), adjoint
    H_M rnd(H_L rnd(z))), with the mode's stage dropped: no_transform
    neither H (the work tile carries rnd(beta') and rnd(z)), m_stage_only
    no H_L, no_softmax beta' = (sqi / tau2) (H z + beta') 1e-3 sqrt(n),
    no_max the softmax without its row max, no_norms coef = 0.1 and
    tau2 = 0.5.  Returns (beta (B, L, M) true scale, tau2 trace (T, B))."""
    B, L, M = y_n.shape
    dt, dev = y_n.dtype, y_n.device
    mask_n, sqi, sqo = _constants(mask, sq_npl, n)
    flat = torch.nonzero(mask.reshape(-1) > 0).reshape(-1).to(dev)
    m_c = mask_n.reshape(-1)[flat]
    y_c = y_n.reshape(B, -1)[:, flat]

    def scalar(x):
        return torch.tensor(x, dtype=dt, device=dev)

    def h(x, axis, adjoint):
        if axis == "l" and mode in ("m_stage_only", "no_transform"):
            return x
        if axis == "m" and mode == "no_transform":
            return x
        return _k1_h(x, axis, adjoint)

    nn = scalar(float(n)) * scalar(float(n))
    beta = torch.zeros_like(y_n)
    z_c = y_c
    trace = torch.empty((T, B), dtype=dt, device=dev)
    tau2 = None
    for t in range(T):
        if t > 0:
            if mode == "no_norms":
                coef = scalar(0.1).expand(B)
            else:
                bpart = _k1_row_sum(beta, square=True)
                coef = (scalar(P) - _k1_bnorm2(bpart) / nn) / tau2
            w = h(rnd(h(rnd(beta), "m", False)), "l", False)
            zn = _fma(-m_c, w.reshape(B, -1)[:, flat], y_c)
            z_c = _fma(coef[:, None].expand_as(z_c), z_c, zn)
        z = torch.zeros((B, L * M), dtype=dt, device=dev)
        z[:, flat] = z_c
        z = z.reshape(B, L, M)
        if mode == "no_norms":
            tau2 = scalar(0.5).expand(B)
        else:
            tau2 = _k1_tau2(z, n)
        v = h(rnd(h(rnd(z), "l", True)), "m", True)
        if t > 0:
            v = v + beta
        v = (sqi / tau2[:, None, None]) * v
        if mode == "no_softmax":
            beta = v * (scalar(1e-3) / scalar(1.0 / math.sqrt(n)))
        else:
            if mode != "no_max":
                v = v - v.amax(-1, keepdim=True)
            e = torch.exp(v)
            beta = (sqo / _k1_row_sum(e)[..., None]) * e
        trace[t] = tau2
    return beta * (1.0 / math.sqrt(n)), trace


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
    as their kernels do, in K1's scale-free form (`k1_form_reference`;
    the pair's is full's); "highest" rounds nothing.  Runs on any device (TF32 is never
    used: callers on the GPU turn matmul TF32 off)."""
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
        beta, trace = k1_form_reference("full" if pair else mode, y_n, mask,
                                        sq_npl, P, n, T, rnd)
        return beta, (trace[:, 0::2] if pair else trace)

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
            precision: str = "bf16",
            support: Optional[SplitSupport] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run variant `mode` of the experiments on y_n (B, L, M): returns
    (beta (B, L, M), tau2 trace (T, B), or (T, B / 2) for "pair").

    On a CPU tensor `amp_exp_reference` with the mode's f_b
    (`mode_f_b`); on a CUDA tensor the mode's kernel in csrc/amp_exp.cu,
    which takes L = 1024 and M = 512 (the scripts' shape), float32
    contiguous y_n, and raises on anything else.  precision "bf16" rounds
    the transforms' operands to bf16; "highest" rounds nothing (S2's
    variants and the pair only: S3's factors run on the bf16 tensor
    cores).  support: K1's tables of mask (`amp_fused`'s argument, the
    operator's `split_support`), which the kernels read y and z by;
    without it a CUDA call builds them from mask, which waits for the
    device."""
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
    return _launch(mode, y_n, mask, sq_npl, P, n, T, precision == "bf16",
                   support)


def _launch(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
            sq_npl: torch.Tensor, P: float, n: int, T: int, bf16: bool,
            support: Optional[SplitSupport]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    from ._build import run
    from .amp_kernel import _check_cuda_tensor, _check_support

    B, L, M = y_n.shape
    if (L, M) != (KERNEL_L, KERNEL_M) or not 1 <= B <= 65535:
        raise ValueError(f"the experiment kernels take L = {KERNEL_L}, "
                         f"M = {KERNEL_M} and B <= 65535; got B={B}, L={L}, "
                         f"M={M}")
    dev = y_n.device
    _check_cuda_tensor("y_n", y_n, torch.float32, (B, L, M), dev)
    _check_cuda_tensor("mask", mask, torch.float32, (L, M), dev)
    _check_cuda_tensor("sq_npl", sq_npl, torch.float32, (L,), dev)
    beta = torch.empty((B, L, M), dtype=torch.float32, device=dev)
    trace = torch.empty((T, B), dtype=torch.float32, device=dev)
    # the work tile between the stages: H_M of beta' (forward) and H_L of z
    # (adjoint), in bf16 as K1's bf16 mode keeps it
    work = torch.empty_like(beta, dtype=torch.bfloat16 if bf16 else None)
    zpart = torch.empty((B, M // 32), dtype=torch.float32, device=dev)
    bpart = torch.empty((B, L), dtype=torch.float32, device=dev)
    # K1's arguments (amp_fused's split form at fixed T, y given)
    if support is None:
        support = split_support_from_mask(mask)
    _check_support(support, L, M, dev)
    mask_n, sqi, sqo = _constants(mask, sq_npl, n)
    mask_c = support.gather(mask_n)
    yc = torch.empty((B, support.ns), dtype=torch.float32, device=dev)
    zc = torch.empty_like(yc)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    active = torch.ones((T + 1, B), dtype=torch.int32, device=dev)
    run("amp_exp", "amp_exp_run", dev, MODES.index(mode), y_n.data_ptr(),
        mask_c.data_ptr(), support.offset.data_ptr(), support.word.data_ptr(),
        support.block_offset.data_ptr(), support.ns, sqi.data_ptr(),
        sqo.data_ptr(), beta.data_ptr(), trace.data_ptr(), iters.data_ptr(),
        active.data_ptr(), yc.data_ptr(), zc.data_ptr(), work.data_ptr(),
        zpart.data_ptr(), bpart.data_ptr(), B, L, M, T, float(P), float(n),
        1.0 / math.sqrt(n), int(bf16))
    amp_exp.launches[mode] += 1
    return beta, (trace[:, 0::2] if mode in S1_MODES else trace)


# kernel runs by mode, one per amp_exp call on a CUDA tensor (each call
# is an encode launch and 2 T iteration launches), never counted on the
# CPU route
amp_exp.launches = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    """Set every mode's count of kernel runs to 0."""
    amp_exp.launches = dict.fromkeys(MODES, 0)
