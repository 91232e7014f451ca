"""Whole-trial AMP decode on the (L, M) section tile (port of
sparc_ldpc_tpu/ops/amp_kernel.py `amp_fused` with its split kernel
`_amp_kernel_split`, its monolithic kernel `_amp_kernel` and its slab
kernel `_amp_kernel_slab`: optional in-kernel encode, per-codeword early
stop, decision-feedback pinning and an SE tau2 schedule; in-kernel noise
on the split form).

Forms, routed as the reference routes them: "split" (csrc/amp_split.cu,
L up to 4096), "mono" (csrc/amp_mono.cu, L <= 1024) and "slab"
(csrc/amp_slab.cu, L up to 4096, only when asked for: amp_kernel=
"fused_slab").  With neither `split` nor `form` given, L > 1024 takes the
split form and L <= 1024 the mono form; `split=True` (amp_kernel=
"fused_split") forces the split form.  The forms differ in where their
transforms round and, for the slab form, in how tau2 and |beta'|^2 are
summed (below).

With the Kronecker split N = L * M and ML == N, the transform of a
codeword is H_L @ X @ H_M on its (L, M) tile, the same tile the sectionwise
softmax works on.  `amp_fused` runs all T iterations:

    z     = y - mask/n * H(beta') + coef * z,   coef = (P - |beta'|^2/n^2) / tau2_prev
    tau2  = |z|^2 / n
    beta' = sqo * softmax_row((sqi / tau2) * (H(z) + beta'))

(tau2 from an SE schedule when one is given; pinned rows overridden after
the softmax; a codeword frozen once its tau2 plateaus within tol; the
channel noise drawn inside the kernel from per-codeword seeds) in the
reference's scale-free form (beta' = beta * sqrt(n), sqi = sq /
sqrt(n), sqo = sq * sqrt(n)).  As in the reference's split kernel, the data
operand of each transform stage is rounded to bfloat16 and the sums are
float32.  The reference's mono kernel computes bf16(x) @ H_M and then
H_L @ (that) with the float32 intermediate as it is, so its transforms
round each operand once, before H_M, and apply H_L in float32
(`mono_tile_reference`).  The encode transform is float32 on both forms,
so codeword power is exact to float32 (the reference's mono and split
kernels encode in two bf16 passes, hi and lo, which reach about 2^-16).

On a CUDA tensor `amp_fused` launches the hand-written kernel of its form
or raises; on a CPU tensor it runs `amp_fused_reference`, the plain
PyTorch version of the same function.  The split form's plain version
rounds where the reference kernel does: before the H_M stage and before
the H_L stage of both transforms.  The split form's CUDA kernel's
adjoint transform applies H_L first (its column stage feeds the row-wise
softmax), so its second rounding falls after H_L instead.  In float32
(precision="highest") the two agree to summation order; with bf16
rounding they draw different rounding noise, which T iterations amplify
at near-tie sections, so they agree in distribution.

The slab form (K7) computes the split form's transform, H_M first in both
transforms with the data rounded to bf16 before the H_M stage and before
the H_L stage, as the reference's slab kernel does (`_mm`, then `_mml`);
its CUDA kernel keeps that order, so kernel and plain version round at the
same places and differ in summation order only.  It computes in bf16 only
(its two 128-wide factors run on the tensor cores).  Its tau2 and
|beta'|^2 are the reference's per-slab partial sums: each slab of f_b rows
summed, then the f_a slabs added in slab order (`slab_geometry`).

In-kernel noise (`noise_seed`): Philox4x32-10 keyed by the codeword's two
seed words, with the counter (m, l // 4, 0, 0) for element (l, m) of the
(L, M) tile, and both outputs of Box-Muller on the reference's 24-bit
uniforms (csrc/amp_split.cu states the layout).  `philox4x32` and
`noise_uniforms_reference` are the same generator in PyTorch integer
arithmetic, so the kernel and its plain version draw identical uniforms;
their normals differ only in the last bits of log, sin and cos.  The
stream is not the reference's TPU PRNG stream (nor jax.random's), so
against JAX it agrees in distribution only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..utils.profiling import annotate, count, tracing
from .fwht import fwht_kron, round_bf16
from .split_support import (SplitSupport, split_geometry,
                            split_support_from_mask)

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


def _check_support(sp: SplitSupport, L: int, M: int, device) -> None:
    """The split and mono kernels' tables fit an (L, M) tile on device."""
    if (sp.L, sp.M) != (L, M):
        raise ValueError(f"the support tables are of an ({sp.L}, {sp.M}) "
                         f"tile, not ({L}, {M})")
    W, R, FA = split_geometry(L)
    ns = sp.ns
    for name, t, dtype, shape in (
            ("offset", sp.offset, torch.int32, (L // R, M)),
            ("word", sp.word, torch.int32, (L // R, M)),
            ("block_offset", sp.block_offset, torch.int32,
             (FA * M // 32 + 1,)),
            ("flat", sp.flat, torch.int64, (ns,)),
            ("perm", sp.perm, torch.int32, (ns,)),
            ("row_offset", sp.row_offset, torch.int32, (L + 1,))):
        _check_cuda_tensor(f"support.{name}", t, dtype, shape, device)


def _supported_dim(d: int, hi: int = 1024) -> bool:
    return 32 <= d <= hi and d & (d - 1) == 0


def _check_cuda_shape(B: int, L: int, M: int, max_l: int = 4096):
    """The kernels take L, M powers of two, L in [32, max_l] (4096, the
    reference's gate for the fused route; 1024 on the mono form) and M in
    [32, 1024]."""
    if not (_supported_dim(L, max_l) and _supported_dim(M)
            and 1 <= B <= 65535):
        raise ValueError(f"the CUDA kernel takes L, M powers of two, L in "
                         f"[32, {max_l}], M in [32, 1024], and B <= 65535; "
                         f"got B={B}, L={L}, M={M}")


def mono_tile_reference(x: torch.Tensor, precision: str = "bf16"
                        ) -> torch.Tensor:
    """Plain version of the mono form's transform of each tile of x
    (..., L, M): H_L @ (bf16(x) @ H_M), i.e. the data rounded once, before
    H_M, and H_L applied in float32 ("bf16"); any other precision keeps
    float32 throughout."""
    return _axis_stage(_axis_stage(x, -1, precision == "bf16"), -2, False)


def _parity_signs(cols: torch.Tensor, M: int, dtype) -> torch.Tensor:
    """(len(cols), M): (-1)^popcount(col & m), the rows of H_M at cols."""
    m = torch.arange(M, device=cols.device)
    x = cols[:, None] & m[None, :]
    par = torch.zeros_like(x)
    while bool(x.any()):
        par ^= x & 1
        x = x >> 1
    return (1 - 2 * par).to(dtype)


def mono_adjoint_reference(zc: torch.Tensor, support: SplitSupport
                           ) -> torch.Tensor:
    """Plain version of K6's adjoint from the compact z (B, ns), in the
    split kernel's order of the support entries (`support`): each row's
    bf16(z) H_M built from its support entries alone, (bf16(z) H_M)[l][m] =
    sum over the row's entries (m', z) of (-1)^popcount(m' & m) bf16(z),
    then H_L in zc's dtype (float32; float64 sums for float64).  The same
    function as `mono_tile_reference` of z embedded in its (L, M) tile."""
    L, M = support.L, support.M
    B = zc.shape[0]
    flat = support.flat.to(zc.device)
    rows, cols = flat // M, flat % M
    terms = round_bf16(zc)[:, :, None] * _parity_signs(cols, M, zc.dtype)
    u = torch.zeros((B, L, M), dtype=zc.dtype, device=zc.device)
    u.index_add_(1, rows, terms)
    return fwht_kron(u, "highest", -2)


def pack_entries(zc: torch.Tensor, support: SplitSupport) -> torch.Tensor:
    """The compact z (B, ns) float32 as K6's column stage leaves it for its
    adjoint: each entry bf16(z) with its column, (bf16 bits << 16) | m, as
    int32 bit patterns in row-major order of the entries."""
    M = support.M
    bits = zc.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    word = (bits << 16) | (support.flat.to(zc.device) % M)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    out = torch.empty_like(word)
    out[:, support.perm.to(zc.device).long()] = word
    return out.to(torch.int32)


def mono_adjoint(zc: torch.Tensor, support: SplitSupport) -> torch.Tensor:
    """K6's adjoint alone, H_L (bf16(z) H_M) (B, L, M) float32 from the
    compact z (B, ns) float32 in the split kernel's order of `support`'s
    entries: on a CUDA tensor the decode's column launch (csrc/amp_mono.cu
    `amp_mono_adjoint`, on z packed as its column stage packs it), on a
    CPU tensor `mono_adjoint_reference`."""
    if zc.device.type == "cpu":
        return mono_adjoint_reference(zc, support)
    if zc.device.type != "cuda":
        raise ValueError(f"mono_adjoint runs on cpu or cuda, not "
                         f"{zc.device}")
    from ._build import run

    L, M = support.L, support.M
    B = zc.shape[0]
    _check_cuda_shape(B, L, M, max_l=1024)
    _check_support(support, L, M, zc.device)
    _check_cuda_tensor("zc", zc, torch.float32, (B, support.ns), zc.device)
    zr = pack_entries(zc, support)
    out = torch.empty((B, L, M), dtype=torch.float32, device=zc.device)
    run("amp_mono", "amp_mono_adjoint", zc.device, zr.data_ptr(),
        support.row_offset.data_ptr(), support.ns, out.data_ptr(), B, L, M)
    return out


def slab_adjoint_reference(zc: torch.Tensor, support: SplitSupport
                           ) -> torch.Tensor:
    """Plain version of K7's adjoint from the compact z (B, ns), in the
    split kernel's order of the support entries (`support`): z embedded in
    its (L, M) tile, then `fwht_tile_reference(., "bf16")`, H_L bf16(H_M
    bf16(z)) with float32 sums (float64 for float64)."""
    L, M = support.L, support.M
    B = zc.shape[0]
    dense = torch.zeros((B, L * M), dtype=zc.dtype, device=zc.device)
    dense[:, support.flat.to(zc.device)] = zc
    return fwht_tile_reference(dense.reshape(B, L, M), "bf16")


def slab_adjoint(zc: torch.Tensor, support: SplitSupport) -> torch.Tensor:
    """K7's adjoint alone, H_L bf16(H_M bf16(z)) (B, L, M) float32 from the
    compact z (B, ns) float32 in the split kernel's order of `support`'s
    entries: on a CUDA tensor the decode's adjoint launch (csrc/amp_slab.cu
    `amp_slab_adjoint`: each row's H_M from its bf16 entries, rounded to
    bf16, then H_L on the tensor cores; z packed as its column launch
    packs it), on a CPU tensor `slab_adjoint_reference`."""
    if zc.device.type == "cpu":
        return slab_adjoint_reference(zc, support)
    if zc.device.type != "cuda":
        raise ValueError(f"slab_adjoint runs on cpu or cuda, not "
                         f"{zc.device}")
    from ._build import run

    L, M = support.L, support.M
    B = zc.shape[0]
    _check_cuda_shape(B, L, M)
    _check_support(support, L, M, zc.device)
    _check_cuda_tensor("zc", zc, torch.float32, (B, support.ns), zc.device)
    zr = pack_entries(zc, support)
    out = torch.empty((B, L, M), dtype=torch.float32, device=zc.device)
    run("amp_slab", "amp_slab_adjoint", zc.device, zr.data_ptr(),
        support.row_offset.data_ptr(), support.ns, out.data_ptr(), B, L, M)
    return out


def slab_tile(x: torch.Tensor) -> torch.Tensor:
    """The slab form's transform of each tile of x (B, L, M) float32,
    H_L bf16(H_M bf16(x)): on a CUDA tensor K7's two stages (H_{m_b} and
    H_{f_b} on the tensor cores, the radix factors in float32), on a CPU
    tensor `fwht_tile_reference(x, "bf16")`."""
    if x.device.type == "cpu":
        return fwht_tile_reference(x, "bf16")
    if x.device.type != "cuda":
        raise ValueError(f"slab_tile runs on cpu or cuda, not {x.device}")
    from ._build import run

    B, L, M = x.shape
    _check_cuda_shape(B, L, M)
    _check_cuda_tensor("x", x, torch.float32, (B, L, M), x.device)
    work = torch.empty_like(x, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    run("amp_slab", "amp_slab_tile", x.device, x.data_ptr(), work.data_ptr(),
        out.data_ptr(), B, L, M)
    return out


# K3 in bf16 runs on a cluster of M / 32 blocks a codeword up to this many
# rows (and M <= 512), through a bf16 intermediate in device memory above
# (csrc/amp_split.cu kK3ClusterRows: on an H100 the cluster won at l = 256
# and lost at 512 and 1024, PERF.md)
K3_CLUSTER_ROWS = 256


def k3_design(L: int, M: int, precision: str) -> str:
    """K3's design for (L, M) tiles: "cluster" (bf16, L <= K3_CLUSTER_ROWS
    and M <= 512: one launch on a cluster of M // 32 blocks a codeword,
    the bf16 intermediate in distributed shared memory), "rows_cols"
    (bf16 otherwise: a row and a column launch through a bf16
    intermediate in device memory, the column launch on clusters of
    L // 1024 blocks above L = 1024) or "float32" (any other precision:
    the AMP kernel's row and column stages)."""
    if precision != "bf16":
        return "float32"
    return "cluster" if L <= K3_CLUSTER_ROWS and M <= 512 else "rows_cols"


def fwht_tile(x: torch.Tensor, precision: str = "highest",
              scale: float = 1.0) -> torch.Tensor:
    """scale * (H_L (x) H_M) of each tile of x (B, L, M) float32 (H_M
    first; the scale applied once, in float32, to the result).

    K3, the reference's `fwht_tile_pallas` (the local transform of
    section-sharded AMP, scale 1/sqrt(n) there, always "bf16"): on a CUDA
    tensor csrc/amp_split.cu `amp_fwht_tile` in the design `k3_design`
    picks, on a CPU tensor `fwht_tile_reference(x, precision) * scale`."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if x.device.type == "cpu":
        out = fwht_tile_reference(x, precision)
        return out if scale == 1.0 else out * scale
    if x.device.type != "cuda":
        raise ValueError(f"fwht_tile runs on cpu or cuda, not {x.device}")
    from ._build import run

    B, L, M = x.shape
    _check_cuda_shape(B, L, M)
    _check_cuda_tensor("x", x, torch.float32, (B, L, M), x.device)
    design = k3_design(L, M, precision)
    out = torch.empty_like(x)
    # the two launches' bf16 intermediate; none on the other designs
    mid = (torch.empty_like(x, dtype=torch.bfloat16)
           if design == "rows_cols" else None)
    run("amp_split", "amp_fwht_tile", x.device, x.data_ptr(), out.data_ptr(),
        mid.data_ptr() if mid is not None else None, B, L, M,
        int(design != "float32"), float(scale))
    fwht_tile.launches += 1
    return out


fwht_tile.launches = 0


# ----------------------------------------------------------------- noise

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * a, a int64 in [0, 2^32): torch has no
    unsigned 32-bit multiply-high, so a is split into 16-bit halves and
    every partial product stays below 2^49."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(ctr, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 words in [0, 2^32):
    ctr a 4-tuple, key a 2-tuple of broadcastable tensors; returns the
    four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_words(noise_seed: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, 2) int32 seed bit patterns -> two (B, 1, 1) int64 key words."""
    s = noise_seed.to(torch.int64) & _MASK32
    return s[:, 0, None, None], s[:, 1, None, None]


def _philox_words(noise_seed: torch.Tensor, L: int, M: int):
    """The four Philox words of every (codeword, row quad, column): counter
    (m, q, 0, 0), key the codeword's seed; each (B, L // 4, M) int64."""
    if L % 4:
        raise ValueError(f"L must be a multiple of 4, got {L}")
    dev = noise_seed.device
    q = torch.arange(L // 4, dtype=torch.int64, device=dev)[:, None]
    m = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return philox4x32((m, q, zero, zero), _seed_words(noise_seed))


def _bm_uniforms(bits1: torch.Tensor, bits2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's 24-bit Box-Muller inputs (boxmuller_pair_f32):
    u1 = (bits1 >> 8) 2^-24 + 2^-25 in (0, 1) and theta = 2 pi (bits2 >> 8)
    2^-24, float32.  bits are integers in [0, 2^32)."""
    u1 = (bits1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    theta = (2.0 * math.pi) * (bits2 >> 8).to(torch.float32) * 2.0 ** -24
    return u1, theta


def box_muller(bits1: torch.Tensor, bits2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both Box-Muller outputs (r cos theta, r sin theta), r = sqrt(-2 ln
    u1): two independent standard normals per pair of 32-bit words."""
    u1, theta = _bm_uniforms(bits1, bits2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(theta), r * torch.sin(theta)


def noise_uniforms_reference(noise_seed: torch.Tensor, L: int, M: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, theta), each (B, L, M) float32: the Box-Muller inputs of every
    draw of the in-kernel noise (rows 2j and 2j + 1 share their pair's)."""
    x = _philox_words(noise_seed, L, M)
    pairs = (_bm_uniforms(x[0], x[1]), _bm_uniforms(x[2], x[3]))
    B = noise_seed.shape[0]

    def rows(t):                # (B, L/4, pair, M) -> rows 4q + 2 pair + s
        return t[:, :, :, None, :].expand(B, L // 4, 2, 2, M).reshape(B, L, M)

    return (rows(torch.stack([p[0] for p in pairs], 2)),
            rows(torch.stack([p[1] for p in pairs], 2)))


def channel_noise_reference(noise_seed: torch.Tensor, mask: torch.Tensor,
                            sigma: float) -> torch.Tensor:
    """Plain version of `channel_noise`: where(mask > 0, sigma * normal, 0),
    (B, L, M) float32, normal the in-kernel noise's draws."""
    L, M = mask.shape
    x = _philox_words(noise_seed, L, M)
    z = torch.stack(box_muller(x[0], x[1]) + box_muller(x[2], x[3]), 2)
    z = z.reshape(noise_seed.shape[0], L, M)   # rows 4q + {0, 1, 2, 3}
    return torch.where(mask > 0, sigma * z, 0.0)


def _check_seed(noise_seed, B, dev):
    _check_cuda_tensor("noise_seed", noise_seed, torch.int32, (B, 2), dev)


def channel_noise(noise_seed: torch.Tensor, mask: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """The in-kernel channel noise alone, (B, L, M): where(mask > 0,
    sigma * normal, 0) for noise_seed (B, 2) int32 (uint32 bit patterns)
    and mask (L, M).  On a CUDA tensor the encode launch of the AMP kernel
    with no codeword, on a CPU tensor `channel_noise_reference`."""
    if mask.device.type == "cpu":
        return channel_noise_reference(noise_seed, mask, sigma)
    from ._build import run

    dev = mask.device
    L, M = mask.shape
    B = noise_seed.shape[0]
    _check_cuda_shape(B, L, M)
    _check_cuda_tensor("mask", mask, torch.float32, (L, M), dev)
    _check_seed(noise_seed, B, dev)
    y = torch.empty((B, L, M), dtype=torch.float32, device=dev)
    run("amp_split", "amp_noise_run", dev, noise_seed.data_ptr(),
        mask.data_ptr(), float(sigma), y.data_ptr(), B, L, M)
    channel_noise.launches += 1
    return y


channel_noise.launches = 0


def noise_uniforms(noise_seed: torch.Tensor, L: int, M: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, theta) of every in-kernel noise draw, (B, L, M) each: on a CUDA
    tensor from the kernel's generator, on a CPU tensor
    `noise_uniforms_reference`."""
    if noise_seed.device.type == "cpu":
        return noise_uniforms_reference(noise_seed, L, M)
    from ._build import run

    dev = noise_seed.device
    B = noise_seed.shape[0]
    _check_cuda_shape(B, L, M)
    _check_seed(noise_seed, B, dev)
    u1 = torch.empty((B, L, M), dtype=torch.float32, device=dev)
    theta = torch.empty_like(u1)
    run("amp_split", "amp_noise_draws", dev, noise_seed.data_ptr(),
        u1.data_ptr(), theta.data_ptr(), B, L, M)
    return u1, theta


# ------------------------------------------------------------------- AMP

def _constants(mask, sq_npl, n):
    """Scale-free constants: mask/n, sq/sqrt(n) and sq*sqrt(n) (as (L, 1)),
    in sq_npl's dtype."""
    L = sq_npl.shape[0]
    mask_n = mask.to(sq_npl.dtype) / n
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


def fused_form(L: int, split: Optional[bool] = None,
               form: Optional[str] = None, noise: bool = False) -> str:
    """The kernel form `amp_fused` runs, "split", "mono" or "slab", routed
    as the reference's amp_fused routes (sparc_ldpc_tpu/ops/
    amp_kernel.py:891-909): form=None takes "split" when split is true, or
    when split is None and L > 1024, and "mono" otherwise; "mono" needs
    L <= 1024, "slab" L <= 4096; the in-kernel noise needs the split
    form."""
    if form is None:
        form = "split" if ((L > 1024) if split is None else split) else "mono"
    if form not in ("split", "mono", "slab"):
        raise ValueError(f"unknown form {form!r}")
    if form == "mono" and L > 1024:
        raise ValueError(f"the mono form takes L <= 1024, got L = {L}")
    if form == "slab" and L > 4096:
        raise ValueError(f"the slab form takes L <= 4096, got L = {L}")
    if noise and form != "split":
        raise ValueError("the in-kernel noise is implemented on the split "
                         "form only, as in the reference")
    return form


def slab_geometry(L: int, M: int) -> Tuple[int, int, int, int]:
    """(f_a, f_b, m_a, m_b) of the slab form, the reference's
    (sparc_ldpc_tpu/ops/amp_kernel.py:910-917): slabs of f_b = min(128, L)
    rows, f_a of them, and column blocks of m_b = 128 when 128 divides
    M > 128, else m_b = M, m_a of them."""
    f_b = min(128, L)
    m_b = 128 if (M > 128 and M % 128 == 0) else M
    return L // f_b, f_b, M // m_b, m_b


def _tile_sq_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-codeword sum of squares of x (B, L, M) over the whole tile."""
    return (x * x).sum((1, 2))


def _slab_sq_sum(x: torch.Tensor, f_b: int) -> torch.Tensor:
    """Per-codeword sum of squares of x (B, L, M) as the slab form takes
    it: each slab of f_b rows summed, then the slabs added in slab
    order."""
    parts = (x * x).reshape(x.shape[0], -1, f_b * x.shape[-1]).sum(-1)
    total = parts[:, 0]
    for a in range(1, parts.shape[1]):
        total = total + parts[:, a]
    return total


def amp_fused_reference(y_n: Optional[torch.Tensor], mask: torch.Tensor,
                        sq_npl: torch.Tensor, P: float, n: int, T: int,
                        encode_idx: Optional[torch.Tensor] = None,
                        precision: str = "bf16",
                        tol: float = 0.0,
                        pin_idx: Optional[torch.Tensor] = None,
                        tau2_schedule: Optional[torch.Tensor] = None,
                        noise_seed: Optional[torch.Tensor] = None,
                        noise_sigma: Optional[float] = None,
                        split: Optional[bool] = None,
                        form: Optional[str] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `amp_fused` (same arguments and results).

    The mono form is the reference's `_amp_kernel` (K6): each transform is
    `mono_tile_reference`, H_L @ (bf16(x) @ H_M); the split form's (K1)
    and the slab form's (K7) is `fwht_tile_reference`, rounding before
    both stages.  |beta'|^2 (from the state at the top of the iteration)
    and tau2 are sums over the whole tile, on the slab form per slab and
    then over the slabs in order (`_slab_sq_sum`).  Everything else is
    shared: the adjoint plus beta', the row softmax, the pin, the schedule
    and the tol freeze with the iterations count.  It computes in the
    dtype of y_n and sq_npl: float64 inputs give float64 sums (a witness
    of how far the float32 version's summation order moves a decode)."""
    L, M = mask.shape
    f = fused_form(L, split, form, noise_seed is not None)
    transform = mono_tile_reference if f == "mono" else fwht_tile_reference
    sq_sum = (functools.partial(_slab_sq_sum, f_b=slab_geometry(L, M)[1])
              if f == "slab" else _tile_sq_sum)
    if noise_seed is not None:
        y_n = channel_noise_reference(noise_seed, mask, noise_sigma)
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
    trace = torch.empty((T, B), dtype=y.dtype, device=y.device)
    tau2_prev = torch.full((B,), math.inf, dtype=y.dtype, device=y.device)
    active = torch.ones((B,), dtype=torch.bool, device=y.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=y.device)
    for t in range(T):
        z_new = y
        if t > 0:
            bnorm2 = sq_sum(beta)
            coef = (P - bnorm2 / (n * n)) / tau2_prev
            w = transform(beta, precision)
            z_new = y - mask_n * w + coef[:, None, None] * z
        if tau2_schedule is None:
            tau2 = sq_sum(z_new) / n
        else:
            tau2 = tau2_schedule[t].to(y.dtype).expand(B)
        s = transform(z_new, precision) + beta
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


def _counted(out: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """amp_fused's result, counted while tracing: `amp.iters_max` adds the
    call's slowest codeword's iterations (a one-element tensor on the
    device, summed when read: no sync), `amp.calls` one call."""
    if tracing():
        count("amp.iters_max", out[2].max())
        count("amp.calls", 1)
    return out


def amp_fused(y_n: Optional[torch.Tensor],  # (B, L, M) N-space embedded y
              mask: torch.Tensor,           # (L, M) 0/1 row support
              sq_npl: torch.Tensor,         # (L,) sqrt(n P_l)
              P: float, n: int, T: int,
              encode_idx: Optional[torch.Tensor] = None,   # (B, L) int32
              precision: str = "bf16",
              tol: float = 0.0,
              pin_idx: Optional[torch.Tensor] = None,      # (B, L) int32
              tau2_schedule: Optional[torch.Tensor] = None,  # (T,) f32
              noise_seed: Optional[torch.Tensor] = None,   # (B, 2) int32
              noise_sigma: Optional[float] = None,
              split: Optional[bool] = None,
              form: Optional[str] = None,  # None = auto | split|mono|slab
              support: Optional[SplitSupport] = None,  # the split kernel's
                                                       # tables of mask
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-trial AMP: returns (beta (B, L, M), tau2 trace (T, B),
    iterations used (B,) int32).

    split and form route as the reference's amp_fused does (`fused_form`):
    with neither, the mono form at L <= 1024 and the split form above;
    form="slab" runs the slab kernel.

    encode_idx (B, L) turns on the in-kernel encode: y_n then holds the
    channel noise on the row support, and the codeword
    mask o (A beta0) is synthesized from the true section indices.

    precision "bf16" is the reference kernels' arithmetic (module
    docstring); the other modes keep float32 operands, in which the split
    kernel and its plain version differ only in summation order.  The mono
    kernel computes its forward H_M on the tensor cores in bf16 (its
    adjoint's H_M from the row support's bf16 entries), the slab kernel
    H_{m_b} and H_{f_b}, so both take "bf16" only.

    tol > 0 is the reference's per-codeword early stop: once
    |tau2_t - tau2_{t-1}| < tol * tau2_t a codeword is frozen from
    iteration t + 1 on, its frozen trace entries repeat tau2_t, and its
    iteration count stops.  pin_idx (B, L), -1 = unpinned, overrides each
    pinned row with sq * one_hot(pin_idx) after every softmax (decision
    feedback).  tau2_schedule (T,) replaces |z|^2 / n with a state-
    evolution schedule; the Onsager term then divides by the schedule's
    previous entry.

    noise_seed (B, 2) int32 (the uint32 bit patterns of each codeword's
    Philox key) with noise_sigma turns on the in-kernel noise: y_n is then
    None, and the kernel draws the masked AWGN noise_sigma * N(0, 1) on the
    row support itself (module docstring).  It needs encode_idx and the
    split form, as in the reference.  Equal seeds give identical noise,
    which is how the concat chain's pinned feedback pass sees its main
    pass's channel.

    support (ops/split_support.py) is the split kernel's layout of the row
    support mask > 0, on the data's device: every form keeps y and z on it
    only.  A caller that decodes many blocks with one mask builds it once
    (the operator's `split_support`); without it a CUDA call builds it
    from mask, which waits for the device.  The CPU route does not read
    it."""
    with annotate("amp.fused"):
        if noise_seed is not None:
            if encode_idx is None or y_n is not None or noise_sigma is None:
                raise ValueError("the in-kernel noise needs encode_idx and "
                                 "noise_sigma, and no y_n")
        elif y_n is None:
            raise ValueError("y_n is needed unless noise_seed is given")
        if T < 1:
            raise ValueError(f"T must be >= 1, got {T}")
        if precision not in _PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if tol < 0:
            raise ValueError(f"tol must be >= 0, got {tol}")
        L, M = mask.shape
        f = fused_form(L, split, form, noise_seed is not None)
        dev = (y_n if y_n is not None else noise_seed).device
        if dev.type == "cpu":
            return _counted(amp_fused_reference(
                y_n, mask, sq_npl, P, n, T, encode_idx, precision, tol,
                pin_idx, tau2_schedule, noise_seed, noise_sigma, form=f))
        if dev.type != "cuda":
            raise ValueError(f"amp_fused runs on cpu or cuda, not {dev}")
        from ._build import run

        B = encode_idx.shape[0] if y_n is None else y_n.shape[0]
        _check_cuda_shape(B, L, M, max_l=1024 if f == "mono" else 4096)
        if f in ("mono", "slab") and precision != "bf16":
            raise ValueError(f"the {f} kernel computes its Hadamard factors "
                             f"on the tensor cores in bf16: precision must "
                             f"be 'bf16'")
        if y_n is None:
            _check_seed(noise_seed, B, dev)
        else:
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
        beta = torch.empty((B, L, M), dtype=torch.float32, device=dev)
        trace = torch.empty((T, B), dtype=torch.float32, device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        # active[t, b]: codeword b runs iteration t.  Row 0 is all ones; the
        # row stage of iteration t writes row t + 1, which only the launches
        # of iteration t + 1 read.
        active = torch.ones((T + 1, B), dtype=torch.int32, device=dev)
        # the |z|^2 partials, one per column-stage block (a cluster of L / 1024
        # blocks per 32-column strip above L = 1024), and the |beta'|^2
        # partials, one per row; on the slab form one per (slab, 32-column
        # strip) and one per slab
        if f == "slab":
            f_a = slab_geometry(L, M)[0]
            nz, nb = f_a * (M // 32), f_a
        else:
            nz, nb = max(1, L // 1024) * (M // 32), L
        zpart = torch.empty((B, nz), dtype=torch.float32, device=dev)
        bpart = torch.empty((B, nb), dtype=torch.float32, device=dev)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        # y and z live on the row support only, in the split kernel's order of
        # its entries (every form)
        if support is None:
            support = split_support_from_mask(mask)
        _check_support(support, L, M, dev)
        ns = support.ns
        mask_c = support.gather(mask_n)
        yc = torch.empty((B, ns), dtype=torch.float32, device=dev)
        zc = torch.empty_like(yc)
        if f == "slab":
            # the work tile holds the H_M stage's results rounded to bf16, as
            # the H_L stage reads them; u the adjoint's float32 result; zr
            # bf16(z) with its column in row-major order for the adjoint
            work = torch.empty_like(beta, dtype=torch.bfloat16)
            u = torch.empty_like(beta)
            zr = torch.empty((B, ns), dtype=torch.int32, device=dev)
            run("amp_slab", "amp_slab_run", dev,
                y_n.data_ptr(), mask_c.data_ptr(), support.offset.data_ptr(),
                support.word.data_ptr(), support.block_offset.data_ptr(),
                support.perm.data_ptr(), support.row_offset.data_ptr(), ns,
                sqi.data_ptr(), sqo.data_ptr(),
                ptr(encode_idx), ptr(pin_idx), ptr(tau2_schedule),
                beta.data_ptr(), trace.data_ptr(), iters.data_ptr(),
                active.data_ptr(), yc.data_ptr(), zc.data_ptr(), zr.data_ptr(),
                u.data_ptr(), work.data_ptr(), zpart.data_ptr(),
                bpart.data_ptr(), B, L, M, T, float(P), float(n),
                1.0 / math.sqrt(n), float(tol))
            amp_fused.slab_launches += 1
            return _counted((beta, trace, iters))
        if f == "mono":
            # the mono form's work tile holds float32 products (bf16(x) H_M
            # and its H_L), so it is float32; zr holds bf16(z) with its column
            # in row-major order for the adjoint's launch
            work = torch.empty_like(beta)
            zr = torch.empty((B, ns), dtype=torch.int32, device=dev)
            run("amp_mono", "amp_mono_run", dev,
                y_n.data_ptr(), mask_c.data_ptr(), support.offset.data_ptr(),
                support.word.data_ptr(), support.block_offset.data_ptr(),
                support.perm.data_ptr(), support.row_offset.data_ptr(), ns,
                sqi.data_ptr(), sqo.data_ptr(),
                ptr(encode_idx), ptr(pin_idx), ptr(tau2_schedule),
                beta.data_ptr(), trace.data_ptr(), iters.data_ptr(),
                active.data_ptr(), yc.data_ptr(), zc.data_ptr(), zr.data_ptr(),
                work.data_ptr(), zpart.data_ptr(), bpart.data_ptr(), B, L, M,
                T, float(P), float(n), 1.0 / math.sqrt(n), float(tol))
            amp_fused.mono_launches += 1
            return _counted((beta, trace, iters))
        # the split stages round the work tile to bf16 when they read it: in
        # bf16 mode it is stored in bf16 (same values, half the bytes)
        bf16 = precision == "bf16"
        work = torch.empty_like(beta, dtype=torch.bfloat16 if bf16 else None)
        run("amp_split", "amp_split_run", dev,
            ptr(y_n), mask_c.data_ptr(), support.offset.data_ptr(),
            support.word.data_ptr(), support.block_offset.data_ptr(), ns,
            sqi.data_ptr(), sqo.data_ptr(),
            ptr(encode_idx), ptr(noise_seed), ptr(pin_idx), ptr(tau2_schedule),
            beta.data_ptr(), trace.data_ptr(), iters.data_ptr(),
            active.data_ptr(), yc.data_ptr(), zc.data_ptr(),
            work.data_ptr(), zpart.data_ptr(), bpart.data_ptr(),
            B, L, M, T, float(P), float(n), 1.0 / math.sqrt(n), float(tol),
            float(noise_sigma or 0.0), int(bf16))
        amp_fused.launches += 1
        if noise_seed is not None:
            amp_fused.noise_launches += 1
        return _counted((beta, trace, iters))


# kernel runs, one per amp_fused call on a CUDA tensor, never counted on the
# CPU route: `launches` of the split kernel (its encode launch plus 2 T
# iteration launches), `noise_launches` those of them that drew the channel
# noise in the kernel, `mono_launches` of the mono kernel and
# `slab_launches` of the slab kernel (each its encode launch plus 3 T
# iteration launches)
amp_fused.launches = 0
amp_fused.noise_launches = 0
amp_fused.mono_launches = 0
amp_fused.slab_launches = 0
