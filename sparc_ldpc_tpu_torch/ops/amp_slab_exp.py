"""The slab AMP kernel's stage ablation (S4): port of the TPU kernels of
scripts/slab_ablation.py (`make_kernel`, `make_compact_kernel`,
`make_pair_kernel`).

Each variant is the slab kernel's decode (K7, `_amp_kernel_slab`, as it
stood before its scale-free scheme) at a fixed T on an observation y
given (no encode, no noise, no early stop, no pins, no schedule), with one
stage removed or changed.  `amp_slab_exp(mode, ...)` runs one variant.
The arithmetic is the script's:

    coef = (P - |beta|^2 / n) / tau2_prev                  (0 at t = 0)
    z    = mask y - mask (H(beta) / sqrt(n)) + coef z      (mask 0/1)
    tau2 = |z|^2 / n
    beta = sq softmax_row((sq / tau2) (H(z) / sqrt(n) + beta))

with H(x) = H_{f_a} (x) H_{f_b} applied after H_{m_a} (x) H_{m_b}: along
each section row, x times H_{m_b} in column blocks of m_b (a product,
its data operand rounded to bf16, float32 sums) and H_{m_a} across the
blocks as float32 butterflies (stride 1 first); then down each slab of
f_b rows, H_{f_b} times the slab (a product, the H_M stage's result
rounded to bf16) and H_{f_a} across the slabs as butterflies.  f_b =
m_b = 128 unless the mode says otherwise.  The modes:

  decoding (they compute full's function):
    full        the decode
    fold        the mask arrives as float32 mask / sqrt(n) and y is
                masked by its sign: no forward scale multiply
    fold_hfb    H_{f_b}'s entries are +-bf16(1 / sqrt(n)): neither
                transform multiplies by the scale
    no_trace    no tau2 trace is stored (the trace comes back zero)
    exp2        the softmax's exp as exp2(x * log2(e))
    bf16_radix  every butterfly of H_{m_a} and H_{f_a} adds bf16 values
                and rounds its result to bf16
    midbf16     the H_{m_b} products rounded to bf16 and H_{m_a} in bf16
                arithmetic; H_{f_b} takes those values, H_{f_a} float32
    fXmY        f_b = X, m_b = Y (e.g. f128m256); the kernels have
                FACTORINGS, the plain version takes any power-of-two
                X | L and Y | M, both >= 16
    pair        full, two codewords a program; its trace holds the first
                codeword of each pair
  ablated (timing only: other functions, garbage decodes):
    no_radix    H_{m_a} and H_{f_a} are the identity
    no_mm       the H_{m_b} and H_{f_b} products are bf16 round-trip
                copies; the butterflies stay
    no_softmax  beta = (sq / tau2) s 1e-3
    no_consume  z = H(beta) (no y, mask, scale or Onsager term), and the
                softmax replaced as in no_softmax
    sched       tau2 = 0.36: no |z|^2 is taken
    fold_sched  fold and sched together
    compact, compactNN
                the script's support layout: the mask must be
                `compact_mask(L, M, n)` (the first n entries of N-space,
                rows [0, ceil(n / M))), so z lives on the first csub rows
                (csub = f_b for compact, NN for compactNN, ceil(n / M) <=
                csub <= f_b).  Forward: H_M of every row, the f_a slabs
                summed in float32 in slab order (row 0 of H_{f_a} is all
                +1), rounded to bf16, times H_{f_b}[0:csub, :]; adjoint:
                H_M of the csub rows, times H_{f_b}[:, 0:csub], one slab
                added to every slab (column 0 of H_{f_a} is all +1).  No
                real operator has this support (the reference's
                docs/PERF.md), so it stays a timing layout.

`amp_slab_exp_reference` is the script's Python line for line on
tensors, rounding where the script rounds; TF32 is never used (callers on
the GPU turn matmul TF32 off).  Given float64 tensors it sums in float64
(each bf16 rounding through float32): a second plain version that differs
from the float32 one in summation precision only.

A run may resume from a `SlabState` (beta, the last residual z, |beta|^2
and the last tau2, after at least one iteration) and return its own
(`keep_state`): an ablated variant can then start from a decoded state.
Without it no_consume's function is NaN throughout (its first tau2 is
|H(0)|^2 / n = 0, as in the script), which holds its arithmetic to
nothing.  The CUDA kernels (csrc/amp_slab_exp.cu)
are K7's four launches an iteration with one thing changed; they round at
the same places, so kernel and plain version differ in summation order
only.  They take the script's shape, L = 1024 and M = 512.

On a CPU tensor `amp_slab_exp` runs the plain version; on a CUDA tensor
it launches the mode's kernel or raises.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Tuple

import torch

from .fwht import hadamard_factor, round_bf16

# the modes of make_kernel, make_compact_kernel and make_pair_kernel, in
# the order of csrc/amp_slab_exp.cu's Mode enum (compact with csub = f_b)
BASE_MODES = ("full", "no_radix", "no_mm", "no_softmax", "no_consume",
              "bf16_radix", "midbf16", "fold", "fold_sched", "fold_hfb",
              "no_trace", "exp2", "sched", "compact", "pair")
# the other factorings with a kernel: the two the reference measured and
# one step each way in f_b
FACTORINGS = ("f128m256", "f128m512", "f256m128", "f64m128")
# the narrowed compact layouts with a kernel (the reference measured 32)
COMPACT_SUBS = ("compact32",)
# every variant with a kernel
MODES = BASE_MODES + FACTORINGS + COMPACT_SUBS
DECODING = ("full", "fold", "fold_hfb", "no_trace", "exp2", "bf16_radix",
            "midbf16", "pair") + FACTORINGS
ABLATED = ("no_radix", "no_mm", "no_softmax", "no_consume", "sched",
           "fold_sched", "compact") + COMPACT_SUBS
# the script's default list (scripts/slab_ablation.py main)
DEFAULT_VARIANTS = ("full", "no_radix", "no_mm", "no_softmax", "no_consume",
                    "bf16_radix")
# the shape the kernels take (the script's)
KERNEL_L, KERNEL_M = 1024, 512
SCHED_TAU2 = 0.36       # the sched modes' fixed tau2
LOG2E = 1.4426950408889634

_FXMY = re.compile(r"f(\d+)m(\d+)")
_COMPACT = re.compile(r"compact(\d+)")


class SlabState(NamedTuple):
    """The decode's state after one iteration or more: beta (B, L, M),
    the last residual z (B, L, M), bnorm2 (B,) = |beta|^2 summed slab by
    slab in slab order, and the last tau2 (B,)."""
    beta: torch.Tensor
    z: torch.Tensor
    bnorm2: torch.Tensor
    tau2: torch.Tensor


class Variant(NamedTuple):
    """A mode parsed: its base mode (of BASE_MODES), f_b, m_b and, for
    the compact modes, csub (else 0)."""
    base: str
    f_b: int
    m_b: int
    csub: int


def _pow2(x: int) -> bool:
    return x >= 1 and x & (x - 1) == 0


def parse_mode(mode: str, L: int, M: int, n: int, f_b: int = None,
               m_b: int = None) -> Variant:
    """`mode` at (L, M) with n rows: fXmY sets f_b and m_b (else f_b and
    m_b as given, by default min(128, L) and min(128, M), the script's 128
    at its shape), compactNN csub = NN (compact: csub = f_b); raises on
    what the script's kernels cannot run (factors not powers of two
    dividing L and M or under 16, a compact csub outside [ceil(n / M),
    f_b] or not a multiple of 16)."""
    base, csub = mode, 0
    f_b = min(128, L) if f_b is None else f_b
    m_b = min(128, M) if m_b is None else m_b
    m = _FXMY.fullmatch(mode)
    if m:
        base, f_b, m_b = "full", int(m.group(1)), int(m.group(2))
    elif _COMPACT.fullmatch(mode):
        base, csub = "compact", int(mode[len("compact"):])
    elif mode not in BASE_MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {BASE_MODES}, "
                         f"fXmY or compactNN")
    for name, f, d in (("f_b", f_b, L), ("m_b", m_b, M)):
        if not _pow2(f) or d % f or f < 16:
            raise ValueError(f"{mode}: {name} = {f} must be a power of two "
                             f">= 16 dividing {d}")
    if base == "compact":
        csub = csub or f_b
        lo = -(-n // M)
        if not lo <= csub <= f_b or csub % 16:
            raise ValueError(f"{mode}: csub = {csub} must be a multiple of "
                             f"16 in [ceil(n / M), f_b] = [{lo}, {f_b}]")
    return Variant(base, f_b, m_b, csub)


def compact_mask(L: int, M: int, n: int, device="cpu") -> torch.Tensor:
    """The compact modes' fabricated support (scripts/slab_ablation.py
    run_variant): the first n entries of N-space, float32 (L, M)."""
    if n > L * M:
        raise ValueError(f"n = {n} exceeds L M = {L * M}")
    mask = torch.zeros(L * M, dtype=torch.float32, device=device)
    mask[:n] = 1.0
    return mask.reshape(L, M)


def _check(v: Variant, B: int):
    if v.base == "pair" and B % 2:
        raise ValueError(f"pair decodes two codewords a program: B must be "
                         f"even, got {B}")


# ------------------------------------------------------------ plain version

def _round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16 in x's dtype (float64 through
    float32); round_bf16 for float32."""
    if x.dtype == torch.float32:
        return round_bf16(x)
    return x.to(torch.float32).to(torch.bfloat16).to(x.dtype)


def _fwht_blocks(bs):
    """The script's `_fwht_blocks`: H across a list of equal tiles,
    H_{2k} [top; bot] = [H_k top + H_k bot; H_k top - H_k bot] (stride 1
    first), in the tiles' own dtype (bf16 tensors round every result)."""
    if len(bs) == 1:
        return bs
    half = len(bs) // 2
    t = _fwht_blocks(bs[:half])
    u = _fwht_blocks(bs[half:])
    return ([ti + ui for ti, ui in zip(t, u)]
            + [ti - ui for ti, ui in zip(t, u)])


def _mm(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The script's `_mm`: bf16(a) @ h, float32 sums."""
    return torch.matmul(_round(a), h)


def _mml(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The script's `_mml`: h @ bf16(x), float32 sums."""
    return torch.matmul(h, _round(x))


def _h(f: int, like: torch.Tensor) -> torch.Tensor:
    """H_f in like's dtype and on its device."""
    return hadamard_factor(f, device=like.device).to(like.dtype)


def _hfb(v: Variant, n: int, like: torch.Tensor) -> torch.Tensor:
    """H_{f_b} as the script passes it: +-1, or for fold_hfb
    +-bf16(1 / sqrt(n))."""
    h = _h(v.f_b, like)
    if v.base == "fold_hfb":
        h = _round(h * (1.0 / math.sqrt(n)))
    return h


def _wide(tall, a: int, f_b: int) -> torch.Tensor:
    """Slab a of the column blocks `tall` (each (B, L, m_b)) as one
    (B, f_b, M) tile."""
    lo = a * f_b
    if len(tall) == 1:
        return tall[0][:, lo:lo + f_b, :]
    return torch.cat([t[:, lo:lo + f_b, :] for t in tall], dim=2)


def _transform(v: Variant, x: torch.Tensor, hfb: torch.Tensor,
               hmb: torch.Tensor):
    """The script's `fwht_slabs` of x (B, L, M): the f_a slabs of H(x),
    each (B, f_b, M)."""
    B, L, M = x.shape
    f_a, m_a = L // v.f_b, M // v.m_b
    cols = [x[:, :, j * v.m_b:(j + 1) * v.m_b] for j in range(m_a)]

    def radix(vals):
        if v.base == "no_radix" or len(vals) == 1:
            return vals
        if v.base == "bf16_radix":
            vals = [_round(t).to(torch.bfloat16) for t in vals]
            return [t.to(x.dtype) for t in _fwht_blocks(vals)]
        return _fwht_blocks(vals)

    if v.base == "midbf16":
        tall = [_round(_mm(c, hmb)).to(torch.bfloat16) for c in cols]
        tall = _fwht_blocks(tall) if m_a > 1 else tall
        rows = [torch.matmul(hfb, _wide(tall, a, v.f_b).to(x.dtype))
                for a in range(f_a)]
        return _fwht_blocks(rows) if f_a > 1 else rows
    if v.base == "no_mm":
        tall = [_round(c) for c in cols]
    else:
        tall = [_mm(c, hmb) for c in cols]
    tall = radix(tall)
    rows = []
    for a in range(f_a):
        wide = _wide(tall, a, v.f_b)
        rows.append(_round(wide) if v.base == "no_mm"
                    else _mml(hfb, wide))
    return radix(rows)


def _softmax(v: Variant, sqa: torch.Tensor, tau2: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """The script's update of one slab's beta from s (B, f_b, M)."""
    ai = sqa / tau2[:, None, None]
    if v.base in ("no_softmax", "no_consume"):
        return ai * s * 1e-3
    x = ai * s
    x = x - x.amax(-1, keepdim=True)
    e = torch.exp2(x * LOG2E) if v.base == "exp2" else torch.exp(x)
    return (sqa / e.sum(-1, keepdim=True)) * e


def _coef(t: int, P: float, n: int, bnorm2, tau2_prev):
    if t == 0:
        return torch.zeros_like(bnorm2)
    return (P - bnorm2 / n) / tau2_prev


def _decode_reference(v: Variant, y_n, mask, sq, P, n, T, state):
    """make_kernel's decode (and make_pair_kernel's, codeword by
    codeword), from beta = 0 or from `state`: (beta, trace (T, B),
    SlabState)."""
    B, L, M = y_n.shape
    dev, dt = y_n.device, y_n.dtype
    f_b, f_a = v.f_b, L // v.f_b
    inv_sqrt_n = 1.0 / math.sqrt(n)
    hfb, hmb = _hfb(v, n, y_n), _h(v.m_b, y_n)
    fold = v.base in ("fold", "fold_sched")
    sched = v.base in ("sched", "fold_sched")
    if fold:
        # the script premultiplies the mask on the host; y by its sign
        mask = mask / math.sqrt(n)
        y = torch.where(mask > 0.0, y_n, 0.0)
    else:
        y = mask * y_n
    trace = torch.zeros((T, B), dtype=dt, device=dev)
    if state is None:
        t0 = 0
        b, z = torch.zeros_like(y_n), torch.zeros_like(y_n)
        tau2_prev = torch.full((B,), math.inf, dtype=dt, device=dev)
        bnorm2 = torch.zeros((B,), dtype=dt, device=dev)
    else:
        t0 = 1
        b, z = state.beta.clone(), state.z.clone()
        bnorm2, tau2_prev = state.bnorm2, state.tau2
    for t in range(t0, t0 + T):
        coef = _coef(t, P, n, bnorm2, tau2_prev)[:, None, None]
        w = _transform(v, b, hfb, hmb)
        tau2_acc = torch.zeros((B,), dtype=dt, device=dev)
        for a in range(f_a):
            rs = slice(a * f_b, (a + 1) * f_b)
            if v.base == "no_consume":
                zt = w[a]
            elif fold:
                zt = y[:, rs] - mask[rs] * w[a] + coef * z[:, rs]
            elif v.base == "fold_hfb":
                zt = y[:, rs] - mask[rs] * w[a] + coef * z[:, rs]
            else:
                zt = (y[:, rs] - mask[rs] * (w[a] * inv_sqrt_n)
                      + coef * z[:, rs])
            z[:, rs] = zt
            if not sched:
                tau2_acc = tau2_acc + (zt * zt).sum((1, 2))
        tau2 = (torch.full((B,), SCHED_TAU2, dtype=dt, device=dev) if sched
                else tau2_acc / n)
        sw = _transform(v, z, hfb, hmb)
        bnorm2 = torch.zeros((B,), dtype=dt, device=dev)
        for a in range(f_a):
            rs = slice(a * f_b, (a + 1) * f_b)
            s = (sw[a] if v.base == "fold_hfb" else sw[a] * inv_sqrt_n)
            s = s + b[:, rs]
            bnew = _softmax(v, sq[rs], tau2, s)
            b[:, rs] = bnew
            bnorm2 = bnorm2 + (bnew * bnew).sum((1, 2))
        if v.base != "no_trace":
            trace[t - t0] = tau2
        tau2_prev = tau2
    return b, trace, SlabState(b, z, bnorm2, tau2_prev)


def _compact_reference(v: Variant, y_n, mask, sq, P, n, T):
    """make_compact_kernel's decode: (beta, trace (T, B), None)."""
    B, L, M = y_n.shape
    dev, dt = y_n.device, y_n.dtype
    f_b, f_a, m_b, m_a, csub = v.f_b, L // v.f_b, v.m_b, M // v.m_b, v.csub
    inv_sqrt_n = 1.0 / math.sqrt(n)
    hfb, hmb = _hfb(v, n, y_n), _h(m_b, y_n)

    def col_stage(x):
        tall = [_mm(x[:, :, j * m_b:(j + 1) * m_b], hmb) for j in range(m_a)]
        return _fwht_blocks(tall) if m_a > 1 else tall

    y = mask * y_n
    b = torch.zeros_like(y_n)
    z = torch.zeros((B, csub, M), dtype=dt, device=dev)
    trace = torch.zeros((T, B), dtype=dt, device=dev)
    tau2_prev = torch.full((B,), math.inf, dtype=dt, device=dev)
    bnorm2 = torch.zeros((B,), dtype=dt, device=dev)
    for t in range(T):
        coef = _coef(t, P, n, bnorm2, tau2_prev)[:, None, None]
        tall = col_stage(b)
        acc = None
        for a in range(f_a):
            wide = _wide(tall, a, f_b)
            acc = wide if acc is None else acc + wide
        w0 = _mml(hfb[0:csub, :], acc)
        z = y[:, 0:csub] - mask[0:csub] * (w0 * inv_sqrt_n) + coef * z
        tau2 = (z * z).sum((1, 2)) / n
        tallz = col_stage(z)
        widez = tallz[0] if m_a == 1 else torch.cat(tallz, dim=2)
        sw0 = _mml(hfb[:, 0:csub], widez)
        bnorm2 = torch.zeros((B,), dtype=dt, device=dev)
        for a in range(f_a):
            rs = slice(a * f_b, (a + 1) * f_b)
            bnew = _softmax(v, sq[rs], tau2, sw0 * inv_sqrt_n + b[:, rs])
            b[:, rs] = bnew
            bnorm2 = bnorm2 + (bnew * bnew).sum((1, 2))
        trace[t] = tau2
        tau2_prev = tau2
    return b, trace, None


def _result(v: Variant, beta, trace, state, keep_state: bool):
    trace = trace[:, 0::2] if v.base == "pair" else trace
    return (beta, trace, state) if keep_state else (beta, trace)


def amp_slab_exp_reference(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
                           sq_npl: torch.Tensor, P: float, n: int, T: int,
                           f_b: int = None, m_b: int = None,
                           state: SlabState = None, keep_state: bool = False):
    """Plain PyTorch version of the script's kernels: returns (beta (B, L,
    M), tau2 trace (T, B), or (T, B / 2) for "pair": the first codeword of
    each pair), and with keep_state the SlabState after the last
    iteration.  y_n (B, L, M) is the observation (the kernel masks it),
    mask (L, M) the 0/1 support (`compact_mask` for the compact modes),
    sq_npl (L,) sqrt(n P_l); f_b and m_b the factors of the modes that do
    not name their own (by default min(128, L) and min(128, M)); `state`
    a state to resume from (not for the compact modes).  Computes in y_n's
    dtype (float32, or float64 sums); runs on any device."""
    B, L, M = y_n.shape
    v = parse_mode(mode, L, M, n, f_b, m_b)
    _check(v, B)
    dt = y_n.dtype
    mask = mask.to(dt)
    sq = sq_npl.to(dt).reshape(L, 1)
    if v.base != "compact":
        beta, trace, out = _decode_reference(v, y_n, mask, sq, float(P), n,
                                             T, state)
    elif state is None and not keep_state:
        beta, trace, out = _compact_reference(v, y_n, mask, sq, float(P), n,
                                              T)
    else:
        raise ValueError("the compact layouts neither resume nor keep a "
                         "state")
    return _result(v, beta, trace, out, keep_state)


# ------------------------------------------------------------ the kernels

def amp_slab_exp(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
                 sq_npl: torch.Tensor, P: float, n: int, T: int,
                 state: SlabState = None, keep_state: bool = False):
    """Run variant `mode` on y_n (B, L, M): returns (beta (B, L, M), tau2
    trace (T, B), or (T, B / 2) for "pair"), and with keep_state the
    SlabState after the last iteration; `state` resumes a decode (not for
    the compact modes).

    On a CPU tensor `amp_slab_exp_reference` (f_b = min(128, L), m_b =
    min(128, M) but for fXmY); on a CUDA tensor the mode's kernel in
    csrc/amp_slab_exp.cu, which takes L = 1024, M = 512 (the script's
    shape), the variants of MODES, float32 contiguous y_n, mask, sq_npl
    and state, and raises on anything else."""
    B, L, M = y_n.shape
    v = parse_mode(mode, L, M, n)
    _check(v, B)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if y_n.device.type == "cpu":
        return amp_slab_exp_reference(mode, y_n, mask, sq_npl, P, n, T,
                                      state=state, keep_state=keep_state)
    if y_n.device.type != "cuda":
        raise ValueError(f"amp_slab_exp runs on cpu or cuda, not "
                         f"{y_n.device}")
    return _launch(v, y_n, mask, sq_npl, P, n, T, state, keep_state)


def _kernel_name(v: Variant) -> str:
    """The variant name of MODES that `v` runs, or raises."""
    if v.base == "compact":
        name = "compact" if v.csub == v.f_b else f"compact{v.csub}"
    elif v.base == "full" and (v.f_b, v.m_b) != (128, 128):
        name = f"f{v.f_b}m{v.m_b}"
    else:
        name = v.base
    if name not in MODES:
        raise ValueError(f"no kernel for {name}: the kernels are {MODES}")
    return name


def _launch(v: Variant, y_n: torch.Tensor, mask: torch.Tensor,
            sq_npl: torch.Tensor, P: float, n: int, T: int,
            state: SlabState, keep_state: bool):
    from ._build import run
    from .amp_kernel import _check_cuda_tensor

    B, L, M = y_n.shape
    name = _kernel_name(v)
    if (L, M) != (KERNEL_L, KERNEL_M) or not 1 <= B <= 65535:
        raise ValueError(f"the S4 kernels take L = {KERNEL_L}, M = "
                         f"{KERNEL_M} and B <= 65535; got B={B}, L={L}, "
                         f"M={M}")
    dev = y_n.device
    _check_cuda_tensor("y_n", y_n, torch.float32, (B, L, M), dev)
    _check_cuda_tensor("mask", mask, torch.float32, (L, M), dev)
    _check_cuda_tensor("sq_npl", sq_npl, torch.float32, (L,), dev)
    compact = v.base == "compact"
    if compact and (state is not None or keep_state):
        raise ValueError("the compact layouts neither resume nor keep a "
                         "state")
    f_a, rows = L // v.f_b, v.csub if compact else L
    if v.base in ("fold", "fold_sched"):
        mask_k = mask / math.sqrt(n)                 # float32, the script's
    else:
        mask_k = mask.to(torch.bfloat16)             # 0/1, exact
    new = torch.zeros if v.base == "no_trace" else torch.empty
    trace = new((T, B), dtype=torch.float32, device=dev)
    bpart = torch.empty((B, f_a), dtype=torch.float32, device=dev)
    if state is None:
        beta = torch.empty((B, L, M), dtype=torch.float32, device=dev)
        z = torch.empty((B, rows, M), dtype=torch.float32, device=dev)
        tau2c = torch.empty((B,), dtype=torch.float32, device=dev)
    else:
        for nm, x, shape in (("beta", state.beta, (B, L, M)),
                             ("z", state.z, (B, L, M)),
                             ("bnorm2", state.bnorm2, (B,)),
                             ("tau2", state.tau2, (B,))):
            _check_cuda_tensor(f"state.{nm}", x, torch.float32, shape, dev)
        beta, z, tau2c = (state.beta.clone(), state.z.clone(),
                          state.tau2.clone())
        bpart.zero_()
        bpart[:, 0] = state.bnorm2
    # H(z) from the adjoint's column stage: one slab a codeword (compact)
    u = torch.empty((B, v.f_b if compact else L, M), dtype=torch.float32,
                    device=dev)
    # the work tile: H_M of beta (forward) and of z (adjoint), bf16 as the
    # script rounds it before H_{f_b}; the compact forward keeps H_M of
    # beta in float32, since the script sums the slabs before rounding
    work = torch.empty((B, L, M), device=dev,
                       dtype=torch.float32 if compact else torch.bfloat16)
    workz = (torch.empty((B, rows, M), dtype=torch.bfloat16, device=dev)
             if compact else work)
    zpart = torch.empty((B, 1 if compact else f_a, M // 32),
                        dtype=torch.float32, device=dev)
    hscale = 1.0 / math.sqrt(n) if v.base == "fold_hfb" else 1.0
    run("amp_slab_exp", "amp_slab_exp_run", dev, BASE_MODES.index(v.base),
        v.f_b, v.m_b, v.csub, y_n.data_ptr(), mask_k.data_ptr(),
        sq_npl.data_ptr(), beta.data_ptr(), trace.data_ptr(), z.data_ptr(),
        u.data_ptr(), work.data_ptr(), workz.data_ptr(), zpart.data_ptr(),
        bpart.data_ptr(), tau2c.data_ptr(), B, 0 if state is None else 1, T,
        int(keep_state), float(P), float(n), 1.0 / math.sqrt(n), hscale)
    amp_slab_exp.launches[name] += 1
    out = None
    if keep_state:
        bnorm2 = bpart[:, 0]
        for a in range(1, f_a):      # in slab order, as the next C1 sums
            bnorm2 = bnorm2 + bpart[:, a]
        out = SlabState(beta, z, bnorm2, tau2c)
    return _result(v, beta, trace, out, keep_state)


# kernel runs by variant, one per amp_slab_exp call on a CUDA tensor (each
# call is 4 T launches, a resumed one 4 T + 1), never counted on the CPU
# route
amp_slab_exp.launches = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    """Set every variant's count of kernel runs to 0."""
    amp_slab_exp.launches = dict.fromkeys(MODES, 0)
