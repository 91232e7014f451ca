"""The slab AMP kernel's stage ablation (S4): port of the TPU kernels of
scripts/slab_ablation.py (`make_kernel`, `make_compact_kernel`,
`make_pair_kernel`).

Each variant is the slab kernel's decode (K7, `_amp_kernel_slab`) at a
fixed T on an observation y given (no encode, no noise, no early stop, no
pins), with one stage removed or changed.  `amp_slab_exp(mode, ...)`
runs one variant.  The script's arithmetic (`amp_slab_exp_reference`,
order="script"):

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
                summed in slab order (row 0 of H_{f_a} is all +1),
                rounded to bf16, times H_{f_b}[0:csub, :]; adjoint: H_M of
                the csub rows, times H_{f_b}[:, 0:csub], one slab added to
                every slab (column 0 of H_{f_a} is all +1).  No real
                operator has this support (the reference's docs/PERF.md),
                so it stays a timing layout.

The CUDA kernels (csrc/amp_slab_exp.cu) are K7 as it is, its own
kernels (csrc/amp_k7.cuh) at a compile-time variant: "full" is K7's
instantiation, so its decode is `amp_fused(..., form="slab")` at fixed T
with y given, bit for bit.  They compute K7's scale-free form (beta' =
beta sqrt(n), mask / n, sq / sqrt(n), sq sqrt(n); y and z on the row
support only; the adjoint's H_M from the support entries in closed form),
so each variant is the mode's change made to K7, not to the script
(csrc/amp_slab_exp.cu's table): fold has nothing left to fold (full's
kernels), fold_hfb keeps its factor's rounding, no_consume's z is H(beta')
on the support, the compact layouts keep K7's bf16 work tile.
`amp_slab_exp_reference(order="kernel")` (`k7_form_reference`) is that
function as the kernels compute it: K7's rounding points (before H_M and
before H_L, the closed-form adjoint H_M rounded once), its float32 sums
in its order where they are not a tensor-core product's (below); its full
is `amp_fused_reference(form="slab")` to float32 summation order.  The
kernels are held to it on the card; they take the script's shape, L =
1024 and M = 512.

Either plain version, given float64 tensors, sums in float64 (each bf16
rounding through float32): a second plain version that differs from the
float32 one in summation precision only.  A run may resume from a
`SlabState` (beta, the last residual z, |beta|^2 and the last tau2, after
at least one iteration; in the kernel order beta' for beta) and return its
own (`keep_state`): an ablated variant can then start from a decoded
state.  Without it no_consume's function is NaN throughout (its first tau2
is |H(0)|^2 / n = 0, as in the script), which holds its arithmetic to
nothing.

On a CPU tensor `amp_slab_exp` runs the kernels' plain version
(order="kernel"); on a CUDA tensor it launches the mode's kernels or
raises.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Tuple

import torch

from .amp_exp import _fma, _halves, _in_turn
from .amp_kernel import _constants, _slab_sq_sum
from .fwht import hadamard_factor, round_bf16
from .split_support import SplitSupport, split_support_from_mask

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
    """The decode's state after one iteration or more: beta (B, L, M)
    (beta' = beta sqrt(n) in the kernel order), the last residual z (B,
    L, M), bnorm2 (B,) = |beta|^2 summed slab by slab in slab order, and
    the last tau2 (B,)."""
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


# ------------------------------------------ K7's form (the kernels' order)
#
# The kernels are K7's (csrc/amp_k7.cuh) at a variant, so the plain
# version they are held to repeats K7's arithmetic step for step: its
# scale-free form and rounding points (the transform's input rounded to
# bf16 before H_M, the H_M stage's result rounded before H_L), R2C2's
# closed-form H_M of each row from its support entries (a float32 sum of
# +-bf16(z) in column order, rounded), its radix butterflies stride 1
# first, the residual's contracted multiply-adds, R3's softmax sums and
# |beta'|^2 in its lanes' and warps' order, and the per-slab |z|^2 in slab
# order (amp_fused_reference's `_slab_sq_sum`).  Left: the order of the
# tensor cores' H_{m_b} and H_{f_b} sums, of a slab's |z|^2 sum, and exp
# off the card.


def _factor(x: torch.Tensor, dim: int, h: torch.Tensor) -> torch.Tensor:
    """x times h along axis dim (out[.., c] = sum_k x[.., k] h[k, c]),
    contracted as fwht_kron contracts a factor."""
    y = x.movedim(dim, -1)
    y = torch.tensordot(y, h, dims=([y.dim() - 1], [0]))
    return y.movedim(-1, dim)


def _k7_radix(x: torch.Tensor, dim: int, form: str) -> torch.Tensor:
    """The radix factor across the blocks of axis dim, stride 1 first
    (`_fwht_blocks`): float32 butterflies ("f32"), none, or on bf16 (each
    input and each result rounded; a lone block unrounded)."""
    n = x.shape[dim]
    if form == "none" or n == 1:
        return x
    vals = list(x.unbind(dim))
    if form == "bf16":
        vals = [_round(t).to(torch.bfloat16) for t in vals]
    return torch.stack([t.to(x.dtype) for t in _fwht_blocks(vals)], dim)


def _k7_stage_forms(base: str) -> Tuple[Tuple[bool, str], Tuple[bool, str]]:
    """((products, radix) of H_L in C1 and R2C2, the same of R3's H_M) of
    a variant (amp_mma.cuh HStage, amp_k7.cuh k7_col_h / k7_row_h)."""
    col = {"no_radix": (True, "none"), "no_mm": (False, "f32"),
           "bf16_radix": (True, "bf16")}.get(base, (True, "f32"))
    row = (True, "bf16") if base == "midbf16" else col
    return col, row


def _k7_hm(v: Variant, x: torch.Tensor, form) -> torch.Tensor:
    """R3's H_M of bf16(x): H_{m_b} on each column block, then H_{m_a}
    across the blocks, in the form (products, radix)."""
    B, L, M = x.shape
    blocks = _round(x).reshape(B, L, M // v.m_b, v.m_b)
    if form[0]:
        blocks = _factor(blocks, -1, _h(v.m_b, x))
    return _k7_radix(blocks, 2, form[1]).reshape(B, L, M)


def _k7_hl(v: Variant, w: torch.Tensor, form, hfb) -> torch.Tensor:
    """H_L of the bf16 work tile w: hfb (H_{f_b}, fold_hfb's scaled in C1)
    on each slab, then H_{f_a} across the slabs, in the form."""
    B, L, M = w.shape
    slabs = w.reshape(B, L // v.f_b, v.f_b, M)
    if form[0]:
        slabs = _factor(slabs, -2, hfb.T)
    return _k7_radix(slabs, 1, form[1]).reshape(B, L, M)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """popcount(x) & 1 of non-negative integers below 2^16."""
    for sh in (8, 4, 2, 1):
        x = x ^ (x >> sh)
    return x & 1


def _k7_adjoint_hm(z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """R2C2's H_M of bf16(z) on the support mask > 0: each output (l, m)
    the float32 sum, in column order of row l's entries (m', z), of
    (-1)^popc(m' & m) bf16(z) (amp_k7.cuh slab_adj_kernel); not rounded."""
    B, L, M = z.shape
    on = mask > 0
    K = max(int(on.sum(1).max()), 1)
    m = torch.arange(M, device=z.device)
    # each row's entry columns in ascending order, M past the last
    cols = torch.sort(torch.where(on, m, M), dim=1).values[:, :K]
    valid = cols < M
    cols = cols.clamp(max=M - 1)
    rz = torch.gather(_round(z), 2, cols.expand(B, L, K))
    rz = torch.where(valid, rz, torch.zeros_like(rz))
    acc = torch.zeros_like(z)
    for k in range(K):
        sign = 1 - 2 * _parity(cols[:, k, None] & m)          # (L, M)
        acc.addcmul_(rz[:, :, k, None], sign.to(z.dtype))    # one rounding
    return acc


def _k7_row_sum(e: torch.Tensor) -> torch.Tensor:
    """Each row's sum of e (B, L, M) in R3's order: lane i adds columns
    i + 32 k in turn, then warp_sum's xor tree over the lanes."""
    B, L, M = e.shape
    return _halves(_in_turn(e.reshape(B, L, M // 32, 32), 2))


def _k7_bnorm2(beta: torch.Tensor, f_b: int, m_b: int) -> torch.Tensor:
    """|beta'|^2 as K7 takes it: R3's block of a slab (NW warps, warp w
    the rows tile 16 t + w + NW r, lane i the columns i + 32 k) adds
    v v contracted, tile, row and column in turn; block_sum's warps in
    order; then C1 adds the slabs in slab order."""
    B, L, M = beta.shape
    nw = min(m_b // 8, 8)                      # amp_mma.cuh SlabRows::NW
    x = beta.reshape(B, L // f_b, f_b // 16, 16 // nw, nw, M // 32, 32)
    if x.dtype == torch.float32:               # products exact in float64
        x = x.double()
    acc = torch.zeros_like(x[:, :, 0, 0, :, 0], dtype=beta.dtype)
    for t in range(x.shape[2]):
        for r in range(x.shape[3]):
            for k in range(x.shape[5]):
                v = x[:, :, t, r, :, k]
                acc = (v * v + acc).to(beta.dtype)        # a contracted fma
    return _in_turn(_in_turn(_halves(acc), 2), 1)


def _k7_forward(v: Variant, beta: torch.Tensor, n: int) -> torch.Tensor:
    """C1's H(beta') = H_L bf16(H_M bf16(beta')) of the variant (compact:
    rows [0, csub) of the slab sum's product, 0 below)."""
    col, row = _k7_stage_forms(v.base)
    work = _round(_k7_hm(v, beta, row))
    hfb = _h(v.f_b, beta)
    if v.base == "fold_hfb":
        hfb = hfb * _round(torch.tensor(1.0 / math.sqrt(n),
                                        dtype=torch.float32)).to(hfb.dtype)
    if v.base != "compact":
        return _k7_hl(v, work, col, hfb)
    B, L, M = beta.shape
    slabs = work.reshape(B, L // v.f_b, v.f_b, M)
    acc = slabs[:, 0]
    for a in range(1, slabs.shape[1]):     # slab order
        acc = acc + slabs[:, a]
    w = torch.zeros_like(beta)
    w[:, :v.csub] = _factor(_round(acc), -2, hfb[:v.csub].T)
    return w


def _k7_adjoint(v: Variant, z: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
    """R2C2's H(z): the closed-form H_M of bf16(z) rounded to bf16, then
    the variant's H_L (compact: H_{f_b}[:, 0:csub] times its csub rows,
    that slab in every slab)."""
    B, L, M = z.shape
    col = _k7_stage_forms(v.base)[0]
    xs = _round(_k7_adjoint_hm(z, mask))
    hfb = _h(v.f_b, z)
    if v.base != "compact":
        return _k7_hl(v, xs, col, hfb)
    u0 = _factor(xs[:, :v.csub], -2, hfb[:, :v.csub].T)
    return u0.repeat(1, L // v.f_b, 1)


def k7_form_reference(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
                      sq_npl: torch.Tensor, P: float, n: int, T: int,
                      f_b: int = None, m_b: int = None,
                      state: SlabState = None, keep_state: bool = False):
    """Variant `mode` as its kernel computes it (csrc/amp_k7.cuh): K7's
    decode (`amp_fused_reference(form="slab")`'s, fixed T, y given) with
    the variant's change (csrc/amp_slab_exp.cu's table), in y_n's dtype.
    Returns (beta (B, L, M) true scale, trace (T, B), or (T, B / 2) for
    "pair"), and with keep_state the SlabState (beta') after the last
    iteration; `state` resumes a decode (not for the compact modes)."""
    B, L, M = y_n.shape
    v = parse_mode(mode, L, M, n, f_b, m_b)
    _check(v, B)
    dt, dev = y_n.dtype, y_n.device
    mask_n, sqi, sqo = _constants(mask.to(dt), sq_npl.to(dt), n)
    y = torch.where(mask_n > 0, y_n, 0.0)
    if v.base == "fold_hfb":
        # the forward product carries 1 / sqrt(n): the mask entries too
        mask_n = mask.to(dt) * (1.0 / math.sqrt(n))
    sched = v.base in ("sched", "fold_sched")
    linear = v.base in ("no_softmax", "no_consume")
    # the support entries in row-major order: y, mask/n and z there
    flat = torch.nonzero(mask.reshape(-1) > 0).reshape(-1)
    y_c, m_c = y.reshape(B, -1)[:, flat], mask_n.reshape(-1)[flat]
    if v.base == "compact" and (state is not None or keep_state):
        raise ValueError("the compact layouts neither resume nor keep a "
                         "state")
    if state is None:
        t0, beta, z = 0, torch.zeros_like(y), y
        bnorm2 = None
        tau2_prev = torch.full((B,), math.inf, dtype=dt, device=dev)
    else:
        t0, beta, z = 1, state.beta, state.z
        bnorm2, tau2_prev = state.bnorm2, state.tau2
    trace = torch.zeros((T, B), dtype=dt, device=dev)
    for t in range(t0, t0 + T):
        z_new = y
        if v.base == "no_consume":
            # z = H(beta') on the support: 0 at t = 0 (beta' = 0)
            z_new = torch.zeros_like(y)
            if t > 0:
                z_new = torch.where(mask_n > 0, _k7_forward(v, beta, n), 0.0)
        elif t > 0:
            w = _k7_forward(v, beta, n).reshape(B, -1)[:, flat]
            if bnorm2 is None:
                bnorm2 = _k7_bnorm2(beta, v.f_b, v.m_b)
            coef = ((P - bnorm2 / (n * n)) / tau2_prev)[:, None]
            z_c = z.reshape(B, -1)[:, flat]
            # the residual on the support (0 off it), contracted as K7's
            z_new = torch.zeros_like(y).reshape(B, -1)
            z_new[:, flat] = _fma(coef.expand_as(z_c), z_c,
                                  _fma(-m_c, w, y_c))
            z_new = z_new.reshape(B, L, M)
        if sched:
            tau2 = torch.full((B,), SCHED_TAU2, dtype=dt, device=dev)
        else:
            tau2 = _slab_sq_sum(z_new, v.f_b) / n
        s = _k7_adjoint(v, z_new, mask) + beta
        a = (sqi / tau2[:, None, None]) * s
        if linear:
            sc = (torch.tensor(1e-3, dtype=dt) /
                  torch.tensor(1.0 / math.sqrt(n), dtype=dt))
            beta = a * sc.to(dev)
        else:
            a = a - a.amax(-1, keepdim=True)
            e = torch.exp2(a * LOG2E) if v.base == "exp2" else torch.exp(a)
            beta = (sqo / _k7_row_sum(e)[..., None]) * e
        bnorm2 = None
        z = z_new
        tau2_prev = tau2
        if v.base != "no_trace":
            trace[t - t0] = tau2
    out = None
    if keep_state:
        out = SlabState(beta, z, _k7_bnorm2(beta, v.f_b, v.m_b), tau2_prev)
    return _result(v, beta * (1.0 / math.sqrt(n)), trace, out, keep_state)


def amp_slab_exp_reference(mode: str, y_n: torch.Tensor, mask: torch.Tensor,
                           sq_npl: torch.Tensor, P: float, n: int, T: int,
                           f_b: int = None, m_b: int = None,
                           state: SlabState = None, keep_state: bool = False,
                           order: str = "script"):
    """Plain PyTorch version of the variants: returns (beta (B, L, M),
    tau2 trace (T, B), or (T, B / 2) for "pair": the first codeword of
    each pair), and with keep_state the SlabState after the last
    iteration.  y_n (B, L, M) is the observation (the kernel masks it),
    mask (L, M) the 0/1 support (`compact_mask` for the compact modes),
    sq_npl (L,) sqrt(n P_l); f_b and m_b the factors of the modes that do
    not name their own (by default min(128, L) and min(128, M)); `state`
    a state to resume from (not for the compact modes).  order "script"
    computes the script's kernels' arithmetic (true scale, dense z),
    "kernel" the card's kernels' (`k7_form_reference`, K7's form).
    Computes in y_n's dtype (float32, or float64 sums); runs on any
    device."""
    if order == "kernel":
        return k7_form_reference(mode, y_n, mask, sq_npl, P, n, T, f_b, m_b,
                                 state, keep_state)
    if order != "script":
        raise ValueError(f"unknown order {order!r}")
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
                 state: SlabState = None, keep_state: bool = False,
                 support: SplitSupport = None):
    """Run variant `mode` on y_n (B, L, M): returns (beta (B, L, M), tau2
    trace (T, B), or (T, B / 2) for "pair"), and with keep_state the
    SlabState (beta') after the last iteration; `state` resumes a decode
    (not for the compact modes, nor on the card for the variants whose R3
    changes H_M).

    On a CPU tensor the kernels' plain version (`amp_slab_exp_reference`,
    order="kernel", f_b = min(128, L), m_b = min(128, M) but for fXmY); on
    a CUDA tensor the mode's kernels in csrc/amp_slab_exp.cu, which take
    L = 1024, M = 512 (the script's shape), the variants of MODES, float32
    contiguous y_n, mask, sq_npl and state, and raise on anything else.
    support: K1's tables of mask (the operator's `split_support`; the
    compact layouts' own), which the kernels read y and z by; without it a
    CUDA call builds them from mask, which waits for the device."""
    B, L, M = y_n.shape
    v = parse_mode(mode, L, M, n)
    _check(v, B)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if y_n.device.type == "cpu":
        return amp_slab_exp_reference(mode, y_n, mask, sq_npl, P, n, T,
                                      state=state, keep_state=keep_state,
                                      order="kernel")
    if y_n.device.type != "cuda":
        raise ValueError(f"amp_slab_exp runs on cpu or cuda, not "
                         f"{y_n.device}")
    return _launch(v, y_n, mask, sq_npl, P, n, T, state, keep_state,
                   support)


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


# the variants whose R3 changes H_M: a resumed run on the card cannot
# rebuild their work tile (amp_slab_exp.cu `resumes`)
NO_RESUME = ("no_radix", "no_mm", "bf16_radix", "midbf16", "f128m256",
             "f128m512", "compact", "compact32")


def _launch(v: Variant, y_n: torch.Tensor, mask: torch.Tensor,
            sq_npl: torch.Tensor, P: float, n: int, T: int,
            state: SlabState, keep_state: bool,
            support: SplitSupport):
    from ._build import run
    from .amp_kernel import _check_cuda_tensor, _check_support

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
    if state is not None and name in NO_RESUME:
        raise ValueError(f"{name} changes R3's H_M: its kernels cannot "
                         f"resume")
    if support is None:
        support = split_support_from_mask(mask)
    _check_support(support, L, M, dev)
    mask_n, sqi, sqo = _constants(mask, sq_npl, n)
    if v.base == "fold_hfb":
        mask_n = mask * (1.0 / math.sqrt(n))
    mask_c = support.gather(mask_n)
    ns, f_a = support.ns, L // v.f_b
    t0 = 0 if state is None else 1
    # the trace carries tau2 to the next iteration: no_trace's two rows
    trace = torch.empty((2 if v.base == "no_trace" else t0 + T, B),
                        dtype=torch.float32, device=dev)
    bpart = torch.empty((B, f_a), dtype=torch.float32, device=dev)
    zc = torch.empty((B, ns), dtype=torch.float32, device=dev)
    if state is None:
        beta = torch.empty((B, L, M), dtype=torch.float32, device=dev)
    else:
        for nm, x, shape in (("beta", state.beta, (B, L, M)),
                             ("z", state.z, (B, L, M)),
                             ("bnorm2", state.bnorm2, (B,)),
                             ("tau2", state.tau2, (B,))):
            _check_cuda_tensor(f"state.{nm}", x, torch.float32, shape, dev)
        beta = state.beta.clone()
        zc.copy_(support.gather(state.z))
        bpart.zero_()
        bpart[:, 0] = state.bnorm2
        trace[0] = state.tau2
    sched = None
    if v.base in ("sched", "fold_sched"):
        sched = torch.full((t0 + T,), SCHED_TAU2, dtype=torch.float32,
                           device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    active = torch.ones((t0 + T + 1, B), dtype=torch.int32, device=dev)
    yc = torch.empty_like(zc)
    zr = torch.empty((B, ns), dtype=torch.int32, device=dev)
    # u: H(z) from R2C2, one slab a codeword for the compact layouts; the
    # work tile: bf16(H_M bf16(beta')) from R3
    u = torch.empty((B, v.f_b if compact else L, M), dtype=torch.float32,
                    device=dev)
    work = torch.empty((B, L, M), dtype=torch.bfloat16, device=dev)
    zpart = torch.empty((B, f_a, M // 32), dtype=torch.float32, device=dev)
    hscale = 1.0 / math.sqrt(n) if v.base == "fold_hfb" else 1.0

    def ptr(x):
        return x.data_ptr() if x is not None else None

    run("amp_slab_exp", "amp_slab_exp_run", dev, MODES.index(name),
        y_n.data_ptr(), mask_c.data_ptr(), support.offset.data_ptr(),
        support.word.data_ptr(), support.block_offset.data_ptr(),
        support.perm.data_ptr(), support.row_offset.data_ptr(), ns,
        sqi.data_ptr(), sqo.data_ptr(), ptr(sched), beta.data_ptr(),
        trace.data_ptr(), iters.data_ptr(), active.data_ptr(),
        yc.data_ptr(), zc.data_ptr(), zr.data_ptr(), u.data_ptr(),
        work.data_ptr(), zpart.data_ptr(), bpart.data_ptr(), B, L, M, t0, T,
        int(keep_state), float(P), float(n), 1.0 / math.sqrt(n), hscale)
    amp_slab_exp.launches[name] += 1
    out = None
    if keep_state:
        bnorm2 = bpart[:, 0]
        for a in range(1, f_a):      # in slab order, as the next C1 sums
            bnorm2 = bnorm2 + bpart[:, a]
        z = torch.zeros((B, L * M), dtype=torch.float32, device=dev)
        z[:, support.flat] = zc
        last = t0 + T - 1
        tau2 = trace[last % 2 if v.base == "no_trace" else last].clone()
        out = SlabState(beta, z.reshape(B, L, M), bnorm2, tau2)
        beta = beta * (1.0 / math.sqrt(n))
    if v.base == "no_trace":
        trace = torch.zeros((T, B), dtype=torch.float32, device=dev)
    else:
        trace = trace[t0:]
    return _result(v, beta, trace, out, keep_state)


# kernel runs by variant, one per amp_slab_exp call on a CUDA tensor (each
# call is an encode launch and 3 T iteration launches, a resumed one a
# work-tile launch more), never counted on the CPU route
amp_slab_exp.launches = dict.fromkeys(MODES, 0)


def reset_launches() -> None:
    """Set every variant's count of kernel runs to 0."""
    amp_slab_exp.launches = dict.fromkeys(MODES, 0)
