"""Plain AMP decode of SPARC codewords on the (L, M) section tile.

The configuration's arithmetic, written from the algorithm (Barbier &
Krzakala; Rush, Greig & Venkataramanan) in the scale-free form the
configuration's transform rounds in: beta' = sqrt(n) beta, the operator
A = H_N[rows] / sqrt(n) with H_N = H_L (x) H_M, y' the received word on the
row support.  Per iteration t:

    z_t    = y' - (mask / n) H(beta'_t) + coef_t z_{t-1},
             coef_t = (P - |beta'_t|^2 / n^2) / tau2_{t-1}  (z_0 = y')
    tau2_t = |z_t|^2 / n
    beta'_{t+1} = sqrt(n P_l) sqrt(n) softmax_row(sqrt(P_l) / tau2_t *
                  (H(z_t) + beta'_t))

with pinned rows set to sqrt(n P_l) sqrt(n) one_hot after the softmax, and
a codeword frozen from the iteration after |tau2_t - tau2_{t-1}| <
tol tau2_t (tol 0: never).  H applies H_M along each row, then H_L down
each column, each stage on operands rounded by `rounding` ("bf16": to
bfloat16, the configuration's transform precision; "fp8": to float8 e4m3
with a scale per row, the control; "float32": none), with float32 sums.
The matrix products need TF32 off (`plain_float32`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from . import noise

ROUNDINGS = ("float32", "bf16", "fp8")


def plain_float32() -> None:
    """Full float32 matrix products (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def hadamard(n: int, device) -> torch.Tensor:
    """(n, n) float32 Sylvester Hadamard matrix, (-1)^popcount(i & j)."""
    i = torch.arange(n, device=device)
    x = i[:, None] & i[None, :]
    par = torch.zeros_like(x)
    while bool(x.any()):
        par ^= x & 1
        x = x >> 1
    return (1 - 2 * par).to(torch.float32)


def rounder(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if kind == "float32":
        return lambda x: x
    if kind == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        fmax = torch.finfo(torch.float8_e4m3fn).max

        def fp8(x):
            s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / fmax
            return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return fp8
    raise ValueError(f"unknown rounding {kind!r}")


class Transform:
    """H_L (x) H_M of each (L, M) tile, with the operands rounded."""

    def __init__(self, L: int, M: int, device, rounding: str = "bf16"):
        self.HL = hadamard(L, device)
        self.HM = hadamard(M, device)
        self.rnd = rounder(rounding)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        u = torch.matmul(self.rnd(x), self.HM)
        return torch.matmul(self.HL, self.rnd(u))

    def exact(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.HL, torch.matmul(x, self.HM))


def decode(idx: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
           sq: torch.Tensor, P: float, n: int, sigma: float, T: int,
           tol: float, tf: Transform, pin: Optional[torch.Tensor] = None
           ) -> Dict[str, torch.Tensor]:
    """Decode codewords whose true section indices are idx (B, L) and whose
    channel noise the keys (B, 2) draw; sq (L,) = sqrt(n P_l) float32;
    pin (B, L) int32, -1 = free.  Returns beta' (B, L, M), iters (B,)
    int32 and tau2 (B,), the last active iteration's."""
    B, L = idx.shape
    M = mask.shape[1]
    dev = mask.device
    mask_n = mask / n
    sqi = (sq / math.sqrt(n)).reshape(L, 1)
    sqo = (sq * math.sqrt(n)).reshape(L, 1)
    b0 = torch.zeros((B, L, M), dtype=torch.float32, device=dev)
    b0.scatter_(2, idx.long()[..., None], sqo.expand(B, L, 1).contiguous())
    y = noise.channel_noise(keys, mask, sigma) + mask_n * tf.exact(b0)
    del b0
    cols = torch.arange(M, device=dev)
    pinned = None
    if pin is not None:
        pinned = torch.where(cols == pin.long()[..., None], sqo,
                             torch.zeros((), device=dev))
    beta = torch.zeros_like(y)
    z = y
    tau2_prev = torch.full((B,), math.inf, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    for t in range(T):
        if t == 0:
            z_new = y
        else:
            coef = (P - (beta * beta).sum((1, 2)) / (n * n)) / tau2_prev
            z_new = y - mask_n * tf(beta) + coef[:, None, None] * z
        tau2 = (z_new * z_new).sum((1, 2)) / n
        a = (sqi / tau2[:, None, None]) * (tf(z_new) + beta)
        beta_new = sqo * torch.softmax(a, -1)
        if pinned is not None:
            beta_new = torch.where(pin[..., None] >= 0, pinned, beta_new)
        conv = (tau2 - tau2_prev).abs() < tol * tau2
        keep = active[:, None, None]
        beta = torch.where(keep, beta_new, beta)
        z = torch.where(keep, z_new, z)
        tau2_prev = torch.where(active, tau2, tau2_prev)
        iters += active.to(torch.int32)
        active = active & ~conv
    return dict(beta=beta, iters=iters, tau2=tau2_prev)
