"""The channel noise that the decode kernel draws, worked out again.

A frozen copy of the generator's arithmetic (Philox4x32-10, Salmon et al.,
SC'11, with both outputs of Box-Muller on 24-bit uniforms):

- codeword b's key is its two 32-bit noise words;
- element (l, m) of its (L, M) tile takes the Philox block of counter
  (m, l // 4, 0, 0); the four output words (x0, x1, x2, x3) give rows
  4q + 0 and 4q + 1 from Box-Muller on (x0, x1), rows 4q + 2 and 4q + 3
  from (x2, x3);
- Box-Muller: u1 = (w1 >> 8) 2^-24 + 2^-25, theta = 2 pi (w2 >> 8) 2^-24
  in float32, r = sqrt(-2 ln u1), outputs (r cos theta, r sin theta);
- the noise is sigma times the normal where the row support is set, else 0.

Integer words are held in int64 in [0, 2^32); the 32 x 32-bit products are
split into 16-bit halves so that every partial product stays below 2^49.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product m * a."""
    lo16 = (a & 0xFFFF) * m
    hi16 = (a >> 16) * m
    t = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (t >> 32), t & MASK32


def philox(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 on int64 words in [0, 2^32), broadcastable tensors."""
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        h0, l0 = mulhilo(c0, PHILOX_M0)
        h1, l1 = mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def box_muller(w1: torch.Tensor, w2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    u1 = (w1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    theta = (2.0 * math.pi) * (w2 >> 8).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(theta), r * torch.sin(theta)


def standard_normals(keys: torch.Tensor, L: int, M: int) -> torch.Tensor:
    """(B, L, M) float32 standard normals of codewords with Philox keys
    `keys` (B, 2) int32 (uint32 bit patterns)."""
    if L % 4:
        raise ValueError(f"L must be a multiple of 4, got {L}")
    dev = keys.device
    k = keys.to(torch.int64) & MASK32
    k0, k1 = k[:, 0, None, None], k[:, 1, None, None]
    q = torch.arange(L // 4, dtype=torch.int64, device=dev)[:, None]
    m = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    x0, x1, x2, x3 = philox(m, q, zero, zero, k0, k1)
    a, b = box_muller(x0, x1)
    c, d = box_muller(x2, x3)
    # (B, L/4, 4, M): rows 4q + 0, 1, 2, 3
    return torch.stack([a, b, c, d], 2).reshape(keys.shape[0], L, M)


def channel_noise(keys: torch.Tensor, mask: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """sigma * normal on the row support mask (L, M), 0 elsewhere."""
    L, M = mask.shape
    z = standard_normals(keys, L, M)
    return torch.where(mask > 0, sigma * z, torch.zeros((), device=z.device))
