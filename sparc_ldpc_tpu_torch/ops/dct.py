"""Orthonormal DCT-II and its inverse, DCT-III, along the last axis (the
transforms of the reference's `dct_operator`, which takes them from
`jax.scipy.fft.dct` / `idct` with norm="ortho").

torch.fft has no DCT, so both are built from one N-point complex FFT
(Makhoul's method).  With v the even-odd reordering of x,

    v[k] = x[2k],  v[N - 1 - k] = x[2k + 1]      (k < N/2),

the unnormalized DCT-II is Y[k] = 2 sum_j x[j] cos(pi k (2j + 1) / (2N))
= 2 Re(exp(-i pi k / (2N)) V[k]), V = FFT(v).  The ortho scale is
sqrt(1 / (4N)) at k = 0 and sqrt(1 / (2N)) above.  DCT-III inverts the
steps: V[k] = exp(i pi k / (2N)) (Y[k] - i Y[N - k]) / 2 (Y[N] = 0),
v = Re(IFFT(V)), then x from v.  Both compute in float32 (complex64) on
x's device; on the GPU torch.fft is cuFFT, as the reference's is XLA's
FFT, outside any kernel of its own.
"""

from __future__ import annotations

import math

import torch


def _twiddle(N: int, sign: float, device) -> torch.Tensor:
    """exp(sign * i pi k / (2N)), k < N, complex64."""
    k = torch.arange(N, dtype=torch.float64, device=device)
    return torch.polar(torch.ones_like(k), sign * math.pi * k / (2 * N)
                       ).to(torch.complex64)


def dct2_ortho(x: torch.Tensor) -> torch.Tensor:
    """DCT-II (norm="ortho") of float32 x along its last axis."""
    N = x.shape[-1]
    v = torch.cat((x[..., 0::2], x[..., 1::2].flip(-1)), -1)
    Y = (torch.fft.fft(v.to(torch.float32), dim=-1)
         * _twiddle(N, -1.0, x.device)).real
    scale = torch.full((N,), math.sqrt(2.0 / N), dtype=torch.float32,
                       device=x.device)
    scale[0] = math.sqrt(1.0 / N)
    return Y * scale


def dct3_ortho(X: torch.Tensor) -> torch.Tensor:
    """DCT-III (norm="ortho") of float32 X along its last axis: the
    inverse, and so the transpose, of `dct2_ortho`."""
    N = X.shape[-1]
    # Y / 2 of the unnormalized DCT-II from the ortho coefficients
    half = torch.full((N,), math.sqrt(N / 2.0), dtype=torch.float32,
                      device=X.device)
    half[0] = math.sqrt(float(N))
    Yh = X.to(torch.float32) * half
    Yr = torch.cat((torch.zeros_like(Yh[..., :1]), Yh[..., 1:].flip(-1)), -1)
    V = torch.complex(Yh, -Yr) * _twiddle(N, 1.0, X.device)
    v = torch.fft.ifft(V, dim=-1).real
    x = torch.empty_like(v)
    x[..., 0::2] = v[..., : (N + 1) // 2]
    x[..., 1::2] = v[..., (N + 1) // 2:].flip(-1)
    return x
