"""Sectionwise posterior-mean softmax denoiser (port of
sparc_ldpc_tpu/ops/denoiser.py `denoise` and `denoise_pallas`).

    beta_{l,j} = sqrt(n P_l) * softmax_j( sqrt(n P_l) * s_{l,.} / tau2 )

The softmax argument grows like sqrt(n P_l) * s / tau2 as tau2 shrinks, so
each section is max-subtracted before the exponential.

`denoise` is the plain PyTorch version.  `denoise_kernel` is the
counterpart of `denoise_pallas` (TPU kernel `_denoise_kernel`): on a CUDA
tensor it launches the hand-written kernel csrc/denoise.cu (one warp per
section row) or raises; on a CPU tensor it runs `denoise`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def denoise(s: torch.Tensor, tau2: torch.Tensor, sq_npl: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """s (B, L, M), tau2 (B,), sq_npl (L,) -> (beta, posteriors), (B, L, M)."""
    a = sq_npl[None, :, None] * s / tau2[:, None, None]
    a = a - a.amax(-1, keepdim=True)
    e = torch.exp(a)
    post = e / e.sum(-1, keepdim=True)
    return sq_npl[None, :, None] * post, post


def denoise_kernel(s: torch.Tensor, tau2: torch.Tensor, sq_npl: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`denoise` through the CUDA kernel: float32 s (B, L, M) contiguous,
    tau2 (B,), sq_npl (L,), M a power of two in [32, 1024]."""
    if s.device.type == "cpu":
        return denoise(s, tau2, sq_npl)
    if s.device.type != "cuda":
        raise ValueError(f"denoise_kernel runs on cpu or cuda, not {s.device}")
    from ._build import run

    B, L, M = s.shape
    for name, t, shape in (("s", s, (B, L, M)), ("tau2", tau2, (B,)),
                           ("sq_npl", sq_npl, (L,))):
        if (t.device != s.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {s.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not (32 <= M <= 1024 and M & (M - 1) == 0):
        raise ValueError(f"the CUDA denoiser takes M a power of two in "
                         f"[32, 1024], got {M}")
    beta = torch.empty_like(s)
    post = torch.empty_like(s)
    run("denoise", "denoise_run", s.device, s.data_ptr(), tau2.data_ptr(),
        sq_npl.data_ptr(), beta.data_ptr(), post.data_ptr(), B, L, M)
    denoise_kernel.launches += 1
    return beta, post


# kernel runs (one per denoise_kernel call on a CUDA tensor); never counted
# on the CPU route
denoise_kernel.launches = 0
