"""Sectionwise posterior-mean softmax denoiser (port of
sparc_ldpc_tpu/ops/denoiser.py `denoise`).

    beta_{l,j} = sqrt(n P_l) * softmax_j( sqrt(n P_l) * s_{l,.} / tau2 )

The softmax argument grows like sqrt(n P_l) * s / tau2 as tau2 shrinks, so
each section is max-subtracted before the exponential.
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
