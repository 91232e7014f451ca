"""Batched matrix-free measurement operators (port of
sparc_ldpc_tpu/ops/operators.py: `BatchedOperator`, `dense_operator`,
`hadamard_operator` with the "mxu" transform scheme, `dct_operator`).

    Ax: (B, ML) -> (B, n)       Ay: (B, n) -> (B, ML)

Operators are built from the host-side plans (design/codebook.py, the
port's copy of the reference's), so the reference and the port use
identical index sets.  The reference's "rev" transform scheme computes the
same transform in another TPU layout; here both schemes run `fwht_kron`.
With use_pallas (the reference's --pallas route) the Hadamard operator's
transforms are `fwht2` (ops/fwht_kernel.py, the counterpart of
`fwht_pallas`) in float32 whatever the config's transform precision, and,
as in the reference, the operator has no N-space members, so the AMP takes
the scan route with the encode and the noise outside the decoder.

With column signs (`col_signs=True`, and always for the DCT) every
direction multiplies by the plan's Rademacher diagonal: the input of a
forward transform, the output of an adjoint one.  Such an operator has no
`mask`, so a fused config takes the scan route, as in the reference.  The
DCT operator transforms with `dct2_ortho` / `dct3_ortho` (ops/dct.py,
torch.fft) and has no N-space members.

Under a section-sharded policy (parallel/mesh.py) the transforms are the
collective `dist_fwht` (parallel/dist_fwht.py) whatever the config's
`fwht_dist`: the reference's "gspmd" leaves the sharding of the same
transform to XLA's partitioner, which PyTorch does not have.  An
operator's constants follow the device of the data they are applied to
(copied once per device), so one operator serves every device of a mesh.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import SparcConfig
from ..design.codebook import DctPlan, HadamardPlan, dct_plan, hadamard_plan
from .dct import dct2_ortho, dct3_ortho
from .fwht import fwht_kron
from .fwht_kernel import fwht2
from .split_support import SplitSupport, split_support


def _follow(t: torch.Tensor) -> Callable[[torch.device], torch.Tensor]:
    """t on the device asked for, copied there once."""
    copies = {t.device: t}

    def on(device: torch.device) -> torch.Tensor:
        if device not in copies:
            copies[device] = t.to(device)
        return copies[device]

    return on


class BatchedOperator(NamedTuple):
    """Forward/adjoint pair plus static geometry.

    N-space members (Hadamard only) keep the AMP residual in the length-N
    transform domain:
      embed_y:  (B, n) -> (B, N)   scatter of y onto the row support
      resid_n:  (yN, beta, zN, coef) -> mask*(yN - A_full beta) + coef*zN
      adj_n:    (B, N) -> (B, ML)  adjoint straight from the N-space residual
    `mask` is the (N,) 0/1 row support, present when the operator can run
    the fused whole-trial AMP (ML == N, no column signs); `split_support`
    (L, M, device) gives the split AMP kernel's tables of that support for
    an (L, M) tile (ops/split_support.py), built from the plan's rows once
    per (L, M, device)."""
    Ax: Callable[[torch.Tensor], torch.Tensor]
    Ay: Callable[[torch.Tensor], torch.Tensor]
    n: int
    ML: int
    N: int
    embed_y: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    resid_n: Optional[Callable] = None
    adj_n: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    mask: Optional[torch.Tensor] = None
    split_support: Optional[Callable[[int, int, torch.device],
                                     SplitSupport]] = None


def dense_operator(cfg: SparcConfig, device="cpu") -> BatchedOperator:
    """Explicit iid N(0, 1/n) matrix with the reference's seed chain."""
    n, ML = cfg.n, cfg.ML
    rng = np.random.default_rng(np.random.SeedSequence([0xDE45E, cfg.op_seed]))
    A = _follow(torch.as_tensor(rng.standard_normal((n, ML)) / math.sqrt(n),
                                dtype=torch.float32, device=device))
    return BatchedOperator(Ax=lambda beta: beta @ A(beta.device).T,
                           Ay=lambda z: z @ A(z.device), n=n, ML=ML, N=ML)


def hadamard_operator(cfg: SparcConfig, device="cpu",
                      plan: Optional[HadamardPlan] = None,
                      use_pallas: bool = False,
                      policy=None) -> BatchedOperator:
    """Matrix-free partial-Hadamard operator A = H_N[rows, :ML] / sqrt(n).

    `plan` defaults to the config's own `hadamard_plan`; passing one lets a
    caller reuse constants taken from another implementation.  use_pallas
    gives the reference's `fwht_pallas` operator: Ax and Ay on `fwht2`,
    no N-space members.  policy (a ShardingPolicy) with more than one
    section shard makes the transforms `dist_fwht`.  With the plan's
    column signs, the operator is A diag(signs)."""
    if plan is None:
        plan = hadamard_plan(cfg.n, cfg.ML, cfg.op_seed, cfg.col_signs)
    N, n, ML = plan.N, plan.n, plan.ML
    rows_t = torch.as_tensor(plan.rows, dtype=torch.int64, device=device)
    mask = torch.zeros(N, dtype=torch.float32, device=device)
    mask[rows_t] = 1.0
    rows, mask_on = _follow(rows_t), _follow(mask)
    signed = _signed(plan.signs, ML, device)
    inv_sqrt_n = 1.0 / math.sqrt(n)
    prec = cfg.transform_precision

    def pad(beta):
        """signs o beta, zero-padded to N."""
        beta = signed(beta)
        return beta if ML == N else torch.nn.functional.pad(beta, (0, N - ML))

    if use_pallas:
        def Ax_k(beta):
            return (fwht2(pad(beta).contiguous())[..., rows(beta.device)]
                    * inv_sqrt_n)

        def Ay_k(z):
            u = torch.zeros(z.shape[:-1] + (N,), dtype=z.dtype,
                            device=z.device)
            u[..., rows(z.device)] = z
            return signed(fwht2(u)[..., :ML] * inv_sqrt_n)

        return BatchedOperator(Ax=Ax_k, Ay=Ay_k, n=n, ML=ML, N=N)

    if policy is not None and policy.section_shards > 1:
        from ..parallel.dist_fwht import dist_fwht

        def txf(u):
            return dist_fwht(u, policy, prec)
    else:
        def txf(u):
            return fwht_kron(u, prec)

    def embed_y(y):
        u = torch.zeros(y.shape[:-1] + (N,), dtype=y.dtype, device=y.device)
        u[..., rows(y.device)] = y
        return u

    def Ax(beta):
        return txf(pad(beta))[..., rows(beta.device)] * inv_sqrt_n

    def Ay(z):
        return signed(txf(embed_y(z))[..., :ML] * inv_sqrt_n)

    def resid_n(yN, beta, zN, coef):
        w = txf(pad(beta))
        return mask_on(yN.device) * (yN - w * inv_sqrt_n) + zN * coef

    def adj_n(zN):
        return signed(txf(zN)[..., :ML] * inv_sqrt_n)

    tables = {}

    def support(L, M, dev):
        key = (L, M, torch.device(dev))
        if key not in tables:
            host = tables.get((L, M, torch.device("cpu")))
            if host is None:
                host = split_support(plan.rows, L, M)
                tables[(L, M, torch.device("cpu"))] = host
            tables[key] = host.to(dev)
        return tables[key]

    fused = ML == N and plan.signs is None
    return BatchedOperator(Ax=Ax, Ay=Ay, n=n, ML=ML, N=N, embed_y=embed_y,
                           resid_n=resid_n, adj_n=adj_n,
                           mask=mask if fused else None,
                           split_support=support if fused else None)


def dct_operator(cfg: SparcConfig, device="cpu",
                 plan: Optional[DctPlan] = None) -> BatchedOperator:
    """Matrix-free subsampled orthonormal-DCT operator
    A = sqrt(N / n) DCT_N[rows, :ML] diag(signs): DCT-II forward, DCT-III
    adjoint, the column signs always on.  Scan route only: no N-space
    members, no mask.  `plan` defaults to the config's own `dct_plan`."""
    if plan is None:
        plan = dct_plan(cfg.n, cfg.ML, cfg.op_seed, col_signs=True)
    N, n, ML = plan.N, plan.n, plan.ML
    rows = _follow(torch.as_tensor(plan.rows, dtype=torch.int64,
                                   device=device))
    signed = _signed(plan.signs, ML, device)
    scale = math.sqrt(N / n)

    def Ax(beta):
        u = signed(beta)
        if ML != N:
            u = torch.nn.functional.pad(u, (0, N - ML))
        return dct2_ortho(u)[..., rows(beta.device)] * scale

    def Ay(z):
        u = torch.zeros(z.shape[:-1] + (N,), dtype=z.dtype, device=z.device)
        u[..., rows(z.device)] = z
        return signed(dct3_ortho(u)[..., :ML] * scale)

    return BatchedOperator(Ax=Ax, Ay=Ay, n=n, ML=ML, N=N)


def _signed(signs: Optional[np.ndarray], ML: int, device
            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (..., ML) times the column-sign diagonal (the identity without
    signs): the input of a forward transform, the output of an adjoint."""
    if signs is None:
        return lambda x: x
    if np.shape(signs) != (ML,):
        raise ValueError(f"signs must have shape ({ML},), got "
                         f"{np.shape(signs)}")
    on = _follow(torch.as_tensor(signs, dtype=torch.float32, device=device))
    return lambda x: x * on(x.device)


def make_operator(cfg: SparcConfig, device="cpu", plan=None,
                  use_pallas: bool = False,
                  policy=None) -> BatchedOperator:
    """The config's operator; `plan` (a HadamardPlan or a DctPlan, by
    op_kind) defaults to the config's own."""
    if cfg.op_kind == "dense":
        return dense_operator(cfg, device)
    if cfg.op_kind == "hadamard":
        return hadamard_operator(cfg, device, plan, use_pallas, policy)
    if cfg.op_kind == "dct":
        return dct_operator(cfg, device, plan)
    raise ValueError(f"unknown op_kind {cfg.op_kind!r}")
