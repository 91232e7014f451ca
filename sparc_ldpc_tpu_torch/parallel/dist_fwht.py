"""Collective FWHT for section-sharded transforms (port of
sparc_ldpc_tpu/parallel/dist_fwht.py).

With a length-N vector split into S contiguous shards (shard s holds
entries [s N/S, (s + 1) N/S)), Sylvester ordering gives
H_N = H_S (x) H_{N/S}, so

    FWHT_N(x) = (H_S across the shards) o (a local FWHT_{N/S} in each).

The H_S factor is log2(S) hypercube stages: at stage `bit`, shard i
combines its block with that of shard i ^ bit,

    y_i <- y_i + y_{i^bit}        (i & bit == 0)
    y_i <- y_{i^bit} - y_i        (i & bit != 0)

`hypercube` computes every new block from the old ones before it replaces
any (on a virtual mesh the shards share a device, and an update in place
would feed the second of a pair its partner's new value).  The reference
exchanges blocks with `ppermute` between devices, wherever the section
axis's devices live; here a block reaches its partner's device with
`Tensor.to` inside a process, and, where the section axis spans the
processes of a section group (parallel/mesh.py), a stage whose partner
lives in another process exchanges this rank's blocks with that rank's
by torch.distributed point to point (`ShardingPolicy.exchange`).  The
arithmetic is the same expression in the same order either way, so the
stages give one process's bits.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.fwht import fwht_kron
from .mesh import ShardingPolicy


def hypercube(parts: List[torch.Tensor],
              policy: Optional[ShardingPolicy] = None) -> List[torch.Tensor]:
    """H_S across S same-shaped blocks (S a power of two), block s on its
    own device: the log2(S) butterfly stages, each new block on the device
    of the block it replaces.  Under a policy whose section axis spans
    processes, parts are this rank's k blocks (global blocks q k + s, q
    its section rank) and a stage bit >= k exchanges them with rank
    q ^ (bit / k) of the section group."""
    k = len(parts)
    G = 1 if policy is None else policy.section_procs
    q = 0 if policy is None else policy.section_rank
    S = k * G
    if S & (S - 1):
        raise ValueError(f"the shard count must be a power of two, got {S}")
    bit = 1
    while bit < S:
        if bit < k:
            partners = [parts[s ^ bit].to(p.device)
                        for s, p in enumerate(parts)]
        else:
            partners = policy.exchange(parts, q ^ (bit // k))
        parts = [o - p if (q * k + s) & bit else p + o
                 for s, (p, o) in enumerate(zip(parts, partners))]
        bit <<= 1
    return parts


def dist_fwht(x: torch.Tensor, policy: ShardingPolicy,
              precision: str = "high") -> torch.Tensor:
    """Unnormalized FWHT over the last axis of x (B, N), N cut over the
    policy's section axis and B over its data axis: a local `fwht_kron`
    of each (B / D, N / S) piece on its device, then `hypercube` across
    the S pieces of each data shard; the result gathered on x's device
    (across a section group's processes too, so that every rank of the
    group returns the whole transform).  With one section shard, the
    plain local transform."""
    S = policy.section_shards
    if S == 1:
        return fwht_kron(x, precision)
    if x.shape[-1] % S:
        raise ValueError(f"N = {x.shape[-1]} is not divisible by {S} section "
                         f"shards")
    rows = []
    for d, xd in enumerate(policy.split_data(x)):
        parts = hypercube([fwht_kron(p, precision)
                           for p in policy.split_sections(xd, d, -1)],
                          policy)
        rows.append(policy.gather_sections(
            torch.cat([p.to(x.device) for p in parts], -1), -1))
    return rows[0] if len(rows) == 1 else torch.cat(rows, 0)
