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
exchanges blocks with `ppermute` between devices; here a block reaches
its partner's device with `Tensor.to`.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.fwht import fwht_kron
from .mesh import ShardingPolicy


def hypercube(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """H_S across S same-shaped blocks (S a power of two), block s on its
    own device: the log2(S) butterfly stages, each new block on the device
    of the block it replaces."""
    S = len(parts)
    if S & (S - 1):
        raise ValueError(f"the shard count must be a power of two, got {S}")
    bit = 1
    while bit < S:
        parts = [parts[s ^ bit].to(p.device) - p if s & bit
                 else p + parts[s ^ bit].to(p.device)
                 for s, p in enumerate(parts)]
        bit <<= 1
    return parts


def dist_fwht(x: torch.Tensor, policy: ShardingPolicy,
              precision: str = "high") -> torch.Tensor:
    """Unnormalized FWHT over the last axis of x (B, N), N cut over the
    policy's section axis and B over its data axis: a local `fwht_kron`
    of each (B / D, N / S) piece on its device, then `hypercube` across
    the S pieces of each data shard; the result gathered on x's device.
    With one section shard, the plain local transform."""
    S = policy.section_shards
    if S == 1:
        return fwht_kron(x, precision)
    if x.shape[-1] % S:
        raise ValueError(f"N = {x.shape[-1]} is not divisible by {S} section "
                         f"shards")
    rows = []
    for d, xd in enumerate(policy.split_data(x)):
        parts = hypercube([fwht_kron(p, precision)
                           for p in policy.split_sections(xd, d, -1)])
        rows.append(torch.cat([p.to(x.device) for p in parts], -1))
    return rows[0] if len(rows) == 1 else torch.cat(rows, 0)
