"""The split AMP kernel's (K1's) layout of the row support.

K1 keeps the residual z and the observation y only where the row support
(`mask`, the n rows of H_N that the partial-Hadamard operator keeps) is
one: as (B, ns) float32 in the kernel's own order of the ns support
entries.  Off the support z is 0 at every iteration, so the dense (B, L, M)
tiles of the earlier design moved zeros for all but n of the N = L M
positions (1.8 % at the headline configuration).

The column stage's block owns a strip of 32 columns (and, above L = 1024,
the rows of one block of a cluster of L / 1024 blocks); its thread (w, c)
holds R consecutive rows R w .. R w + R - 1 of column c (`split_geometry`).
The kernel's order of the entries is by block (strip, then cluster rank),
then column, then thread row-range, then row, so each thread's entries are
consecutive and each block's too.  The tables (`SplitSupport`) give, for
each (row-range g = L-row // R, column m): the offset of its first entry in
that order and a 32-bit word whose bit k says that row R g + k is on the
support; and for each block its first entry.  The mono form (K6) also reads
z by rows: `perm` gives each entry's place in row-major order (the sorted
support) and `row_offset` each row's first place there.

`split_support(rows, L, M)` builds them from the sorted support (the
operator's plan rows, positions l M + m of the (L, M) tile) with plain
index work, on the device of `rows`; `split_support_from_mask` from a 0/1
mask.  They are built once per operator and device, never on the kernel's
critical path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

STRIP = 32         # columns of one column-stage block
BLOCK_ROWS = 1024  # rows of one column-stage block (a cluster above)


def split_geometry(L: int) -> Tuple[int, int, int]:
    """(W, R, FA) of the column stage for L rows: W warps of 32 threads a
    block, R consecutive rows a thread, FA blocks a cluster; W R FA = L
    (csrc/amp_common.cuh, DISPATCH_L)."""
    if L > BLOCK_ROWS:
        return 32, 32, L // BLOCK_ROWS
    R = 8 if L <= 64 else 16 if L <= 256 else 32
    return L // R, R, 1


class SplitSupport(NamedTuple):
    """K1's tables for a support of ns entries of an (L, M) tile."""
    L: int
    M: int
    flat: torch.Tensor          # (ns,) int64: tile position l M + m of
                                # each entry, in the kernel's order
    perm: torch.Tensor          # (ns,) int32: each entry's index in the
                                # sorted support (the plan's order, the
                                # row-major order of the entries)
    offset: torch.Tensor        # (L / R, M) int32: first entry of each
                                # (row-range, column)
    word: torch.Tensor          # (L / R, M) int32: the uint32 bit pattern
                                # of the range's support rows
    block_offset: torch.Tensor  # (FA M / 32 + 1,) int32: first entry of
                                # each column-stage block, then ns
    row_offset: torch.Tensor    # (L + 1,) int32: first row-major place of
                                # each row, then ns

    @property
    def ns(self) -> int:
        return int(self.flat.shape[0])

    def to(self, device) -> "SplitSupport":
        return SplitSupport(self.L, self.M, *(t.to(device) for t in self[2:]))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., L, M) on the support, (..., ns) in the kernel's order."""
        return x.reshape(*x.shape[:-2], -1)[..., self.flat]


def split_support(rows, L: int, M: int) -> SplitSupport:
    """K1's tables for the support `rows` (positions l M + m of the (L, M)
    tile, sorted ascending, distinct; a tensor or an array), built on the
    device of rows (the CPU for an array)."""
    pos = torch.as_tensor(np.asarray(rows) if not torch.is_tensor(rows)
                          else rows).to(torch.int64)
    dev = pos.device
    W, R, FA = split_geometry(L)
    LB, S = W * R, M // STRIP
    if pos.numel() and (bool((pos[1:] <= pos[:-1]).any())
                        or int(pos[0]) < 0 or int(pos[-1]) >= L * M):
        raise ValueError("the support must be sorted, distinct positions "
                         f"of the ({L}, {M}) tile")
    l, m = pos // M, pos % M
    a, s, c = l // LB, m // STRIP, m % STRIP
    w, k = (l % LB) // R, l % R
    # (block = strip, cluster rank; column; row-range), then the row
    rng = ((s * FA + a) * STRIP + c) * W + w
    key = rng * R + k
    perm = torch.argsort(key)
    flat = pos[perm]
    counts = torch.bincount(rng, minlength=S * FA * STRIP * W)
    first = torch.cumsum(counts, 0) - counts
    # kernel order (s, a, c, w) -> table layout (g = a W + w, m = 32 s + c)
    def table(x):
        x = x.reshape(S, FA, STRIP, W).permute(1, 3, 0, 2)
        return x.reshape(FA * W, M).to(torch.int32).contiguous()

    bits = torch.zeros(S * FA * STRIP * W, dtype=torch.int64, device=dev)
    bits.index_add_(0, rng, torch.ones_like(k) << k)
    word = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    block = first.reshape(S * FA, STRIP * W)[:, 0]
    block_offset = torch.cat([block, torch.tensor([pos.numel()],
                                                  device=dev)])
    row_counts = torch.bincount(l, minlength=L)
    row_offset = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(row_counts, 0)])
    return SplitSupport(L, M, flat, perm.to(torch.int32), table(first),
                        table(word), block_offset.to(torch.int32),
                        row_offset.to(torch.int32))


def split_support_from_mask(mask: torch.Tensor) -> SplitSupport:
    """K1's tables for the support mask > 0 of an (L, M) mask, built on the
    mask's device.  On a CUDA mask this waits for the device (the count of
    the support is read back)."""
    L, M = mask.shape
    return split_support(torch.nonzero(mask.reshape(-1) > 0).reshape(-1),
                         L, M)
