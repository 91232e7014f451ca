"""The block draws, worked out again from the seed.

A frozen copy of the port's block-seed derivation and of the draw order of
its trial blocks, in plain PyTorch and NumPy (this package imports nothing
of the port):

- block (base, point, block) draws from a torch.Generator on the home
  device seeded with the first 64-bit word of
  SeedSequence([base, point, block]);
- a block of B codewords first draws its message bits, torch.randint(0, 2,
  (B, bits)) as int32, then, with the noise drawn in the decode kernel, one
  Philox key per codeword, torch.randint(-2**31, 2**31, (B, 2)) as int32.

A CUDA and a CPU generator seeded alike draw different numbers, so the
reference draws on the device type the program drew on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def block_seed(base: int, point: int, block: int) -> int:
    """64-bit seed of block (base, point, block)."""
    ss = np.random.SeedSequence([base, point, block])
    return int(ss.generate_state(1, np.uint64)[0])


def block_generator(base: int, point: int, block: int,
                    device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(base, point, block))
    return gen


def block_draws(base: int, point: int, block: int, batch: int, bits: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bits (B, bits) int32 in {0, 1}, noise keys (B, 2) int32) of one
    block, in the order the trial block draws them."""
    gen = block_generator(base, point, block, device)
    msg = torch.randint(0, 2, (batch, bits), generator=gen,
                        dtype=torch.int32, device=device)
    keys = torch.randint(-2 ** 31, 2 ** 31, (batch, 2), generator=gen,
                         dtype=torch.int32, device=device)
    return msg, keys
