"""Seeded random streams for Monte-Carlo blocks (port of
sparc_ldpc_tpu/utils/rng.py).

One explicit torch.Generator per (base, point, block): its seed is drawn
from a NumPy SeedSequence of those three integers, so a block's draws
depend on its coordinates and on the generator's device type, since a
CUDA and a CPU torch.Generator seeded alike draw different numbers.  That
is what the campaign's journal resume needs: a block executed again after
a restart on the same device type draws exactly what it drew the first
time (the journal records the device type, utils/io.py, and refuses a
resume on another).  They do not depend on the mesh or on the number of
processes either: every process draws the whole block from its generator
and decodes its own rows of it (models/sparc.py, parallel/mesh.py
`process_rows`), at the price of each process making every row's draws.
They do depend on the block's batch size, which the reference's per-trial
key fold avoids.  Torch and JAX streams differ: same-input tests make
their draws with NumPy and hand them to both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def block_seed(base: int, point: int, block: int) -> int:
    """64-bit seed of block (base, point, block)."""
    ss = np.random.SeedSequence([base, point, block])
    return int(ss.generate_state(1, np.uint64)[0])


def block_generator(base: int, point: int, block: int,
                    device="cpu") -> torch.Generator:
    """A torch.Generator on `device`, seeded for (base, point, block)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(base, point, block))
    return gen
